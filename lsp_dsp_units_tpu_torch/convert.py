"""Carry the JAX package's parameters and states into the port, so both
packages can run the same path from the same point.

Inputs are the JAX package's ``ChainParams``, chain states
(``ChainState``, ``ChainBulkState``, ``ChainRingState``), ring convolver
states (``RingFDLState``) and sampler tables (``DeviceVoices``,
``DeviceMixState``) with every array leaf converted to numpy
(``jax.tree_util.tree_map(np.asarray, ...)``); this module imports no
JAX.  ``ChainState`` and ``ChainBulkState`` keep the JAX layouts as they
are.  A JAX ring comes in natural order [P, ..., B + 1] (its CPU layout;
a scrambled-packed JAX ring is unpacked first with the JAX package's
``pallas_fft.unpack_spectra``); the port's ring is natural or packed
[P, C, B] (ops/fft_packed.py).
"""

from __future__ import annotations

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.models.dynamics.compressor import (
    CompressorParams)
from lsp_dsp_units_tpu_torch.models.sampling import device_mix
from lsp_dsp_units_tpu_torch.models.util.sidechain import SidechainState
from lsp_dsp_units_tpu_torch.ops import biquad_block, fftconv
from lsp_dsp_units_tpu_torch.ops import dynamics as dyn
from lsp_dsp_units_tpu_torch.ops import fft_packed as fp
from lsp_dsp_units_tpu_torch.pipeline import (
    ChainBulkState, ChainParams, ChainRingState, ChainState, chain_params)


def _t(v, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(v), dtype=dtype, device=device)


def _f32(v) -> float:
    return float(np.float32(v))


def params_from_jax(p, device="cuda") -> ChainParams:
    """JAX ``ChainParams`` (numpy leaves) -> port ``ChainParams``."""
    eqb = p.eq_block
    g = np.asarray(eqb.g_mat, np.float32)
    eq_block = biquad_block.FusedCascadeParams(
        *(_t(v, device) for v in eqb),
        g_t=_t(np.ascontiguousarray(g.T), device))
    comp = CompressorParams(
        knees=tuple(dyn.CompKnee(*(_f32(v) for v in k))
                    for k in p.comp.knees),
        tau_attack=_f32(p.comp.tau_attack),
        tau_release=_f32(p.comp.tau_release),
        release_thresh=_f32(p.comp.release_thresh),
        hold=int(np.asarray(p.comp.hold)))
    return chain_params(
        eq_coeffs=np.asarray(p.eq_coeffs, np.float32), eq_block=eq_block,
        h_spectra=fftconv.Spectra(_t(p.h_spectra.re, device),
                                  _t(p.h_spectra.im, device)),
        comp=comp)


def _sc_env(s, device):
    return (SidechainState(window=_t(s.sc.window, device),
                           rms=_t(s.sc.rms, device)),
            dyn.EnvState(envelope=_t(s.env.envelope, device),
                         peak=_t(s.env.peak, device),
                         hold=_t(s.env.hold, device, torch.int32)))


def state_from_jax(s, device="cuda") -> ChainState:
    """JAX ``ChainState`` (numpy leaves) -> port ``ChainState``."""
    sc, env = _sc_env(s, device)
    return ChainState(
        eq=_t(s.eq, device),
        fdl=fftconv.FDLState(spec_re=_t(s.fdl.spec_re, device),
                             spec_im=_t(s.fdl.spec_im, device),
                             history=_t(s.fdl.history, device)),
        sc=sc, env=env)


def bulk_state_from_jax(s, device="cuda") -> ChainBulkState:
    """JAX ``ChainBulkState`` (numpy leaves) -> port ``ChainBulkState``."""
    sc, env = _sc_env(s, device)
    return ChainBulkState(
        eq=_t(s.eq, device),
        conv=fftconv.OLSBulkState(history=_t(s.conv.history, device)),
        sc=sc, env=env)


def ring_from_natural(re, im, device="cuda"):
    """Natural-order ring [P, C, B + 1] -> packed [P, C, B] tensors."""
    re = _t(re, device)
    n = 2 * (re.shape[-1] - 1)
    return fp.pack_spectra(re, _t(im, device), n)


def ring_fdl_from_jax(s, packed: bool = False,
                      device="cuda") -> fftconv.RingFDLState:
    """JAX ``RingFDLState`` (numpy leaves, natural-order ring [P, ...,
    B + 1]) -> port ``RingFDLState``, natural or (``packed``) packed."""
    b = np.asarray(s.history).shape[-1]
    if np.asarray(s.spec_re).shape[-1] != b + 1:
        raise ValueError("expected the JAX natural-order ring [P, ..., B+1]; "
                         "unpack a scrambled-packed one with the JAX "
                         "package's pallas_fft.unpack_spectra first")
    if packed:
        spec_re, spec_im = ring_from_natural(s.spec_re, s.spec_im, device)
    else:
        spec_re, spec_im = _t(s.spec_re, device), _t(s.spec_im, device)
    return fftconv.RingFDLState(spec_re=spec_re, spec_im=spec_im,
                                history=_t(s.history, device),
                                pos=int(np.asarray(s.pos)))


def ring_state_from_jax(s, device="cuda") -> ChainRingState:
    """JAX ``ChainRingState`` (numpy leaves, natural-order ring) -> port
    ``ChainRingState``."""
    sc, env = _sc_env(s, device)
    return ChainRingState(eq=_t(s.eq, device),
                          fdl=ring_fdl_from_jax(s.fdl, True, device),
                          sc=sc, env=env)


def voices_from_jax(voices, state, device="cuda"):
    """JAX ``DeviceVoices`` and ``DeviceMixState`` (numpy leaves) -> the
    port's (device_mix.DeviceVoices, device_mix.DeviceMixState)."""
    return device_mix.voices_from_host(
        voices.sample_id, voices.length, voices.gain, voices.loop_on,
        voices.loop_start, voices.loop_end, voices.route, state.pos, device)
