"""Carry the JAX package's parameters and states into the port, so both
packages can run the same path from the same point.

Inputs are the JAX package's ``ChainParams``, chain states
(``ChainState``, ``ChainBulkState``, ``ChainRingState``), ring convolver
states (``RingFDLState``), sampler tables (``DeviceVoices``,
``DeviceMixState``), the Compressor's parameters (as tensors, for
gradients), biquad cascade states, the Equalizer's
``EqParams`` and ``EqState``, the parameters and states of the
Limiter, DynamicProcessor, AutoGain, SimpleAutoGain, SurgeProtector and
the meters, the states of the spectral units, the Analyzer and the
Oversampler, those of the delay lines, the Trigger, the Depopper and
the Oscillator (a NoiseGenerator's state is its SpectralTilt's biquad
state), and those of Bypass, Crossfade and QuantizedCounter, with every
array leaf converted to numpy
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

from lsp_dsp_units_tpu_torch.models.ctl import BypassState, CrossfadeState
from lsp_dsp_units_tpu_torch.models.dynamics.autogain import (
    AutoGainState, SimpleAutoGainState)
from lsp_dsp_units_tpu_torch.models.dynamics.compressor import (
    CompressorParams)
from lsp_dsp_units_tpu_torch.models.dynamics.dynamic_processor import (
    DynProcParams)
from lsp_dsp_units_tpu_torch.models.dynamics.gate import GateParams
from lsp_dsp_units_tpu_torch.models.dynamics.limiter import (
    LimiterParams, LimiterState)
from lsp_dsp_units_tpu_torch.models.dynamics.surge_protector import (
    SurgeProtectorState)
from lsp_dsp_units_tpu_torch.models.filters.equalizer import (
    EqParams, EqState)
from lsp_dsp_units_tpu_torch.models.meters.correlometer import (
    CorrelometerState)
from lsp_dsp_units_tpu_torch.models.meters.loudness import (
    ILUFSState, LoudnessMeterState)
from lsp_dsp_units_tpu_torch.models.meters.peak import (
    PanometerState, PeakMeterState)
from lsp_dsp_units_tpu_torch.models.meters.true_peak import TruePeakState
from lsp_dsp_units_tpu_torch.models.sampling import device_mix
from lsp_dsp_units_tpu_torch.models.stat import QuantizedCounterState
from lsp_dsp_units_tpu_torch.models.util.analyzer import AnalyzerState
from lsp_dsp_units_tpu_torch.models.util.delay import (DelayState,
                                                       DynamicDelayState)
from lsp_dsp_units_tpu_torch.models.util.depopper import DepopperState
from lsp_dsp_units_tpu_torch.models.util.oscillator import OscillatorState
from lsp_dsp_units_tpu_torch.models.util.oversampler import OversamplerState
from lsp_dsp_units_tpu_torch.models.util.sidechain import SidechainState
from lsp_dsp_units_tpu_torch.models.util.spectral import (SpectralState,
                                                          SplitterState)
from lsp_dsp_units_tpu_torch.models.util.trigger import TriggerState
from lsp_dsp_units_tpu_torch.ops import biquad_block, fftconv
from lsp_dsp_units_tpu_torch.ops import dynamics as dyn
from lsp_dsp_units_tpu_torch.ops import fft_packed as fp
from lsp_dsp_units_tpu_torch.pipeline import (
    ChainBulkState, ChainParams, ChainRingState, ChainState, chain_params)
from lsp_dsp_units_tpu_torch.utils import tree


def _t(v, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(v), dtype=dtype, device=device)


def _f32(v) -> float:
    return float(np.float32(v))


def _fused_from_jax(f, device) -> biquad_block.FusedCascadeParams:
    g = np.asarray(f.g_mat, np.float32)
    return biquad_block.FusedCascadeParams(
        *(_t(v, device) for v in f),
        g_t=_t(np.ascontiguousarray(g.T), device))


def params_from_jax(p, device="cuda", requires_grad=False) -> ChainParams:
    """JAX ``ChainParams`` (numpy leaves) -> port ``ChainParams``.  With
    ``requires_grad`` the IR spectra, every tensor of the EQ block but
    ``g_t`` (``step_ring`` forms it from ``g_mat`` in the graph) and the
    Compressor's 20 leaves (:func:`compressor_params_from_jax`) require
    grad, in the JAX package's natural order: ``step_ring`` packs them in
    its graph, so their gradients are those of the JAX leaves."""
    eq_block = _fused_from_jax(p.eq_block, device)
    if requires_grad:
        eq_block = eq_block._replace(**{
            f: getattr(eq_block, f).requires_grad_(True)
            for f in eq_block._fields if f != "g_t"})
        comp = compressor_params_from_jax(p.comp, device, True)
    else:
        comp = CompressorParams(
            knees=tuple(dyn.CompKnee(*(_f32(v) for v in k))
                        for k in p.comp.knees),
            tau_attack=_f32(p.comp.tau_attack),
            tau_release=_f32(p.comp.tau_release),
            release_thresh=_f32(p.comp.release_thresh),
            hold=int(np.asarray(p.comp.hold)))
    return chain_params(
        eq_coeffs=np.asarray(p.eq_coeffs, np.float32), eq_block=eq_block,
        h_spectra=fftconv.Spectra(
            _t(p.h_spectra.re, device).requires_grad_(requires_grad),
            _t(p.h_spectra.im, device).requires_grad_(requires_grad)),
        comp=comp)


_COMP_SKELETON = tree.tree_flatten(CompressorParams(
    knees=(dyn.CompKnee(*[0.0] * 8), dyn.CompKnee(*[0.0] * 8)),
    tau_attack=0.0, tau_release=0.0, release_thresh=0.0, hold=0))[1]


def compressor_params_from_jax(p, device="cuda", requires_grad=False
                               ) -> CompressorParams:
    """JAX ``CompressorParams`` (numpy leaves), or its 20 leaves in
    ``jax.tree_util.tree_flatten`` order, -> port ``CompressorParams`` of
    0-d float32 tensors on ``device``: the 16 knee fields, the taus and
    the release threshold.  The hold is an int; with ``requires_grad``
    it is a float32 leaf like the others (the JAX test casts every leaf
    to float32), which the envelope casts to int, so its gradient is
    zero, as JAX's."""
    leaves = tree.tree_flatten(p)[0]
    if len(leaves) != 20:
        raise ValueError(f"CompressorParams has 20 leaves, got "
                         f"{len(leaves)}")

    def leaf(v):
        return _t(np.float32(v), device).requires_grad_(requires_grad)
    hold = leaf(leaves[19]) if requires_grad \
        else int(np.asarray(leaves[19]))
    return tree.tree_unflatten(_COMP_SKELETON,
                               [leaf(v) for v in leaves[:19]] + [hold])


def gate_params_from_jax(p, device="cuda", requires_grad=False
                         ) -> GateParams:
    """JAX ``GateParams`` (numpy leaves) -> port ``GateParams``: the 16
    knee fields and the two taus as 0-d float32 tensors on ``device``
    (requiring grad with ``requires_grad``), the hold as an int."""
    def leaf(v):
        return _t(np.float32(v), device).requires_grad_(requires_grad)
    return GateParams(
        knees=tuple(dyn.GateKnee(*(leaf(v) for v in k)) for k in p.knees),
        tau_attack=leaf(p.tau_attack), tau_release=leaf(p.tau_release),
        hold=int(np.asarray(p.hold)))


def env_state_from_jax(s, device="cuda") -> dyn.EnvState:
    """A JAX ``EnvState`` (numpy leaves) -> port ``EnvState``."""
    return dyn.EnvState(envelope=_t(s.envelope, device),
                        peak=_t(s.peak, device),
                        hold=_t(s.hold, device, torch.int32))


def _sc_env(s, device):
    return (SidechainState(window=_t(s.sc.window, device),
                           rms=_t(s.sc.rms, device)),
            env_state_from_jax(s.env, device))


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


def ring_state_leaves_from_jax(s, device="cuda"):
    """A JAX ``ChainRingState`` (numpy leaves, natural-order ring) ->
    (port ``ChainRingState``, its float leaves).  The leaves are new
    tensors that require grad, in the order of the JAX state's float
    leaves (``jax.tree_util.tree_flatten``: eq, the natural ring's re and
    im [P, C, B + 1], history, the sidechain's window and rms, envelope,
    peak); the state's packed ring is formed from the natural one in the
    graph (fft_packed.pack_spectra), so after a backward each leaf's
    ``grad`` is the gradient of the JAX leaf beside it."""
    leaves = [_t(v, device).requires_grad_(True) for v in (
        s.eq, s.fdl.spec_re, s.fdl.spec_im, s.fdl.history, s.sc.window,
        s.sc.rms, s.env.envelope, s.env.peak)]
    eq, nat_re, nat_im, hist, win, rms, env, peak = leaves
    spec_re, spec_im = fp.pack_spectra(nat_re, nat_im,
                                       2 * (nat_re.shape[-1] - 1))
    state = ChainRingState(
        eq=eq, fdl=fftconv.RingFDLState(spec_re=spec_re, spec_im=spec_im,
                                        history=hist,
                                        pos=int(np.asarray(s.fdl.pos))),
        sc=SidechainState(window=win, rms=rms),
        env=dyn.EnvState(envelope=env, peak=peak,
                         hold=_t(s.env.hold, device, torch.int32)))
    return state, leaves


def voices_from_jax(voices, state, device="cuda"):
    """JAX ``DeviceVoices`` and ``DeviceMixState`` (numpy leaves) -> the
    port's (device_mix.DeviceVoices, device_mix.DeviceMixState)."""
    return device_mix.voices_from_host(
        voices.sample_id, voices.length, voices.gain, voices.loop_on,
        voices.loop_start, voices.loop_end, voices.route, state.pos, device)


def biquad_state_from_jax(s, device="cuda") -> torch.Tensor:
    """A JAX biquad cascade state [..., K, 2] (numpy) -> float32 tensor."""
    return _t(s, device)


def eq_params_from_jax(p, device="cuda") -> EqParams:
    """JAX ``EqParams`` (numpy leaves; ``fused`` None or a
    ``FusedCascadeParams``) -> port ``EqParams``."""
    return EqParams(
        coeffs=_t(p.coeffs, device), conv_re=_t(p.conv_re, device),
        conv_im=_t(p.conv_im, device), spm_gain=_t(p.spm_gain, device),
        fused=None if p.fused is None else _fused_from_jax(p.fused, device))


def eq_state_from_jax(s, device="cuda") -> EqState:
    """JAX ``EqState`` (numpy leaves) -> port ``EqState``."""
    return EqState(*(_t(v, device) for v in s))


def limiter_params_from_jax(p, device="cuda") -> LimiterParams:
    """JAX ``LimiterParams`` (numpy leaves) -> port ``LimiterParams``."""
    return LimiterParams(
        patch=_t(p.patch, device), middle=int(np.asarray(p.middle)),
        threshold=_f32(p.threshold), alr_ks=_f32(p.alr_ks),
        alr_ke=_f32(p.alr_ke), alr_gain=_f32(p.alr_gain),
        alr_herm=tuple(_f32(v) for v in np.asarray(p.alr_herm)),
        alr_tau_att=_f32(p.alr_tau_att), alr_tau_rel=_f32(p.alr_tau_rel))


def limiter_state_from_jax(s, device="cuda") -> LimiterState:
    """JAX ``LimiterState`` (numpy leaves) -> port ``LimiterState``."""
    return LimiterState(gcarry=_t(s.gcarry, device),
                        alr_env=_t(s.alr_env, device))


def dynproc_params_from_jax(p, device="cuda") -> DynProcParams:
    """JAX ``DynProcParams`` (numpy leaves) -> port ``DynProcParams``
    (its envelope state comes through :func:`env_state_from_jax`)."""
    def floats(v):
        return tuple(_f32(f) for f in np.asarray(v).reshape(-1))

    return DynProcParams(
        **{k: _t(getattr(p, k), device) for k in (
            "sp_thresh", "sp_makeup", "sp_kstart", "sp_kstop", "sp_pre",
            "sp_post", "sp_herm")},
        **{k: floats(getattr(p, k)) for k in (
            "att_level", "att_tau", "rel_level", "rel_tau")},
        hold=int(np.asarray(p.hold)))


def autogain_state_from_jax(s, device="cuda") -> AutoGainState:
    """JAX ``AutoGainState`` (numpy leaves) -> port ``AutoGainState``."""
    return AutoGainState(gain=_t(s.gain, device),
                         out_gain=_t(s.out_gain, device),
                         surge_up=_t(s.surge_up, device, torch.bool),
                         surge_down=_t(s.surge_down, device, torch.bool))


def simple_autogain_state_from_jax(s, device="cuda") -> SimpleAutoGainState:
    """JAX ``SimpleAutoGainState`` -> port ``SimpleAutoGainState``."""
    return SimpleAutoGainState(gain=_t(s.gain, device))


def surge_state_from_jax(s, device="cuda") -> SurgeProtectorState:
    """JAX ``SurgeProtectorState`` -> port ``SurgeProtectorState``."""
    return SurgeProtectorState(
        on=_t(s.on, device, torch.bool),
        shutdown_time=_t(s.shutdown_time, device, torch.int32),
        transition_time=_t(s.transition_time, device, torch.int32))


def peak_meter_state_from_jax(s, device="cuda") -> PeakMeterState:
    """JAX ``PeakMeterState`` -> port ``PeakMeterState``."""
    return PeakMeterState(peak=_t(s.peak, device),
                          counter=_t(s.counter, device, torch.int32))


def loudness_state_from_jax(s, device="cuda") -> LoudnessMeterState:
    """JAX ``LoudnessMeterState`` -> port ``LoudnessMeterState``."""
    return LoudnessMeterState(flt=_t(s.flt, device),
                              window=_t(s.window, device))


def ilufs_state_from_jax(s, device="cuda") -> ILUFSState:
    """JAX ``ILUFSState`` (numpy leaves) -> port ``ILUFSState``, its
    scalar bookkeeping as host ints and a bool."""
    return ILUFSState(
        flt=_t(s.flt, device), part_sums=_t(s.part_sums, device),
        part_idx=int(np.asarray(s.part_idx)),
        part_fill=int(np.asarray(s.part_fill)),
        blk_full=bool(np.asarray(s.blk_full)), ring=_t(s.ring, device),
        ring_pos=int(np.asarray(s.ring_pos)),
        ring_cnt=int(np.asarray(s.ring_cnt)),
        loudness=_t(s.loudness, device))


def true_peak_state_from_jax(s, device="cuda") -> TruePeakState:
    """JAX ``TruePeakState`` -> port ``TruePeakState``."""
    return TruePeakState(hist=_t(s.hist, device))


def correlometer_state_from_jax(s, device="cuda") -> CorrelometerState:
    """JAX ``CorrelometerState`` -> port ``CorrelometerState``."""
    return CorrelometerState(win_a=_t(s.win_a, device),
                             win_b=_t(s.win_b, device))


def panometer_state_from_jax(s, device="cuda") -> PanometerState:
    """JAX ``PanometerState`` -> port ``PanometerState``."""
    return PanometerState(win_a=_t(s.win_a, device),
                          win_b=_t(s.win_b, device))


def spectral_state_from_jax(s, device="cuda") -> SpectralState:
    """JAX ``SpectralState`` -> port ``SpectralState``."""
    return SpectralState(*(_t(v, device) for v in s))


def splitter_state_from_jax(s, device="cuda") -> SplitterState:
    """JAX ``SplitterState`` (SpectralSplitter, FFTCrossover) -> port
    ``SplitterState``."""
    return SplitterState(*(_t(v, device) for v in s))


def analyzer_state_from_jax(s, device="cuda") -> AnalyzerState:
    """JAX ``AnalyzerState`` -> port ``AnalyzerState``."""
    return AnalyzerState(*(_t(v, device) for v in s))


def oversampler_state_from_jax(s, device="cuda") -> OversamplerState:
    """JAX ``OversamplerState`` -> port ``OversamplerState``."""
    return OversamplerState(*(_t(v, device) for v in s))


def delay_state_from_jax(s, device="cuda") -> DelayState:
    """JAX ``DelayState`` -> port ``DelayState``."""
    return DelayState(history=_t(s.history, device))


def dynamic_delay_state_from_jax(s, device="cuda") -> DynamicDelayState:
    """JAX ``DynamicDelayState`` (the ring, newest sample at index -1)
    -> port ``DynamicDelayState`` (the same layout)."""
    return DynamicDelayState(buffer=_t(s.buffer, device))


def trigger_state_from_jax(s, device="cuda") -> TriggerState:
    """JAX ``TriggerState`` -> port ``TriggerState``."""
    return TriggerState(prev=_t(s.prev, device),
                        state=_t(s.state, device, torch.int32),
                        hold_cnt=_t(s.hold_cnt, device, torch.int32),
                        disarm=_t(s.disarm, device, torch.bool),
                        locked=_t(s.locked, device, torch.bool))


def depopper_state_from_jax(s, device="cuda") -> DepopperState:
    """JAX ``DepopperState`` -> port ``DepopperState``."""
    return DepopperState(st=_t(s.st, device, torch.int32),
                         counter=_t(s.counter, device, torch.int32),
                         delay=_t(s.delay, device, torch.int32),
                         rms_win=_t(s.rms_win, device),
                         pending=_t(s.pending, device))


def oscillator_state_from_jax(s, device="cuda") -> OscillatorState:
    """JAX ``OscillatorState`` -> port ``OscillatorState``: the uint32
    phase word as an int64 in [0, 2^32); the band-limited modes'
    Oversampler state through :func:`oversampler_state_from_jax`, the
    naive modes' empty one as it is."""
    ovs = s.ovs
    if isinstance(ovs, tuple) and len(ovs) == 0:
        ovs = ()
    else:
        ovs = oversampler_state_from_jax(ovs, device)
    return OscillatorState(
        phase=torch.tensor(int(np.asarray(s.phase, np.uint64)),
                           dtype=torch.int64, device=device), ovs=ovs)


def bypass_state_from_jax(s, device="cuda") -> BypassState:
    """JAX ``BypassState`` -> port ``BypassState``."""
    return BypassState(gain=_t(s.gain, device), delta=_t(s.delta, device))


def crossfade_state_from_jax(s, device="cuda") -> CrossfadeState:
    """JAX ``CrossfadeState`` -> port ``CrossfadeState``."""
    return CrossfadeState(counter=_t(s.counter, device, torch.int32),
                          gain=_t(s.gain, device))


def quantized_counter_state_from_jax(s, device="cuda"
                                     ) -> QuantizedCounterState:
    """JAX ``QuantizedCounterState`` -> port ``QuantizedCounterState``."""
    return QuantizedCounterState(**{
        f: _t(getattr(s, f), device,
              torch.float32 if f == "history" else torch.int32)
        for f in QuantizedCounterState._fields})
