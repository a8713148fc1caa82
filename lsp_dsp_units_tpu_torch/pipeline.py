"""The streaming chain: the port of pipeline.py's ``FilterConvChain``.

An 8-band EQ, a 1 s partitioned convolver and an RMS sidechain
compressor over [C, T] blocks, in three forms.  Each is one code path on
every device: the wrappers below run their CUDA kernels for CUDA tensors
and their plain PyTorch versions for CPU tensors.

* ``step_ring`` — one [C, B] block, the convolver over a packed ring:
    1. ops.fft_packed.rfft_packed_zeropad   EQ input spectrum
    2. ops.fdl_fused.eqfdl_fused            EQ + convolver + EQ state
    3. ops.env.chain_dyn                    sidechain + compressor
* ``step`` — [C, M B] per call (the JAX package's entry point):
    1. ops.biquad_block.cascade_block_fused  EQ: rfft_packed_zeropad,
                                              irfft_packed (first half)
    2. ops.fftconv.fdl_process               convolver: rfft_packed,
                                              irfft_packed (last half)
    3. Sidechain RMS                         ops.env_units.sliding_rms
    4. Compressor                            ops.env_units.peak_envelope
* ``bulk_step`` — one super-block: ``step``'s EQ and dynamics around a
  single big-FFT overlap-save convolver (ops.fftconv.ols_bulk_process;
  at frame sizes above the packed FFT's 32768, torch.fft).
* ``sharded_step`` — ``step`` over a ('chan', 'time') mesh of ranks
  (parallel/): the EQ exact across time shards (parallel.fused_iir), the
  convolver by halo exchange (parallel.halo), the dynamics on the
  time-gathered signal; the same kernels as ``step``.

No library matmul runs on any of them (the small state contractions are
broadcast multiply-and-sums), so global TF32 or matmul-precision
settings cannot change the output.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.models.dynamics.compressor import (
    Compressor, CompressorParams)
from lsp_dsp_units_tpu_torch.models.filters.design import (
    FilterParams, FilterType, design_filter)
from lsp_dsp_units_tpu_torch.models.util.sidechain import (
    Sidechain, SidechainMode, SidechainState)
from lsp_dsp_units_tpu_torch.ops import _build, biquad_block, fftconv
from lsp_dsp_units_tpu_torch.ops import dynamics as dyn
from lsp_dsp_units_tpu_torch.ops import fft_packed as fp
from lsp_dsp_units_tpu_torch.ops.env import chain_dyn
from lsp_dsp_units_tpu_torch.ops.fdl_fused import eqfdl_fused
from lsp_dsp_units_tpu_torch.parallel import mesh as pmesh
from lsp_dsp_units_tpu_torch.parallel.fused_iir import (
    fused_cascade_time_sharded, host_m_powers)
from lsp_dsp_units_tpu_torch.parallel.halo import fir_conv_time_sharded


def default_eq_params(sample_rate: int):
    """8-band cut/boost curve built from the reference filter families."""
    bands = [
        (FilterType.BT_BWC_HIPASS, 40.0, 1.0, 2),
        (FilterType.BT_RLC_LOSHELF, 120.0, 1.25, 1),
        (FilterType.BT_RLC_BELL, 250.0, 0.7, 1),
        (FilterType.BT_RLC_BELL, 800.0, 1.5, 1),
        (FilterType.BT_RLC_BELL, 2000.0, 0.8, 1),
        (FilterType.BT_RLC_BELL, 5000.0, 1.3, 1),
        (FilterType.BT_BWC_HISHELF, 8000.0, 1.12, 2),
        (FilterType.BT_BWC_LOPASS, 18000.0, 1.0, 2),
    ]
    return [FilterParams(ftype=t, freq=f, gain=g, slope=s, quality=0.5)
            for (t, f, g, s) in bands]


class ChainParams(NamedTuple):
    eq_coeffs: np.ndarray                   # [K, 5] float32 host biquads
    eq_block: biquad_block.FusedCascadeParams
    h_spectra: fftconv.Spectra              # [P, B + 1] natural order
    comp: CompressorParams                  # host numbers
    heq_re: torch.Tensor                    # [B] packed EQ spectrum
    heq_im: torch.Tensor
    h_re: torch.Tensor                      # [P, B] packed IR partitions
    h_im: torch.Tensor


def chain_params(eq_coeffs: np.ndarray,
                 eq_block: biquad_block.FusedCascadeParams,
                 h_spectra: fftconv.Spectra,
                 comp: CompressorParams) -> ChainParams:
    """Assemble ChainParams, packing the EQ and IR spectra once (the
    step reuses them every block), outside any graph: ``step_ring``
    packs again, in its graph, those that require grad."""
    n = 2 * (h_spectra.re.shape[-1] - 1)
    with torch.no_grad():
        heq_re, heq_im = fp.pack_spectra(eq_block.h_re, eq_block.h_im, n)
        h_re, h_im = fp.pack_spectra(h_spectra.re, h_spectra.im, n)
    return ChainParams(eq_coeffs=np.asarray(eq_coeffs, np.float32),
                       eq_block=eq_block, h_spectra=h_spectra, comp=comp,
                       heq_re=heq_re, heq_im=heq_im, h_re=h_re, h_im=h_im)


class ChainState(NamedTuple):
    eq: torch.Tensor                        # [C, K, 2] balanced EQ state
    fdl: fftconv.FDLState                   # natural order [C, P, B + 1]
    sc: SidechainState
    env: dyn.EnvState


class ChainBulkState(NamedTuple):
    eq: torch.Tensor
    conv: fftconv.OLSBulkState              # [C, T_super] time history
    sc: SidechainState
    env: dyn.EnvState


class ChainRingState(NamedTuple):
    eq: torch.Tensor                        # [C, K, 2] balanced EQ state
    fdl: fftconv.RingFDLState               # packed ring [P, C, B]
    sc: SidechainState
    env: dyn.EnvState


class FilterConvChain:
    """C-channel EQ -> convolver -> sidechain compressor chain."""

    def __init__(self, sample_rate: int = 48000, channels: int = 64,
                 ir: Optional[np.ndarray] = None, rank: int = 14,
                 ir_seconds: float = 1.0, device="cuda"):
        self.sample_rate = int(sample_rate)
        self.channels = int(channels)
        self.rank = int(rank)
        self.block = 1 << (rank - 1)
        self.device = torch.device(device)
        if ir is None:
            # synthetic exponentially-decaying room-like IR
            n = int(ir_seconds * sample_rate)
            rng = np.random.default_rng(1234)
            t = np.arange(n) / sample_rate
            ir = (rng.standard_normal(n)
                  * np.exp(-3.0 * t)).astype(np.float32)
            ir[0] = 1.0
            ir *= 0.25
        self.ir = np.asarray(ir, np.float32)
        self.sidechain = Sidechain(sample_rate, SidechainMode.RMS,
                                   reactivity_ms=10.0)
        self.compressor = Compressor(sample_rate, attack_thresh=0.25,
                                     release_thresh=0.125,
                                     attack_ms=10.0, release_ms=80.0,
                                     knee=0.7071, ratio=4.0)

    def build(self) -> ChainParams:
        eq = np.concatenate(
            [design_filter(p, self.sample_rate).biquads
             for p in default_eq_params(self.sample_rate)], axis=0)
        return chain_params(
            eq_coeffs=eq,
            eq_block=biquad_block.precompute_fused(eq, self.block,
                                                   device=self.device),
            h_spectra=fftconv.parse_ir(
                torch.from_numpy(self.ir).to(self.device), self.block),
            comp=self.compressor.build())

    def init_state(self, params: ChainParams,
                   channels: Optional[int] = None) -> ChainState:
        c = self.channels if channels is None else channels
        return ChainState(
            eq=biquad_block.init_state(params.eq_coeffs.shape[0], (c,),
                                       self.device),
            fdl=fftconv.init_fdl(params.h_spectra, (c,), self.device),
            sc=self.sidechain.init_state((c,), self.device),
            env=dyn.env_init((c,), self.device))

    def step(self, params: ChainParams, state: ChainState,
             x: torch.Tensor) -> Tuple[ChainState, torch.Tensor]:
        """x: [C, T], T a multiple of self.block."""
        y, eq_st = biquad_block.cascade_block_fused(params.eq_block,
                                                    state.eq, x)
        fdl_st, y = fftconv.fdl_process(params.h_spectra, state.fdl, y)
        sc_st, level = self.sidechain.process(state.sc, y)
        env_st, gain, _ = self.compressor.process(params.comp, state.env,
                                                  level)
        return ChainState(eq=eq_st, fdl=fdl_st, sc=sc_st,
                          env=env_st), y * gain

    def build_bulk(self, t_super: int) -> fftconv.Spectra:
        """Whole-IR spectrum for :meth:`bulk_step` at super-block size
        ``t_super`` (a multiple of self.block, >= len(ir) - 1)."""
        if t_super % self.block:
            raise ValueError(f"t_super {t_super} is not a multiple of "
                             f"{self.block}")
        return fftconv.ols_bulk_spectra(
            torch.from_numpy(self.ir).to(self.device), t_super)

    def init_bulk_state(self, params: ChainParams, t_super: int,
                        channels: Optional[int] = None) -> ChainBulkState:
        c = self.channels if channels is None else channels
        return ChainBulkState(
            eq=biquad_block.init_state(params.eq_coeffs.shape[0], (c,),
                                       self.device),
            conv=fftconv.init_ols_bulk(t_super, (c,), self.device),
            sc=self.sidechain.init_state((c,), self.device),
            env=dyn.env_init((c,), self.device))

    def bulk_step(self, params: ChainParams, h_bulk: fftconv.Spectra,
                  state: ChainBulkState, x: torch.Tensor
                  ) -> Tuple[ChainBulkState, torch.Tensor]:
        """One super-block x [C, T_super] through the chain: the math of
        :meth:`step` with the convolver as one big-FFT overlap-save."""
        y, eq_st = biquad_block.cascade_block_fused(params.eq_block,
                                                    state.eq, x)
        conv_st, y = fftconv.ols_bulk_process(h_bulk, state.conv, y)
        sc_st, level = self.sidechain.process(state.sc, y)
        env_st, gain, _ = self.compressor.process(params.comp, state.env,
                                                  level)
        return ChainBulkState(eq=eq_st, conv=conv_st, sc=sc_st,
                              env=env_st), y * gain

    def init_ring_state(self, params: ChainParams,
                        channels: Optional[int] = None) -> ChainRingState:
        c = self.channels if channels is None else channels
        return ChainRingState(
            eq=biquad_block.init_state(params.eq_coeffs.shape[0], (c,),
                                       self.device),
            fdl=fftconv.init_ring_fdl(params.h_spectra, (c,), packed=True,
                                      device=self.device),
            sc=self.sidechain.init_state((c,), self.device),
            env=dyn.env_init((c,), self.device))

    def step_ring(self, params: ChainParams, state: ChainRingState,
                  x: torch.Tensor) -> Tuple[ChainRingState, torch.Tensor]:
        """One block x [C, B] float32 through the chain.  The ring planes
        of ``state`` are updated in place (one slot per block) and
        carried into the returned state.

        Differentiable (PyTorch autograd) in x, every float leaf of the
        state and the parameters' tensors: under autograd the ring is
        written anew each block instead of in place, and the packed
        spectra and ``g_t`` are formed again, in the graph, from those
        of ``params.h_spectra``, ``params.eq_block.h_re``/``h_im`` and
        ``g_mat`` that require grad (otherwise ``chain_params``' packed
        copies serve, as without grad)."""
        if x.ndim != 2 or x.shape[-1] != self.block:
            raise ValueError(f"x must be [C, {self.block}], got "
                             f"{tuple(x.shape)}")
        c = x.shape[0]
        eqp = params.eq_block
        k2 = eqp.m_mat.shape[0]
        p_n = params.h_re.shape[0]
        w = (state.fdl.pos + 1) % p_n
        n = 2 * self.block
        heq = (params.heq_re, params.heq_im)
        if _build.needs_grad(eqp.h_re, eqp.h_im):
            heq = fp.pack_spectra(eqp.h_re, eqp.h_im, n)
        h = (params.h_re, params.h_im)
        if _build.needs_grad(params.h_spectra):
            h = fp.pack_spectra(*params.h_spectra, n)
        g_t = eqp.g_t
        if _build.needs_grad(eqp.g_mat):
            g_t = eqp.g_mat.t().contiguous()
        xs_re, xs_im = fp.rfft_packed_zeropad(x)
        y, u, sv2, ring_re, ring_im = eqfdl_fused(
            state.fdl.spec_re, state.fdl.spec_im, *h, *heq, xs_re, xs_im, x,
            state.eq.reshape(c, k2), g_t, eqp.m_mat, eqp.w_mat,
            state.fdl.history, w)
        fdl_st = fftconv.RingFDLState(spec_re=ring_re, spec_im=ring_im,
                                      history=u, pos=w)
        comp = params.comp
        win, env_st, y = chain_dyn(
            state.sc.window, state.env, y, self.sidechain.reactivity,
            self.sidechain.gain, comp.tau_attack, comp.tau_release,
            comp.release_thresh, comp.hold, comp.knees)
        return ChainRingState(eq=sv2.reshape(state.eq.shape), fdl=fdl_st,
                              sc=state.sc._replace(window=win),
                              env=env_st), y

    def sharded_step(self, mesh, params: ChainParams):
        """``step`` over a ('chan', 'time') mesh (parallel.mesh.make_mesh).

        Returns ``fn(state_local, x_local) -> (state_local, y_local)``: x
        this rank's [C / chan, T / time] shard
        (``mesh.chan_time_sharding``), the state sharded over channels
        only (``mesh.chan_sharding``) and the same on every time rank of
        a channel shard.  Collectives run over the mesh's time group.
        """
        chain = self
        group = mesh.get_group(pmesh.TIME_AXIS)
        powers = {}         # the EQ's host-side transitions, by shard size

        def fn(state: ChainState, x: torch.Tensor
               ) -> Tuple[ChainState, torch.Tensor]:
            # EQ: exact across time shards (the fused block cascade's
            # float64-precomputed transitions, ~120 dB like step's)
            m = x.shape[-1] // chain.block
            if m not in powers:
                powers[m] = host_m_powers(params.eq_block, m)
            y, eq_st = fused_cascade_time_sharded(params.eq_block, state.eq,
                                                  x, group, powers[m])
            # convolver: halo FIR over the time axis; the carried FDL
            # supplies history older than the call, so the reverb tail
            # survives call boundaries (as in step)
            y, fdl_st = fir_conv_time_sharded(params.h_spectra, chain.block,
                                              y, group, carry=state.fdl)
            # dynamics are sequential in time: gather the time axis for
            # the detector and the envelope (channels stay parallel), then
            # take this rank's slice of the gain
            y_full = pmesh.all_gather(y, group, dim=-1, tiled=True)
            sc_st, level = chain.sidechain.process(state.sc, y_full)
            env_st, gain, _ = chain.compressor.process(params.comp,
                                                       state.env, level)
            t_loc = x.shape[-1]
            i = pmesh.axis_index(group)
            return ChainState(eq=eq_st, fdl=fdl_st, sc=sc_st, env=env_st), \
                y * gain[..., i * t_loc:(i + 1) * t_loc]

        return fn
