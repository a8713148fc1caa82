"""FFT convolution: the port of ops/fftconv.py.

Uniform partitioned overlap-save convolution with a frequency-delay line
(FDL), in two storage forms:

* :class:`FDLState` (:func:`fdl_step`, :func:`fdl_process`, the
  convolver of ``step``): natural-order spectra [..., P, B + 1], newest
  first.  ``fdl_process`` forward-transforms all M frames of a call at
  once and forms the partition MAC as two small contractions (the far
  part over the carried history, the near part over this call's frames),
  each a broadcast multiply-and-sum, so no library matmul (and no global
  TF32 setting) touches it; the inverse returns only the last half of
  each frame.  The transforms go through ops/cplx.py, i.e. the packed FFT
  kernels for CUDA tensors.
* :class:`OLSBulkState` (:func:`ols_bulk_process`, the convolver of
  ``bulk_step``): one big-FFT overlap-save per super-block.

The ring (:class:`RingFDLState`, :func:`fdl_ring_step`) keeps the P
newest frame spectra partition-major, [P, ..., F]: each block writes only
slot ``w = (pos + 1) % P`` and partition p multiplies slot p by the IR
spectrum ``H[(w - p) % P]``.  A natural-order ring (F = B + 1, the
default, as in the JAX package) runs the plain staged form; a packed ring
(F = B, ``init_ring_fdl(packed=True)``, ops/fft_packed.py) runs the whole
block as one kernel, ops/fdl_fused.py's :func:`fdl_fused`, and is
updated in place.  ``pos`` is a host integer: PyTorch runs eagerly, so
the slot index never needs to live on the device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from lsp_dsp_units_tpu_torch.ops import fft_packed as fp
from lsp_dsp_units_tpu_torch.ops.cplx import irfft_sc, rfft_sc, sc_mul, sc_sum
from lsp_dsp_units_tpu_torch.ops.fdl_fused import fdl_fused


class Spectra(NamedTuple):
    """Split-complex spectra container."""
    re: torch.Tensor
    im: torch.Tensor


def parse_ir(ir: torch.Tensor, block: int) -> Spectra:
    """Partition an impulse response ``ir [..., N]`` into FDL spectra
    [..., P, B + 1], P = ceil(N / B), each partition zero-padded to 2B
    before the rfft (overlap-save layout)."""
    n = ir.shape[-1]
    p = max(1, -(-n // block))
    ir_p = torch.nn.functional.pad(ir.to(torch.float32), (0, p * block - n))
    parts = ir_p.reshape(ir.shape[:-1] + (p, block))
    re, im = rfft_sc(parts, 2 * block)
    return Spectra(re, im)


class FDLState(NamedTuple):
    """Carried state of a partitioned convolver."""
    spec_re: torch.Tensor   # [..., P, F] past frame spectra, 0 = newest
    spec_im: torch.Tensor
    history: torch.Tensor   # [..., B] previous input block (overlap-save)


def init_fdl(h_spectra: Spectra, batch_shape: Tuple[int, ...] = (),
             device="cuda") -> FDLState:
    p, f = h_spectra.re.shape[-2], h_spectra.re.shape[-1]
    z = torch.zeros(tuple(batch_shape) + (p, f), dtype=torch.float32,
                    device=device)
    return FDLState(spec_re=z, spec_im=z.clone(),
                    history=torch.zeros(tuple(batch_shape) + (f - 1,),
                                        dtype=torch.float32, device=device))


def fdl_step(h_spectra: Spectra, state: FDLState, x_block: torch.Tensor
             ) -> Tuple[FDLState, torch.Tensor]:
    """One block x [..., B] of partitioned overlap-save convolution:
    the new frame spectrum enters the FDL at slot 0, the output is the
    last half of ``irfft(sum_p fdl[p] * H[p])``."""
    b = x_block.shape[-1]
    frame = torch.cat([state.history, x_block], dim=-1)
    sr, si = rfft_sc(frame)
    fdl_re = torch.cat([sr[..., None, :], state.spec_re[..., :-1, :]], -2)
    fdl_im = torch.cat([si[..., None, :], state.spec_im[..., :-1, :]], -2)
    acc = sc_sum(sc_mul((fdl_re, fdl_im), (h_spectra.re, h_spectra.im)),
                 dim=-2)
    y = irfft_sc(acc, 2 * b, half="last")
    return FDLState(spec_re=fdl_re, spec_im=fdl_im,
                    history=x_block), y.to(x_block.dtype)


def _contract(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out[..., k, f] = sum_q a[..., q, f] * w[..., q, k, f]`` as a
    broadcast multiply and a sum over q."""
    return torch.sum(a[..., :, None, :] * w, dim=-3)


def fdl_process(h_spectra: Spectra, state: FDLState, x: torch.Tensor
                ) -> Tuple[FDLState, torch.Tensor]:
    """T = M B samples (last axis) through the FDL convolver.

    All M frames are transformed at once; output block k needs
    ``sum_p H[p] * spec(k - p)``, split by the sign of k - p into
    FAR (carried history): ``Far[k] = sum_q Old[q] * H[q + k + 1]`` and
    NEAR (this call): ``Near[k] = sum_{j<=k} S[j] * H[k - j]``.  IR
    spectra [P, F] or batched [..., P, F]."""
    b = state.history.shape[-1]
    t = x.shape[-1]
    if t % b:
        raise ValueError(f"input length {t} is not a multiple of {b}")
    m = t // b
    if m == 1:
        return fdl_step(h_spectra, state, x)
    p = h_spectra.re.shape[-2]
    dev = x.device
    xb = x.reshape(x.shape[:-1] + (m, b))
    prev = torch.cat([state.history[..., None, :], xb[..., :-1, :]], -2)
    specs_re, specs_im = rfft_sc(torch.cat([prev, xb], dim=-1))

    def weights(idx, ok):
        # w[..., q, k, f] = H[..., idx[q, k], f] where ok, else 0
        idx = idx.clamp(0, p - 1)
        okf = ok[..., None].to(h_spectra.re.dtype)
        return (h_spectra.re[..., idx, :] * okf,
                h_spectra.im[..., idx, :] * okf)

    iq = (torch.arange(p, device=dev)[:, None]
          + torch.arange(m, device=dev)[None, :] + 1)            # [P, M]
    wf_re, wf_im = weights(iq, iq <= p - 1)
    ij = (torch.arange(m, device=dev)[None, :]
          - torch.arange(m, device=dev)[:, None])                # [M, M]
    wn_re, wn_im = weights(ij, (ij >= 0) & (ij <= p - 1))
    old_re, old_im = state.spec_re, state.spec_im     # Old[q] = block -1-q
    far_re = _contract(old_re, wf_re) - _contract(old_im, wf_im)
    far_im = _contract(old_re, wf_im) + _contract(old_im, wf_re)
    near_re = _contract(specs_re, wn_re) - _contract(specs_im, wn_im)
    near_im = _contract(specs_re, wn_im) + _contract(specs_im, wn_re)
    acc = (far_re + near_re, far_im + near_im)
    if m >= p:
        fre = torch.flip(specs_re[..., m - p:, :], dims=(-2,))
        fim = torch.flip(specs_im[..., m - p:, :], dims=(-2,))
    else:
        fre = torch.cat([torch.flip(specs_re, dims=(-2,)),
                         state.spec_re[..., :p - m, :]], dim=-2)
        fim = torch.cat([torch.flip(specs_im, dims=(-2,)),
                         state.spec_im[..., :p - m, :]], dim=-2)
    y = irfft_sc(acc, 2 * b, half="last").reshape(x.shape)
    return FDLState(spec_re=fre, spec_im=fim,
                    history=xb[..., -1, :].contiguous()), y.to(x.dtype)


class RingFDLState(NamedTuple):
    spec_re: torch.Tensor   # [P, ..., F] ring storage, partition-major
    spec_im: torch.Tensor
    history: torch.Tensor   # [..., B] previous input block (overlap-save)
    pos: int                # slot holding the newest block's spectrum


def init_ring_fdl(h_spectra: Spectra, batch_shape: Tuple[int, ...] = (),
                  packed: bool = False, device="cuda") -> RingFDLState:
    """Zero ring for IR spectra [P, B + 1]; ``packed`` stores F = B
    packed bins (ops/fft_packed.py) instead of B + 1 natural ones, at
    the frame sizes the packed FFT takes."""
    p, f = h_spectra.re.shape[-2], h_spectra.re.shape[-1]
    block = f - 1
    if packed and not fp.supported(2 * block):
        raise ValueError(
            f"a packed ring needs a frame size the packed FFT takes "
            f"(2 * block = {2 * block}: a power of two in "
            f"[{2 * fp.MIN_M}, {2 * fp.MAX_M}]); use packed=False")
    fdim = block if packed else f
    z = torch.zeros((p,) + tuple(batch_shape) + (fdim,), dtype=torch.float32,
                    device=device)
    return RingFDLState(spec_re=z, spec_im=z.clone(),
                        history=torch.zeros(tuple(batch_shape) + (block,),
                                            dtype=torch.float32,
                                            device=device),
                        pos=p - 1)


_PACKED_IR: Dict[int, tuple] = {}
_PACKED_IR_MAX = 8


def packed_ir(h_spectra: Spectra) -> Tuple[torch.Tensor, torch.Tensor]:
    """IR spectra [P, B + 1] packed to [P, B], once per spectra tensor
    (again only when it changes in place): the ring step reuses them every
    block, as pipeline.chain_params does for the chain."""
    re, im = h_spectra
    key = (re._version, im._version)
    hit = _PACKED_IR.get(id(re))
    if hit is None or hit[0] is not re or hit[1] is not im or hit[2] != key:
        if len(_PACKED_IR) >= _PACKED_IR_MAX:
            _PACKED_IR.pop(next(iter(_PACKED_IR)))
        hit = (re, im, key,
               fp.pack_spectra(re, im, 2 * (re.shape[-1] - 1)))
        _PACKED_IR[id(re)] = hit
    return hit[3]


def fdl_ring_step(h_spectra: Spectra, state: RingFDLState,
                  x_block: torch.Tensor
                  ) -> Tuple[RingFDLState, torch.Tensor]:
    """One block x [..., B]: the new frame spectrum goes to slot w and
    the output is the last half of ``irfft(sum_p ring[p] * H[(w - p) %
    P])``.  A natural-order ring runs the plain staged form and returns a
    new ring; a packed ring [P, C, B] (with IR spectra [P, B + 1]) runs
    :func:`fdl_fused` and is updated in place."""
    p = h_spectra.re.shape[-2]
    b = x_block.shape[-1]
    w = (state.pos + 1) % p
    if state.spec_re.shape[-1] == b:                    # packed ring
        if state.spec_re.ndim != 3 or h_spectra.re.ndim != 2:
            raise ValueError("a packed ring is [P, C, B] and its IR "
                             "spectra [P, B + 1]")
        h_re, h_im = packed_ir(h_spectra)
        x = x_block.to(torch.float32).contiguous()
        y = fdl_fused(state.spec_re, state.spec_im, h_re, h_im,
                      state.history, x, w)
        return state._replace(history=x, pos=w), y.to(x_block.dtype)
    frame = torch.cat([state.history, x_block], dim=-1)
    sr, si = rfft_sc(frame)
    buf_re = state.spec_re.clone()
    buf_im = state.spec_im.clone()
    buf_re[w] = sr
    buf_im[w] = si
    rot = [(w - q) % p for q in range(p)]
    nb = state.spec_re.ndim - 2
    hshape = (p,) + (1,) * nb + h_spectra.re.shape[-1:]
    hre = h_spectra.re[rot].reshape(hshape)
    him = h_spectra.im[rot].reshape(hshape)
    acc = sc_sum(sc_mul((buf_re, buf_im), (hre, him)), dim=0)
    y = irfft_sc(acc, frame.shape[-1])[..., x_block.shape[-1]:]
    return RingFDLState(spec_re=buf_re, spec_im=buf_im, history=x_block,
                        pos=w), y.to(x_block.dtype)


class OLSBulkState(NamedTuple):
    """Carried state of the big-FFT overlap-save bulk convolver: the
    last T input samples (time domain)."""
    history: torch.Tensor   # [..., T] float32


def ols_bulk_spectra(ir: torch.Tensor, t_super: int) -> Spectra:
    """Whole-IR spectrum for :func:`ols_bulk_process` at super-block size
    ``t_super``: nfft = 2 t_super, requiring len(ir) <= t_super + 1."""
    n = ir.shape[-1]
    if n > t_super + 1:
        raise ValueError(f"IR of {n} taps needs t_super >= {n - 1}")
    re, im = rfft_sc(ir.to(torch.float32), 2 * t_super)
    return Spectra(re, im)


def init_ols_bulk(t_super: int, batch_shape: Tuple[int, ...] = (),
                  device="cuda") -> OLSBulkState:
    return OLSBulkState(history=torch.zeros(
        tuple(batch_shape) + (t_super,), dtype=torch.float32, device=device))


def ols_bulk_process(h: Spectra, state: OLSBulkState, x: torch.Tensor
                     ) -> Tuple[OLSBulkState, torch.Tensor]:
    """Exact causal convolution of one super-block x [..., T] by a single
    big-FFT overlap-save: ``[history || x]`` -> rfft(2T) -> product ->
    last T samples of the inverse.  Semantics of :func:`fdl_process` for
    IRs up to T + 1 taps, with one super-block of latency."""
    t = x.shape[-1]
    if state.history.shape[-1] != t:
        raise ValueError(f"history of {state.history.shape[-1]} samples "
                         f"for a super-block of {t}")
    frame = torch.cat([state.history, x.to(torch.float32)], dim=-1)
    acc = sc_mul(rfft_sc(frame), (h.re, h.im))
    y = irfft_sc(acc, 2 * t, half="last")
    return OLSBulkState(history=x.to(torch.float32)), y.to(x.dtype)
