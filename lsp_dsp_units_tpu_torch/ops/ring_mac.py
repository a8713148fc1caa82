"""The ring-FDL spectra MAC with the in-place slot write: the port of
ops/pallas_fdl.py::ring_mac_pallas.

The convolver's per-block work between its forward and inverse FFTs,
when they run as separate kernels (rfft -> :func:`ring_mac` -> irfft;
ops/fdl_fused.py runs all three as one kernel):

  acc = sum_p ring'[p] * H[(w - p) % P]   (p ascending, ring' = ring
                                           with slot w read as S)
  ring[w] := S                            (in place)

over a partition-major ring [P, C, F] of natural (F = B + 1) or packed
(F = B, ``packed_dc=True``: position 0 holds the real DC and Nyquist
bins, which multiply slot-wise; ops/fft_packed.py) spectra.  Partitions
are summed in ascending order, the reference convolver's order.  Unlike
the JAX function, the IR spectra come unrotated with the slot index
``w``.  :func:`ring_mac` runs :func:`ring_mac_plain` for CPU tensors and
the CUDA kernel (``csrc/ring_mac.cu``) for CUDA tensors, counting
launches in ``ring_mac.launches``; both round every product and sum
once, so they agree bit for bit.

:func:`ring_mac_bwd_plain` is the MAC's adjoint, which the backwards of
ops/fdl_fused.py run: with g the cotangent of acc, partition p's slot
gets ``g * conj(H[(w - p) % P])`` (plus the cotangent of the ring
carried out), each IR partition ``sum over channels of g *
conj(ring'[p])``, S the slot w's share, and the incoming slot w nothing
(it is overwritten).  :func:`ring_mac` itself has no backward and
raises under grad.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.ops import fft_packed as fp
from lsp_dsp_units_tpu_torch.ops.cplx import sc_mul

_SIGS = {"lsp_ring_mac": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
         + [ctypes.c_void_p]}


def ring_mac_plain(ring_re, ring_im, h_re, h_im, s_re, s_im, w: int,
                   packed_dc: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`ring_mac` (same contract)."""
    p_n = ring_re.shape[0]
    acc_re = torch.zeros_like(s_re)
    acc_im = torch.zeros_like(s_im)
    for p in range(p_n):
        q = (w - p) % p_n
        vr, vi = (s_re, s_im) if p == w else (ring_re[p], ring_im[p])
        if packed_dc:
            mr, mi = fp.mul_packed(vr, vi, h_re[q], h_im[q])
        else:
            mr, mi = sc_mul((vr, vi), (h_re[q], h_im[q]))
        acc_re = acc_re + mr
        acc_im = acc_im + mi
    ring_re[w] = s_re
    ring_im[w] = s_im
    return acc_re, acc_im


def _mul_conj(ar, ai, br, bi):
    """``a * conj(b)`` of natural-order split-complex spectra."""
    return ar * br + ai * bi, ai * br - ar * bi


def _channel_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over every axis but the last (the channels)."""
    return v.reshape(-1, v.shape[-1]).sum(dim=0)


def ring_mac_bwd_plain(ring_re, ring_im, h_re, h_im, g_re, g_im, g_ring_re,
                       g_ring_im, w: int, packed_dc: bool = False):
    """Adjoint of :func:`ring_mac`: ``ring_*`` [P, C, F] the ring after
    the step (ring', slot w holding S), ``h_*`` [P, F] the IR spectra,
    ``g_*`` [C, F] the cotangent of acc, ``g_ring_*`` that of the ring
    carried out (None: zero).  Returns the cotangents of the incoming
    ring (zero at slot w), of H and of S:
    (g_ring_re, g_ring_im, g_h_re, g_h_im, g_s_re, g_s_im)."""
    p_n = ring_re.shape[0]
    mul = fp.mul_conj_packed if packed_dc else _mul_conj
    gr = (torch.zeros_like(ring_re) if g_ring_re is None
          else g_ring_re.clone())
    gi = (torch.zeros_like(ring_im) if g_ring_im is None
          else g_ring_im.clone())
    gh_re = torch.empty_like(h_re)
    gh_im = torch.empty_like(h_im)
    for p in range(p_n):
        q = (w - p) % p_n
        ar, ai = mul(g_re, g_im, h_re[q], h_im[q])
        gr[p] = gr[p] + ar
        gi[p] = gi[p] + ai
        hr, hi = mul(g_re, g_im, ring_re[p], ring_im[p])
        gh_re[q] = _channel_sum(hr)
        gh_im[q] = _channel_sum(hi)
    gs_re, gs_im = gr[w].clone(), gi[w].clone()
    gr[w] = 0.0
    gi[w] = 0.0
    return gr, gi, gh_re, gh_im, gs_re, gs_im


def ring_mac(ring_re, ring_im, h_re, h_im, s_re, s_im, w: int,
             packed_dc: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """MAC over the spectra ring + in-place slot write.

    ``ring_*`` [P, C, F] carried spectra, partition-major, updated in
    place at slot ``w``; ``h_*`` [P, F] IR spectra (unrotated); ``s_*``
    [C, F] the newest block's spectrum.  Returns (acc_re, acc_im)
    [C, F]."""
    args = (ring_re, ring_im, h_re, h_im, s_re, s_im)
    _build.no_grad_route("ring_mac", *args)
    if _build.is_cpu(*args):
        return ring_mac_plain(*args, w, packed_dc)
    p_n, c_n, f_n = ring_re.shape
    named = _build.check_shapes(args, dict(
        ring_re=(p_n, c_n, f_n), ring_im=(p_n, c_n, f_n), h_re=(p_n, f_n),
        h_im=(p_n, f_n), s_re=(c_n, f_n), s_im=(c_n, f_n)))
    _build.check_cuda(torch.float32, ring_re.device, **named)
    _build.check_slot(w, p_n)
    acc_re = torch.empty_like(s_re)
    acc_im = torch.empty_like(s_im)
    lib = _build.load("ring_mac", _SIGS)
    _build.check(lib.lsp_ring_mac(
        *(_build.ptr(t) for t in args), _build.ptr(acc_re),
        _build.ptr(acc_im), p_n, int(w), c_n, f_n, int(bool(packed_dc)),
        _build.stream_of(s_re)), "ring_mac kernel")
    ring_mac.launches += 1
    return acc_re, acc_im


ring_mac.launches = 0
