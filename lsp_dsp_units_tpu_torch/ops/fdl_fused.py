"""EQ convolution + ring-FDL convolver block: the port of
ops/pallas_fdl_fused.py::eqfdl_fused_pallas.

Per channel, given the packed spectrum ``xs`` of the zero-padded input
block (ops/fft_packed.rfft_packed_zeropad) and the EQ's balanced state
``sv``:

  u   = first half of irfft(xs * Heq) + g_mat @ sv    (EQ output)
  S   = rfft([hist || u])                             (FDL frame spectrum)
  acc = sum_p ring'[p] * H[(w - p) % P], ring' = ring with slot w := S
  ring[w] := S                                        (in place)
  y   = last half of irfft(acc)
  sv' = m_mat @ sv + w_mat @ x

All spectra are packed (ops/fft_packed.py).  :func:`eqfdl_fused` runs
:func:`eqfdl_fused_plain` for CPU tensors and the CUDA kernel
(``csrc/fdl_fused.cu``) for CUDA tensors, counting launches in
``eqfdl_fused.launches``.  Unlike the JAX function, the IR spectra come
unrotated with the slot index ``w`` (the kernel indexes ``H[(w - p) %
P]`` itself), and the G/M/W products are part of the function, so that
on the card no library matmul (and no global TF32 setting) touches them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.ops import fft_packed as fp

_SIGS = {"lsp_eqfdl_fused": [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5
         + [ctypes.c_void_p]}


def eqfdl_fused_plain(ring_re, ring_im, h_re, h_im, heq_re, heq_im,
                      xs_re, xs_im, x, sv, g_t, m_mat, w_mat, hist, w: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`eqfdl_fused` (same contract)."""
    p_n = ring_re.shape[0]
    n = 2 * x.shape[-1]
    pr, pi = fp.mul_packed(xs_re, xs_im, heq_re, heq_im)
    u = fp.irfft_packed_plain(pr, pi, n, "first") + sv @ g_t
    s_re, s_im = fp.rfft_packed_plain(torch.cat([hist, u], dim=-1))
    acc_re = torch.zeros_like(s_re)
    acc_im = torch.zeros_like(s_im)
    for p in range(p_n):
        q = (w - p) % p_n
        vr, vi = (s_re, s_im) if p == w else (ring_re[p], ring_im[p])
        mr, mi = fp.mul_packed(vr, vi, h_re[q], h_im[q])
        acc_re = acc_re + mr
        acc_im = acc_im + mi
    ring_re[w] = s_re
    ring_im[w] = s_im
    y = fp.irfft_packed_plain(acc_re, acc_im, n, "last")
    sv2 = sv @ m_mat.T + x @ w_mat.T
    return y, u, sv2


def eqfdl_fused(ring_re, ring_im, h_re, h_im, heq_re, heq_im, xs_re, xs_im,
                x, sv, g_t, m_mat, w_mat, hist, w: int):
    """One block of the chain's linear path.

    ``ring_*`` [P, C, B] packed ring, updated in place at slot ``w``;
    ``h_*`` [P, B] packed IR partitions; ``heq_*`` [B] packed EQ
    spectrum; ``xs_*`` [C, B] packed spectrum of ``x || 0``; ``x``,
    ``hist`` [C, B]; ``sv`` [C, 2K]; ``g_t`` [2K, B], ``m_mat`` [2K, 2K],
    ``w_mat`` [2K, B].  Returns (y [C, B], u [C, B], sv' [C, 2K])."""
    args = (ring_re, ring_im, h_re, h_im, heq_re, heq_im, xs_re, xs_im, x,
            sv, g_t, m_mat, w_mat, hist)
    if _build.is_cpu(*args):
        return eqfdl_fused_plain(*args, w)
    p_n, c_n, b = ring_re.shape
    k2 = m_mat.shape[0]
    shapes = dict(ring_re=(p_n, c_n, b), ring_im=(p_n, c_n, b),
                  h_re=(p_n, b), h_im=(p_n, b), heq_re=(b,), heq_im=(b,),
                  xs_re=(c_n, b), xs_im=(c_n, b), x=(c_n, b),
                  sv=(c_n, k2), g_t=(k2, b), m_mat=(k2, k2),
                  w_mat=(k2, b), hist=(c_n, b))
    named = dict(zip(shapes, args))
    for name, shape in shapes.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(named[name].shape)}")
    _build.check_cuda_f32(**named)
    if not 0 <= w < p_n:
        raise ValueError(f"slot {w} outside the ring of {p_n}")
    n = 2 * b
    lm = fp.log2_m(n)
    y = torch.empty_like(x)
    u = torch.empty_like(x)
    sv2 = torch.empty_like(sv)
    wst, wnb = fp.tables(n, x.device)
    lib = _build.load("fdl_fused", _SIGS)
    _build.check(lib.lsp_eqfdl_fused(
        *(_build.ptr(t) for t in args), _build.ptr(y), _build.ptr(u),
        _build.ptr(sv2), _build.ptr(wst), _build.ptr(wnb), lm, p_n, int(w),
        c_n, k2, _build.stream_of(x)), "eqfdl_fused kernel")
    eqfdl_fused.launches += 1
    return y, u, sv2


eqfdl_fused.launches = 0
