"""The convolver block in one kernel: the ports of
ops/pallas_fdl_fused.py::eqfdl_fused_pallas (the chain's EQ + convolver,
:func:`eqfdl_fused`) and ::fdl_fused_pallas (the convolver alone,
:func:`fdl_fused`).

Per channel, given the packed spectrum ``xs`` of the zero-padded input
block (ops/fft_packed.rfft_packed_zeropad) and the EQ's balanced state
``sv``, :func:`eqfdl_fused` computes:

  u   = first half of irfft(xs * Heq) + g_mat @ sv    (EQ output)
  S   = rfft([hist || u])                             (FDL frame spectrum)
  acc = sum_p ring'[p] * H[(w - p) % P], ring' = ring with slot w := S
  ring[w] := S                                        (in place)
  y   = last half of irfft(acc)
  sv' = m_mat @ sv + w_mat @ x

:func:`fdl_fused` is the same block without the EQ: the frame is
``[hist || x]``.  All spectra are packed (ops/fft_packed.py).  Each
wrapper runs its plain version (``*_plain``) for CPU tensors and its CUDA
kernel (``csrc/fdl_fused.cu``) for CUDA tensors, counting launches in
``<wrapper>.launches``.  Both kernels run two blocks per channel as a
cluster (:func:`eqfdl_launch_shape`, :func:`fdl_launch_shape`) and take
frame sizes 128 <= N <= 32768.  Unlike the JAX functions, the IR spectra come
unrotated with the slot index ``w`` (the kernels index ``H[(w - p) % P]``
themselves), and the G/M/W products are part of :func:`eqfdl_fused`, so
that on the card no library matmul (and no global TF32 setting) touches
them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.ops import fft_packed as fp
from lsp_dsp_units_tpu_torch.ops.ring_mac import ring_mac_plain

_SIGS = {"lsp_eqfdl_fused": [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5
         + [ctypes.c_void_p],
         "lsp_fdl_fused": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
         + [ctypes.c_void_p],
         "lsp_eqfdl_shape": [ctypes.c_int, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int)],
         "lsp_fdl_shape": [ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_int)]}


def _lib():
    return _build.load("fdl_fused", _SIGS)


def _check(args, shapes, w: int) -> None:
    """Shapes, dtype, device and alignment of a kernel's arguments."""
    _build.check_cuda_f32(**_build.check_shapes(args, shapes))
    _build.check_slot(w, shapes["ring_re"][0])


def eqfdl_fused_plain(ring_re, ring_im, h_re, h_im, heq_re, heq_im,
                      xs_re, xs_im, x, sv, g_t, m_mat, w_mat, hist, w: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`eqfdl_fused` (same contract)."""
    n = 2 * x.shape[-1]
    pr, pi = fp.mul_packed(xs_re, xs_im, heq_re, heq_im)
    u = fp.irfft_packed_plain(pr, pi, n, "first") + sv @ g_t
    s_re, s_im = fp.rfft_packed_plain(torch.cat([hist, u], dim=-1))
    acc_re, acc_im = ring_mac_plain(ring_re, ring_im, h_re, h_im, s_re,
                                    s_im, w, packed_dc=True)
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
    _build.no_grad_route("eqfdl_fused", *args)
    if _build.is_cpu(*args):
        return eqfdl_fused_plain(*args, w)
    p_n, c_n, b = ring_re.shape
    k2 = m_mat.shape[0]
    _check(args, dict(ring_re=(p_n, c_n, b), ring_im=(p_n, c_n, b),
                      h_re=(p_n, b), h_im=(p_n, b), heq_re=(b,),
                      heq_im=(b,), xs_re=(c_n, b), xs_im=(c_n, b),
                      x=(c_n, b), sv=(c_n, k2), g_t=(k2, b),
                      m_mat=(k2, k2), w_mat=(k2, b), hist=(c_n, b)), w)
    n = 2 * b
    lm = fp.log2_m(n)
    y = torch.empty_like(x)
    u = torch.empty_like(x)
    sv2 = torch.empty_like(sv)
    wst, wnb = fp.tables(n, x.device)
    _build.check(_lib().lsp_eqfdl_fused(
        *(_build.ptr(t) for t in args), _build.ptr(y), _build.ptr(u),
        _build.ptr(sv2), _build.ptr(wst), _build.ptr(wnb), lm, p_n, int(w),
        c_n, k2, _build.stream_of(x)), "eqfdl_fused kernel")
    eqfdl_fused.launches += 1
    return y, u, sv2


eqfdl_fused.launches = 0


def _launch_shape(entry: str, n: int, channels: int) -> dict:
    out = (ctypes.c_int * 5)()
    _build.check(getattr(_lib(), entry)(fp.log2_m(n), int(channels), out),
                 f"{entry}: launch shape")
    return dict(blocks_per_channel=out[0], threads=out[1], smem_bytes=out[2],
                blocks_per_sm=out[3], clusters_resident=out[4])


def eqfdl_launch_shape(n: int, channels: int) -> dict:
    """How :func:`eqfdl_fused`'s kernel launches at frame size N for
    ``channels`` channels (needs the card): blocks per channel (the
    cluster size), threads and dynamic shared memory (bytes) per block,
    blocks resident per SM by the occupancy calculator, and clusters of
    the launch resident at once."""
    return _launch_shape("lsp_eqfdl_shape", n, channels)


def fdl_launch_shape(n: int, channels: int) -> dict:
    """:func:`eqfdl_launch_shape` for :func:`fdl_fused`'s kernel."""
    return _launch_shape("lsp_fdl_shape", n, channels)


def fdl_fused_plain(ring_re, ring_im, h_re, h_im, hist, x, w: int
                    ) -> torch.Tensor:
    """Plain PyTorch version of :func:`fdl_fused` (same contract)."""
    n = 2 * x.shape[-1]
    s_re, s_im = fp.rfft_packed_plain(torch.cat([hist, x], dim=-1))
    acc_re, acc_im = ring_mac_plain(ring_re, ring_im, h_re, h_im, s_re,
                                    s_im, w, packed_dc=True)
    return fp.irfft_packed_plain(acc_re, acc_im, n, "last")


def fdl_fused(ring_re, ring_im, h_re, h_im, hist, x, w: int) -> torch.Tensor:
    """One convolver block over a packed ring.

    ``ring_*`` [P, C, B] packed ring, updated in place at slot ``w``;
    ``h_*`` [P, B] packed IR partitions (unrotated); ``hist``, ``x``
    [C, B], the overlap-save frame ``[hist || x]``.  Returns y [C, B],
    the last half of the frame's convolution."""
    args = (ring_re, ring_im, h_re, h_im, hist, x)
    _build.no_grad_route("fdl_fused", *args)
    if _build.is_cpu(*args):
        return fdl_fused_plain(*args, w)
    p_n, c_n, b = ring_re.shape
    _check(args, dict(ring_re=(p_n, c_n, b), ring_im=(p_n, c_n, b),
                      h_re=(p_n, b), h_im=(p_n, b), hist=(c_n, b),
                      x=(c_n, b)), w)
    n = 2 * b
    lm = fp.log2_m(n)
    y = torch.empty_like(x)
    wst, wnb = fp.tables(n, x.device)
    _build.check(_lib().lsp_fdl_fused(
        *(_build.ptr(t) for t in args), _build.ptr(y), _build.ptr(wst),
        _build.ptr(wnb), lm, p_n, int(w), c_n, _build.stream_of(x)),
        "fdl_fused kernel")
    fdl_fused.launches += 1
    return y


fdl_fused.launches = 0
