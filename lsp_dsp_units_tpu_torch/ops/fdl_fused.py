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
``<wrapper>.launches``, and returns the ring it wrote beside its
outputs.  Both kernels run two blocks per channel as a cluster
(:func:`eqfdl_launch_shape`, :func:`fdl_launch_shape`) and take frame
sizes 128 <= N <= 32768.  Unlike the JAX functions, the IR spectra come
unrotated with the slot index ``w`` (the kernels index ``H[(w - p) % P]``
themselves), and the G/M/W products are part of :func:`eqfdl_fused`, so
that on the card no library matmul (and no global TF32 setting) touches
them.

Gradients: under autograd (grad mode on, an input that requires grad)
each wrapper runs as a ``torch.autograd.Function`` that writes a new
ring instead of the caller's: a ring saved for one block's backward must
not be overwritten by the next block's slot write (at full width that is
a copy of ~25 MB a block; without grad the ring stays in place).  The
backward is the contract's adjoint in reverse order: the last-half
inverse's (the zero-pad forward transform of the output's cotangent,
weighted, odd bins negated), the MAC's (ops/ring_mac.py::
ring_mac_bwd_plain), the frame transform's (the inverse, weighted N and
N / 2: its first half is the history's cotangent, its second the
frame input's), and for :func:`eqfdl_fused` the EQ's (the first-half
inverse's adjoint, the products with Heq, g_mat, m_mat and w_mat).  For
CPU tensors the plain backwards (``*_bwd_plain``); for CUDA tensors
:func:`fdl_fused_bwd` and :func:`eqfdl_fused_bwd`: y's cotangent's
transform on the packed FFT kernel (csrc/fft_packed.cu), and on
``csrc/fdl_fused.cu`` the MAC's adjoint (``fdl_bwd``), the frame's
transforms (``frame_bwd_kernel``: for the EQ route the inverse, the sum
with u's cotangent and that sum's zero-pad transform, in one cluster a
channel) and the EQ's adjoint (``eqfdl_bwd`` + ``eqfdl_bwd_sums``).
The two wide kernels split the
channels into at most four groups, a block each, the groups of a
position tile one thread block cluster: the products shared by all
channels (H, Heq, g_t, w_mat) are summed within a group in channel
order, then across the cluster in group order, and sv's cotangent from
each tile's partial sums in a fixed order, so a gradient is the same
from run to run, with no atomics and no library matmul.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.ops import fft_packed as fp
from lsp_dsp_units_tpu_torch.ops.ring_mac import (ring_mac_bwd_plain,
                                                  ring_mac_plain)

_SIGS = {"lsp_eqfdl_fused": [ctypes.c_void_p] * 19 + [ctypes.c_int] * 5
         + [ctypes.c_void_p],
         "lsp_fdl_fused": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
         + [ctypes.c_void_p],
         "lsp_fdl_bwd": [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4
         + [ctypes.c_void_p],
         "lsp_eqfdl_bwd": [ctypes.c_void_p] * 23 + [ctypes.c_int] * 3
         + [ctypes.c_void_p],
         "lsp_eqfdl_bwd_tiles": [ctypes.c_int],
         "lsp_frame_bwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
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

    ``ring_*`` [P, C, B] packed ring, written at slot ``w``; ``h_*`` [P,
    B] packed IR partitions; ``heq_*`` [B] packed EQ spectrum; ``xs_*``
    [C, B] packed spectrum of ``x || 0``; ``x``, ``hist`` [C, B]; ``sv``
    [C, 2K]; ``g_t`` [2K, B], ``m_mat`` [2K, 2K], ``w_mat`` [2K, B].
    Returns (y [C, B], u [C, B], sv' [C, 2K], ring_re', ring_im'): the
    ring given, updated in place, or under autograd a new one.
    Differentiable in every tensor argument."""
    args = (ring_re, ring_im, h_re, h_im, heq_re, heq_im, xs_re, xs_im, x,
            sv, g_t, m_mat, w_mat, hist)
    if _build.needs_grad(*args):
        return _EqFdlFused.apply(*args, w)
    return _eqfdl_fused(*args, w) + (ring_re, ring_im)


def _eqfdl_fused(ring_re, ring_im, h_re, h_im, heq_re, heq_im, xs_re, xs_im,
                 x, sv, g_t, m_mat, w_mat, hist, w: int):
    """:func:`eqfdl_fused` outside autograd, the ring in place: the plain
    version for CPU tensors, the kernel for CUDA tensors."""
    args = (ring_re, ring_im, h_re, h_im, heq_re, heq_im, xs_re, xs_im, x,
            sv, g_t, m_mat, w_mat, hist)
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


def fdl_fused(ring_re, ring_im, h_re, h_im, hist, x, w: int):
    """One convolver block over a packed ring.

    ``ring_*`` [P, C, B] packed ring, written at slot ``w``; ``h_*`` [P,
    B] packed IR partitions (unrotated); ``hist``, ``x`` [C, B], the
    overlap-save frame ``[hist || x]``.  Returns (y [C, B], the last half
    of the frame's convolution, ring_re', ring_im'): the ring given,
    updated in place, or under autograd a new one.  Differentiable in
    every tensor argument."""
    args = (ring_re, ring_im, h_re, h_im, hist, x)
    if _build.needs_grad(*args):
        return _FdlFused.apply(*args, w)
    return _fdl_fused(*args, w), ring_re, ring_im


def _fdl_fused(ring_re, ring_im, h_re, h_im, hist, x, w: int) -> torch.Tensor:
    """:func:`fdl_fused` outside autograd, the ring in place."""
    args = (ring_re, ring_im, h_re, h_im, hist, x)
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


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def fdl_fused_bwd_plain(ring_re, ring_im, h_re, h_im, w: int, g_y, g_ring_re,
                        g_ring_im):
    """Plain PyTorch version of :func:`fdl_fused_bwd`."""
    n = 2 * g_y.shape[-1]
    g_re, g_im = fp.irfft_packed_bwd_plain(g_y, n, "last")
    gr, gi, gh_re, gh_im, gs_re, gs_im = ring_mac_bwd_plain(
        ring_re, ring_im, h_re, h_im, g_re, g_im, g_ring_re, g_ring_im, w,
        packed_dc=True)
    return (gr, gi, gh_re, gh_im) + frame_bwd_plain(
        *fp._rfft_adjoint_in(gs_re, gs_im, n), n)


def frame_bwd_plain(gs_re, gs_im, n: int, g_u=None):
    """Plain PyTorch version of :func:`frame_bwd`."""
    g_frame = fp.irfft_packed_plain(gs_re, gs_im, n)
    b = n // 2
    g_hist = g_frame[..., :b].contiguous()
    if g_u is None:
        return g_hist, g_frame[..., b:].contiguous()
    g_ut = g_frame[..., b:] + g_u
    return (g_hist, g_ut) + fp.rfft_packed_zeropad_plain(g_ut)


def frame_bwd(gs_re, gs_im, n: int, g_u=None):
    """The frame's transforms in the convolver backwards, from S's
    cotangent ``gs_*`` [C, N/2] as ``fdl_bwd`` writes it (packed, already
    weighted N at position 0 and N / 2 elsewhere: the frame transform's
    adjoint weights): its inverse, whose first half is hist's cotangent
    and its last the frame input's.  Without ``g_u`` returns (g_hist,
    g_x), :func:`fdl_fused_bwd`'s; with u's own cotangent ``g_u`` [C,
    N/2] (:func:`eqfdl_fused_bwd`'s) returns (g_hist, g_ut, gp_re,
    gp_im): g_ut = the last half + g_u, and gp its zero-pad forward
    transform (unweighted).  The plain version for CPU tensors; for CUDA
    tensors one launch of ``frame_bwd_kernel`` (a two-block cluster a
    channel, the frame in shared memory from one transform to the
    other), counted in ``frame_bwd.launches``."""
    ins = (gs_re, gs_im) + (() if g_u is None else (g_u,))
    if _build.is_cpu(*ins):
        return frame_bwd_plain(gs_re, gs_im, n, g_u)
    ins = tuple(fp._aligned(t) for t in ins)
    c_n = ins[0].shape[0]
    _build.check_cuda_f32(**_build.check_shapes(ins, {
        k: (c_n, n // 2) for k in ("gs_re", "gs_im", "g_u")[:len(ins)]}))
    outs = tuple(torch.empty_like(ins[0])
                 for _ in range(2 if g_u is None else 4))
    null = ctypes.c_void_p(None)
    g_u_p, gp_p = ((null, (null, null)) if g_u is None else
                   (_build.ptr(ins[2]), tuple(map(_build.ptr, outs[2:]))))
    wst, wnb = fp.tables(n, ins[0].device)
    _build.check(_lib().lsp_frame_bwd(
        _build.ptr(ins[0]), _build.ptr(ins[1]), g_u_p, _build.ptr(outs[0]),
        _build.ptr(outs[1]), *gp_p, _build.ptr(wst), _build.ptr(wnb),
        fp.log2_m(n), c_n, _build.stream_of(ins[0])), "frame_bwd kernel")
    frame_bwd.launches += 1
    return outs


frame_bwd.launches = 0


def _fdl_bwd_launch(ring_re, ring_im, h_re, h_im, w: int, g_y, g_ring_re,
                    g_ring_im, counter):
    """The MAC's adjoint on the card: the zero-pad forward transform of
    g_y (kernel #1) and ``fdl_bwd``.  Returns (g_ring_re, g_ring_im,
    g_h_re, g_h_im, gs_re, gs_im): S's cotangent ``gs`` [C, N/2] already
    carries the frame transform's adjoint weights."""
    p_n, c_n, b = ring_re.shape
    n = 2 * b
    g_y = fp._aligned(g_y)
    g_ring_re, g_ring_im = fp._aligned(g_ring_re), fp._aligned(g_ring_im)
    _check((ring_re, ring_im, h_re, h_im, g_y, g_ring_re, g_ring_im),
           dict(ring_re=(p_n, c_n, b), ring_im=(p_n, c_n, b), h_re=(p_n, b),
                h_im=(p_n, b), g_y=(c_n, b), g_ring_re=(p_n, c_n, b),
                g_ring_im=(p_n, c_n, b)), w)
    ga_re, ga_im = fp._rfft_launch(g_y, n, 1)
    gr, gi = torch.empty_like(ring_re), torch.empty_like(ring_im)
    gh_re, gh_im = torch.empty_like(h_re), torch.empty_like(h_im)
    gs_re, gs_im = torch.empty_like(g_y), torch.empty_like(g_y)
    _build.check(_lib().lsp_fdl_bwd(
        *(_build.ptr(t) for t in (ring_re, ring_im, h_re, h_im, ga_re, ga_im,
                                  g_ring_re, g_ring_im, gr, gi, gh_re, gh_im,
                                  gs_re, gs_im)),
        fp.log2_m(n), p_n, int(w), c_n, _build.stream_of(g_y)),
        "fdl_bwd kernel")
    counter.fft_launches += 1
    return gr, gi, gh_re, gh_im, gs_re, gs_im


def fdl_fused_bwd(ring_re, ring_im, h_re, h_im, w: int, g_y, g_ring_re,
                  g_ring_im):
    """Backward of :func:`fdl_fused`: ``ring_*`` the ring it wrote (slot
    w holding S), ``g_y`` and ``g_ring_*`` the cotangents of y and of
    that ring.  Returns the cotangents (g_ring_re, g_ring_im of the
    incoming ring, g_h_re, g_h_im, g_hist, g_x).  The plain version for
    CPU tensors; for CUDA tensors three launches: kernel #1's zero-pad
    forward transform, ``fdl_bwd`` (a cluster of channel groups a
    position tile and partition) and the frame's inverse
    (:func:`frame_bwd`, writing g_hist and g_x apart), counted once in
    ``fdl_fused_bwd.launches`` (the two transforms also in
    ``fdl_fused_bwd.fft_launches``)."""
    if _build.is_cpu(ring_re, ring_im, h_re, h_im, g_y, g_ring_re,
                     g_ring_im):
        return fdl_fused_bwd_plain(ring_re, ring_im, h_re, h_im, w, g_y,
                                   g_ring_re, g_ring_im)
    gr, gi, gh_re, gh_im, gs_re, gs_im = _fdl_bwd_launch(
        ring_re, ring_im, h_re, h_im, w, g_y, g_ring_re, g_ring_im,
        fdl_fused_bwd)
    g_hist, g_x = frame_bwd(gs_re, gs_im, 2 * g_y.shape[-1])
    fdl_fused_bwd.fft_launches += 1
    fdl_fused_bwd.launches += 1
    return gr, gi, gh_re, gh_im, g_hist, g_x


def eqfdl_fused_bwd_plain(ring_re, ring_im, h_re, h_im, heq_re, heq_im,
                          xs_re, xs_im, x, sv, g_t, m_mat, w_mat, w: int, g_y,
                          g_u, g_sv2, g_ring_re, g_ring_im):
    """Plain PyTorch version of :func:`eqfdl_fused_bwd`."""
    n = 2 * x.shape[-1]
    gr, gi, gh_re, gh_im, g_hist, g_frame_u = fdl_fused_bwd_plain(
        ring_re, ring_im, h_re, h_im, w, g_y, g_ring_re, g_ring_im)
    g_ut = g_frame_u + g_u
    g_pr, g_pi = fp.irfft_packed_bwd_plain(g_ut, n, "first")
    g_xs_re, g_xs_im = fp.mul_conj_packed(g_pr, g_pi, heq_re, heq_im)
    g_heq_re, g_heq_im = fp.mul_conj_packed(g_pr, g_pi, xs_re, xs_im)
    g_sv = g_ut @ g_t.T + g_sv2 @ m_mat
    return (gr, gi, gh_re, gh_im, g_heq_re.sum(dim=0), g_heq_im.sum(dim=0),
            g_xs_re, g_xs_im, g_sv2 @ w_mat, g_sv, sv.T @ g_ut,
            g_sv2.T @ sv, g_sv2.T @ x, g_hist)


def eqfdl_fused_bwd(ring_re, ring_im, h_re, h_im, heq_re, heq_im, xs_re,
                    xs_im, x, sv, g_t, m_mat, w_mat, w: int, g_y, g_u, g_sv2,
                    g_ring_re, g_ring_im):
    """Backward of :func:`eqfdl_fused`: ``ring_*`` the ring it wrote,
    the other tensors its inputs, ``g_*`` the cotangents of y, u, sv'
    and the ring.  Returns the cotangents of (ring_re, ring_im, h_re,
    h_im, heq_re, heq_im, xs_re, xs_im, x, sv, g_t, m_mat, w_mat, hist).
    The plain version for CPU tensors; for CUDA tensors kernel #1's
    zero-pad forward transform of y's cotangent, ``fdl_bwd``, the frame's
    transforms in one launch (:func:`frame_bwd`: the inverse, the sum of
    the frame's cotangent with u's, and that sum's zero-pad forward
    transform) and the EQ's adjoint, two kernels of one C call:
    ``eqfdl_bwd`` (a cluster of channel groups a position tile: every
    cotangent but sv's and m_mat's, and sv's partial sums over each tile
    into a scratch) and ``eqfdl_bwd_sums`` (sv's and m_mat's), counted
    once in ``eqfdl_fused_bwd.launches`` (the two transforms' launches in
    ``eqfdl_fused_bwd.fft_launches``)."""
    ins = (ring_re, ring_im, h_re, h_im, heq_re, heq_im, xs_re, xs_im, x,
           sv, g_t, m_mat, w_mat, g_y, g_u, g_sv2, g_ring_re, g_ring_im)
    if _build.is_cpu(*ins):
        return eqfdl_fused_bwd_plain(*ins[:13], w, *ins[13:])
    p_n, c_n, b = ring_re.shape
    k2 = m_mat.shape[0]
    n = 2 * b
    gr, gi, gh_re, gh_im, gs_re, gs_im = _fdl_bwd_launch(
        ring_re, ring_im, h_re, h_im, w, g_y, g_ring_re, g_ring_im,
        eqfdl_fused_bwd)
    g_hist, g_ut, gp_re, gp_im = frame_bwd(gs_re, gs_im, n, g_u)
    eqfdl_fused_bwd.fft_launches += 1
    g_sv2 = g_sv2.contiguous()
    _build.check_cuda_f32(**_build.check_shapes(
        (heq_re, heq_im, xs_re, xs_im, x, sv, g_t, m_mat, w_mat, g_sv2),
        dict(heq_re=(b,), heq_im=(b,), xs_re=(c_n, b), xs_im=(c_n, b),
             x=(c_n, b), sv=(c_n, k2), g_t=(k2, b), m_mat=(k2, k2),
             w_mat=(k2, b), g_sv2=(c_n, k2))))
    g_xs_re, g_xs_im = torch.empty_like(xs_re), torch.empty_like(xs_im)
    g_heq_re, g_heq_im = torch.empty_like(heq_re), torch.empty_like(heq_im)
    g_gt, g_m, g_w = (torch.empty_like(g_t), torch.empty_like(m_mat),
                      torch.empty_like(w_mat))
    g_sv, g_x = torch.empty_like(sv), torch.empty_like(x)
    tiles = _lib().lsp_eqfdl_bwd_tiles(fp.log2_m(n))
    part_sv = torch.empty((tiles, c_n, k2), dtype=x.dtype, device=x.device)
    _build.check(_lib().lsp_eqfdl_bwd(
        *(_build.ptr(t) for t in (gp_re, gp_im, g_ut, heq_re, heq_im, xs_re,
                                  xs_im, x, sv, g_t, m_mat, w_mat, g_sv2,
                                  g_xs_re, g_xs_im, g_heq_re, g_heq_im, g_gt,
                                  g_m, g_w, g_sv, g_x, part_sv)),
        fp.log2_m(n), c_n, k2, _build.stream_of(x)),
        "eqfdl_bwd kernel")
    eqfdl_fused_bwd.launches += 1
    return (gr, gi, gh_re, gh_im, g_heq_re, g_heq_im, g_xs_re, g_xs_im, g_x,
            g_sv, g_gt, g_m, g_w, g_hist)


fdl_fused_bwd.launches = 0
fdl_fused_bwd.fft_launches = 0
eqfdl_fused_bwd.launches = 0
eqfdl_fused_bwd.fft_launches = 0


def _new_ring(ring_re, ring_im):
    """The ring a Function writes: a copy of the caller's."""
    return ring_re.clone(), ring_im.clone()


class _EqFdlFused(torch.autograd.Function):
    """:func:`eqfdl_fused` under autograd: the forward writes a new ring,
    the backward is :func:`eqfdl_fused_bwd`."""

    @staticmethod
    def forward(ctx, ring_re, ring_im, h_re, h_im, heq_re, heq_im, xs_re,
                xs_im, x, sv, g_t, m_mat, w_mat, hist, w):
        r_re, r_im = _new_ring(ring_re, ring_im)
        y, u, sv2 = _eqfdl_fused(r_re, r_im, h_re, h_im, heq_re, heq_im,
                                 xs_re, xs_im, x, sv, g_t, m_mat, w_mat,
                                 hist, w)
        ctx.save_for_backward(r_re, r_im, h_re, h_im, heq_re, heq_im, xs_re,
                              xs_im, x, sv, g_t, m_mat, w_mat)
        ctx.w = w
        return y, u, sv2, r_re, r_im

    @staticmethod
    @once_differentiable
    def backward(ctx, g_y, g_u, g_sv2, g_ring_re, g_ring_im):
        return eqfdl_fused_bwd(*ctx.saved_tensors, ctx.w, g_y, g_u, g_sv2,
                               g_ring_re, g_ring_im) + (None,)


class _FdlFused(torch.autograd.Function):
    """:func:`fdl_fused` under autograd: the forward writes a new ring,
    the backward is :func:`fdl_fused_bwd`."""

    @staticmethod
    def forward(ctx, ring_re, ring_im, h_re, h_im, hist, x, w):
        r_re, r_im = _new_ring(ring_re, ring_im)
        y = _fdl_fused(r_re, r_im, h_re, h_im, hist, x, w)
        ctx.save_for_backward(r_re, r_im, h_re, h_im)
        ctx.w = w
        return y, r_re, r_im

    @staticmethod
    @once_differentiable
    def backward(ctx, g_y, g_ring_re, g_ring_im):
        return fdl_fused_bwd(*ctx.saved_tensors, ctx.w, g_y, g_ring_re,
                             g_ring_im) + (None,)
