"""Biquad cascades: the port of ops/biquad.py.

Coefficient convention (the JAX module's, feedback signs pre-negated)::

    y[n] = b0*x[n] + b1*x[n-1] + b2*x[n-2] + a1*y[n-1] + a2*y[n-2]

A cascade is ``coeffs[K, 5] = (b0, b1, b2, a1, a2)`` per stage, run in
series over the direct-form-II-transposed (DF2T) state ``[..., K, 2]``::

    y[n]  = b0*x[n] + s1[n-1]
    s1[n] = b1*x[n] + a1*y[n] + s2[n-1]
    s2[n] = b2*x[n] + a2*y[n]

Coefficients come shared (``[K, 5]``), per batch (``[..., K, 5]``,
broadcast against the input's leading axes) or, for the ``dyn_`` forms,
per sample (``[..., T, K, 5]``).  An empty block (T = 0) and an empty
cascade (K = 0) return the input and the state unchanged.

Two forms, as in the JAX package:

* **Time-parallel** (:func:`biquad_cascade`, :func:`dyn_biquad_cascade`):
  the state recurrence ``s[n] = A s[n-1] + u x[n]`` as an associative
  scan of affine maps.  :func:`_associative_scan` repeats
  ``jax.lax.associative_scan``'s own odd/even recursion (pair-reduce,
  recurse on the reduced half, combine back, interleave), so the two
  packages combine the same elements in the same tree.
  :func:`biquad_cascade` runs its plain version
  (:func:`biquad_cascade_plain`) for CPU tensors and launches
  ``csrc/biquad_scan.cu`` for CUDA tensors (all K stages in one pass
  over the rows, a warp per tile of 128, a row split over a cluster of
  blocks; with coefficients shared by the rows, a first launch computes
  the stages' prefix matrices once for all of them; every launch counted
  in ``biquad_cascade.launches``), which evaluates the same tree as a
  hierarchy of tiles, every product and sum rounded once, so the two
  agree bit for bit.  The per-sample form
  :func:`dyn_biquad_cascade` stays plain PyTorch on both devices.
  Under autograd :func:`biquad_cascade` runs as a
  ``torch.autograd.Function`` whose backward (:func:`biquad_cascade_bwd`)
  is the recursion's adjoint on the same route (the plain scan for CPU
  tensors, the kernel for CUDA tensors, counted in
  ``biquad_cascade.bwd_launches``); :func:`dyn_biquad_cascade`
  differentiates through its plain operations.
* **Sequential** (:func:`biquad_cascade_seq`,
  :func:`dyn_biquad_cascade_seq`): the exact per-sample DF2T order, the
  card's counterpart of the JAX package's ``lax.scan``.  For CPU tensors
  they run their plain versions (:func:`biquad_cascade_seq_plain`,
  :func:`dyn_biquad_cascade_seq_plain`, a Python loop over samples); for
  CUDA tensors they launch ``csrc/biquad.cu`` (a block per row, its
  chain warp's lane k running stage k on chunks of 128 samples, the
  stages pipelined a chunk apart through shared memory; up to 32 stages
  a launch), counting launches in ``biquad_cascade_seq.launches`` (the
  per-sample form's also in ``dyn_biquad_cascade_seq.launches``).  The
  kernel rounds every product and sum once in the plain loop's order,
  so the two agree bit for bit.
  Under autograd they run as ``_SeqCascade``, whose forward (the saving
  form of the same loop or kernel) also keeps each stage's signal where
  the coefficients want a gradient, and whose backward
  (:func:`biquad_cascade_seq_bwd`, :func:`dyn_biquad_cascade_seq_bwd`)
  is the reverse-time transpose of the DF2T step: the plain loop for CPU
  tensors, ``csrc/biquad_bwd.cu`` for CUDA tensors, bit for bit the same.
"""

from __future__ import annotations

import ctypes
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.ops.env_units import _mul_add

LANES = 32          # stages per kernel launch (csrc/biquad.cu kLanes)

_SIGS = {"lsp_biquad_seq": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
         + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p],
         "lsp_biquad_seq_save": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
         + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]}
_BWD_SIGS = {"lsp_biquad_seq_bwd": [ctypes.c_void_p] * 8
             + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2
             + [ctypes.c_int] * 2 + [ctypes.c_void_p],
             "lsp_biquad_seq_bwd_sums": [ctypes.c_void_p] * 2
             + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p],
             "lsp_biquad_seq_bwd_chain_ops": []}
_SCAN_SIGS = {"lsp_biquad_scan": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
              + [ctypes.c_longlong, ctypes.c_void_p],
              "lsp_biquad_scan_table": [ctypes.c_void_p] * 2
              + [ctypes.c_int] * 3 + [ctypes.c_void_p],
              "lsp_biquad_scan_scratch": [ctypes.c_int] * 3
              + [ctypes.c_longlong, ctypes.c_void_p]}


def init_state(num_stages: int, batch_shape: Tuple[int, ...] = (),
               dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Zero DF2T state: shape ``batch_shape + (num_stages, 2)``."""
    return torch.zeros(tuple(batch_shape) + (num_stages, 2), dtype=dtype,
                       device=device)


def _affine_combine(elem1, elem2):
    """Compose affine maps s -> A s + v:  (A2, v2) o (A1, v1)."""
    (a00_1, a01_1, a10_1, a11_1), (v0_1, v1_1) = elem1
    (a00_2, a01_2, a10_2, a11_2), (v0_2, v1_2) = elem2
    a00 = a00_2 * a00_1 + a01_2 * a10_1
    a01 = a00_2 * a01_1 + a01_2 * a11_1
    a10 = a10_2 * a00_1 + a11_2 * a10_1
    a11 = a10_2 * a01_1 + a11_2 * a11_1
    v0 = a00_2 * v0_1 + a01_2 * v1_1 + v0_2
    v1 = a10_2 * v0_1 + a11_2 * v1_1 + v1_2
    return (a00, a01, a10, a11), (v0, v1)


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` at the even and ``b`` at the odd positions of the last
    axis (``a`` as long as ``b`` or one longer)."""
    out = a.new_empty(a.shape[:-1] + (a.shape[-1] + b.shape[-1],))
    out[..., 0::2] = a
    out[..., 1::2] = b
    return out


def _associative_scan(fn: Callable, elems: Sequence[torch.Tensor],
                      ) -> List[torch.Tensor]:
    """Inclusive scan of ``fn`` over the last axis of the flat list
    ``elems``, by ``jax.lax.associative_scan``'s recursion: combine
    adjacent pairs, scan the half-length result (the odd positions),
    combine each with the next even element (the even positions),
    interleave.  ``fn`` takes and returns flat lists."""
    n = elems[0].shape[-1]
    if n < 2:
        return list(elems)
    reduced = fn([e[..., 0:-1:2] for e in elems],
                 [e[..., 1::2] for e in elems])
    odd = _associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn([e[..., :-1] for e in odd], [e[..., 2::2] for e in elems])
    else:
        even = fn(odd, [e[..., 2::2] for e in elems])
    even = [torch.cat([e[..., :1], r], dim=-1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _combine_flat(a, b):
    (a_mat, a_v) = (a[:4], a[4:])
    (b_mat, b_v) = (b[:4], b[4:])
    mat, v = _affine_combine((a_mat, a_v), (b_mat, b_v))
    return [*mat, *v]


def stage_prefix(x: torch.Tensor, b0, b1, b2, a1, a2):
    """Prefix affine maps of one biquad stage over the last (time) axis.

    Returns ``(A_scan, v_scan)``: ``A_scan`` a 4-tuple of [..., T]
    tensors (the 2x2 prefix matrix products), ``v_scan`` a 2-tuple (the
    zero-state responses), such that the DF2T state after sample n is
    ``s[n] = A_scan[n] @ s_in + v_scan[n]`` for any incoming state."""
    u0 = b1 + a1 * b0
    u1 = b2 + a2 * b0
    ones = torch.ones_like(x)
    flat = [a1 * ones, ones, a2 * ones, torch.zeros_like(x), u0 * x, u1 * x]
    out = _associative_scan(_combine_flat, flat)
    return tuple(out[:4]), tuple(out[4:])


def stage_apply(x: torch.Tensor, b0, a_scan, v_scan, s_in: torch.Tensor,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complete one stage given its prefix maps and the incoming state
    ``s_in`` [..., 2]: returns (y [..., T], s_out [..., 2])."""
    s1_in = s_in[..., 0:1]
    s2_in = s_in[..., 1:2]
    s1 = a_scan[0] * s1_in + a_scan[1] * s2_in + v_scan[0]
    s2 = a_scan[2] * s1_in + a_scan[3] * s2_in + v_scan[1]
    # y[n] = b0 x[n] + s1[n-1]; s1 shifted right by one, s_in first
    s1_prev = torch.cat([s1_in.expand(s1.shape[:-1] + (1,)), s1[..., :-1]],
                        dim=-1)
    y = b0 * x + s1_prev
    s_out = torch.stack([s1[..., -1], s2[..., -1]], dim=-1)
    return y, s_out


def _stage_assoc(x, b0, b1, b2, a1, a2, s_in):
    a_scan, v_scan = stage_prefix(x, b0, b1, b2, a1, a2)
    return stage_apply(x, b0, a_scan, v_scan, s_in)


def _split_coeffs(c: torch.Tensor):
    """[..., 5] coefficients -> broadcastable (b0, b1, b2, a1, a2)."""
    if c.ndim == 1:
        return c[0], c[1], c[2], c[3], c[4]
    return (c[..., 0:1], c[..., 1:2], c[..., 2:3], c[..., 3:4], c[..., 4:5])


def _empty(coeffs: torch.Tensor, x: torch.Tensor) -> bool:
    return x.shape[-1] == 0 or coeffs.shape[-2] == 0


def biquad_cascade_plain(coeffs: torch.Tensor, state: torch.Tensor,
                         x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`biquad_cascade`: the associative
    scan stage after stage, on any device."""
    if _empty(coeffs, x):
        return x, state
    y = x
    new_states = []
    for i in range(coeffs.shape[-2]):
        b0, b1, b2, a1, a2 = _split_coeffs(coeffs[..., i, :])
        y, s = _stage_assoc(y, b0, b1, b2, a1, a2, state[..., i, :])
        new_states.append(s)
    return y, torch.stack(new_states, dim=-2)


def _batch_rows(coeffs: torch.Tensor, state: torch.Tensor, x: torch.Tensor,
                c_tail: int):
    """The common batch shape of a cascade's inputs, made contiguous at
    it: ``(batch, x [rows, T], state [rows, K, 2], coeffs, row_stride)``;
    coefficients shared by every row keep their one copy and a row
    stride of 0."""
    t_n, k_n = x.shape[-1], coeffs.shape[-2]
    if coeffs.shape[-1] != 5 or state.shape[-2:] != (k_n, 2):
        raise ValueError(f"coefficients {tuple(coeffs.shape)} and state "
                         f"{tuple(state.shape)} do not form a cascade")
    c_batch = coeffs.shape[:-c_tail]
    batch = torch.broadcast_shapes(x.shape[:-1], state.shape[:-2], c_batch)
    xr = x.expand(batch + (t_n,)).contiguous()
    st = state.expand(batch + (k_n, 2)).contiguous()
    if all(d == 1 for d in c_batch):
        return batch, xr, st, coeffs.contiguous(), 0
    cr = coeffs.expand(batch + coeffs.shape[-c_tail:]).contiguous()
    return batch, xr, st, cr, int(np.prod(cr.shape[-c_tail:]))


def _scan_launch(coeffs: torch.Tensor, state: torch.Tensor, x: torch.Tensor,
                 counter: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/biquad_scan.cu``, each launch counted in
    ``biquad_cascade.<counter>``: with coefficients shared by the rows its
    table of the stages' prefix matrices, then the rows (two launches);
    with per-row coefficients the rows alone (one)."""
    t_n, k_n = x.shape[-1], coeffs.shape[-2]
    batch, xr, st, cr, row_stride = _batch_rows(coeffs, state, x, 2)
    _build.check_cuda(torch.float32, x.device, x=xr, state=st, coeffs=cr)
    rows = int(np.prod(batch, dtype=np.int64))
    lib = _build.load("biquad_scan", _SCAN_SIGS)
    floats = ctypes.c_longlong(0)
    _build.check(lib.lsp_biquad_scan_scratch(rows, t_n, k_n, row_stride,
                                             ctypes.byref(floats)),
                 "biquad_scan scratch")
    y = torch.empty_like(xr)
    st_out = torch.empty_like(st)
    scratch = xr.new_empty(max(floats.value, 1))
    stream = _build.stream_of(xr)
    if row_stride == 0:
        _build.check(lib.lsp_biquad_scan_table(
            _build.ptr(cr), _build.ptr(scratch), rows, t_n, k_n, stream),
            "biquad_scan table kernel")
        setattr(biquad_cascade, counter, getattr(biquad_cascade, counter) + 1)
    _build.check(lib.lsp_biquad_scan(
        _build.ptr(xr), _build.ptr(cr), _build.ptr(st), _build.ptr(y),
        _build.ptr(st_out), _build.ptr(scratch), rows, t_n, k_n, row_stride,
        stream), "biquad_scan kernel")
    setattr(biquad_cascade, counter, getattr(biquad_cascade, counter) + 1)
    return y, st_out


def _cascade(coeffs, state, x):
    """:func:`biquad_cascade` outside autograd on a non-empty cascade:
    the plain scan for CPU tensors, the kernel for CUDA tensors."""
    if _build.is_cpu(coeffs, state, x):
        return biquad_cascade_plain(coeffs, state, x)
    return _scan_launch(coeffs, state, x, "launches")


def biquad_cascade(coeffs: torch.Tensor, state: torch.Tensor,
                   x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serial biquad cascade over the last (time) axis, time-parallel.

    ``coeffs`` [K, 5] or [..., K, 5]; ``state`` [..., K, 2]; ``x``
    [..., T].  Returns ``(y [..., T], new_state [..., K, 2])``; stage k
    filters the whole block before stage k+1 (LTI, so the same result as
    per-sample ordering).  CPU tensors run :func:`biquad_cascade_plain`,
    CUDA tensors the kernel, bit for bit the same.  Differentiable in
    all three (:func:`biquad_cascade_bwd`)."""
    if _empty(coeffs, x):
        return x, state
    if _build.needs_grad(coeffs, state, x):
        return _Cascade.apply(coeffs, state, x)
    return _cascade(coeffs, state, x)


def _scan_bwd_launch(coeffs, state, x):
    """One scan of the backward on the card, its launches counted in
    ``biquad_cascade.bwd_launches``."""
    return _scan_launch(coeffs, state, x, "bwd_launches")


def _cascade_adjoint(scan, coeffs, state, x, y, g_y, g_state, want_coeffs):
    """The adjoint of :func:`biquad_cascade` on the scans ``scan``.

    Per stage (``y[n] = b0 u[n] + b1 u[n-1] + b2 u[n-2] + a1 y[n-1] + a2
    y[n-2]``, the JAX convention of :func:`_split_coeffs`, feedback signs
    pre-negated), the adjoint lam is the all-pole part run in reverse
    time, ``lam[n] = g[n] + a1 lam[n+1] + a2 lam[n+2]``, started from the
    final state's cotangent (lam[T] = g_s1, lam[T+1] = g_s2): the same
    scan with b = (1, 0, 0) on the flipped cotangent, from the state
    ``(a1 g_s1 + a2 g_s2, a2 g_s1)``.  Then ``g_b_k = sum lam[n] u[n-k]``,
    ``g_a_k = sum lam[n+k] y[n]``, ``g_u[n] = b0 lam[n] + b1 lam[n+1] +
    b2 lam[n+2]`` (the next stage back's cotangent) and the stage's
    incoming state takes (lam[0], lam[1]).  The stages' inputs come from
    running the scan one stage at a time (K - 1 scans, only when the
    coefficients want a gradient); the sums over time are torch
    reductions."""
    k_n = coeffs.shape[-2]
    g = g_y
    ins = [x]
    if want_coeffs:
        for k in range(k_n - 1):
            u, _ = scan(coeffs[..., k:k + 1, :], state[..., k:k + 1, :],
                        ins[-1])
            ins.append(u)
    g_coef, g_st = [None] * k_n, [None] * k_n
    c_batch = coeffs.shape[:-2]
    for k in reversed(range(k_n)):
        b0, b1, b2, a1, a2 = coeffs[..., k, :].unbind(-1)
        gs1, gs2 = g_state[..., k, 0], g_state[..., k, 1]
        one, zero = torch.ones_like(a1), torch.zeros_like(a1)
        c_rev = torch.stack([one, zero, zero, a1, a2], dim=-1)[..., None, :]
        s_rev = torch.stack([a1 * gs1 + a2 * gs2, a2 * gs1],
                            dim=-1)[..., None, :]
        r, _ = scan(c_rev, s_rev, torch.flip(g, dims=(-1,)))
        lam = torch.cat([torch.flip(r, dims=(-1,)), gs1[..., None]
                         .expand(r.shape[:-1] + (1,)), gs2[..., None]
                         .expand(r.shape[:-1] + (1,))], dim=-1)  # [..., T + 2]
        t_n = r.shape[-1]
        lam0, lam1, lam2 = (lam[..., :t_n], lam[..., 1:t_n + 1],
                            lam[..., 2:t_n + 2])
        g_st[k] = torch.stack([lam0[..., 0], lam1[..., 0]], dim=-1)
        if want_coeffs:
            u, out = ins[k], (ins[k + 1] if k + 1 < k_n else y)

            def total(v):
                return torch.sum(v, dim=-1).sum_to_size(c_batch)
            g_coef[k] = torch.stack(
                [total(lam0 * u), total(lam1 * u), total(lam2 * u),
                 total(lam1 * out), total(lam2 * out)], dim=-1)
        g = b0[..., None] * lam0 + b1[..., None] * lam1 \
            + b2[..., None] * lam2
    g_state_in = torch.stack(g_st, dim=-2).sum_to_size(state.shape)
    g_x = g.sum_to_size(x.shape)
    g_c = torch.stack(g_coef, dim=-2) if want_coeffs else None
    return g_c, g_state_in, g_x


def biquad_cascade_bwd_plain(coeffs, state, x, y, g_y, g_state,
                             want_coeffs=True):
    """Plain PyTorch version of :func:`biquad_cascade_bwd`: the same
    adjoint on :func:`biquad_cascade_plain`'s scans, on any device."""
    return _cascade_adjoint(biquad_cascade_plain, coeffs, state, x, y, g_y,
                            g_state, want_coeffs)


def biquad_cascade_bwd(coeffs, state, x, y, g_y, g_state, want_coeffs=True):
    """Backward of :func:`biquad_cascade`: the cotangents of (y, state')
    -> those of (coeffs, state, x), ``y`` the forward's output
    (``want_coeffs`` False skips the coefficients').  The plain version
    for CPU tensors; for CUDA tensors the adjoint of
    :func:`_cascade_adjoint` on the scan kernel: 2K - 1 scans (K
    without the coefficients), two launches each where the coefficients
    are shared by the rows, each bit for bit its plain scan."""
    if _build.is_cpu(coeffs, state, x, y, g_y, g_state):
        return biquad_cascade_bwd_plain(coeffs, state, x, y, g_y, g_state,
                                        want_coeffs)
    return _cascade_adjoint(_scan_bwd_launch, coeffs, state, x, y, g_y,
                            g_state, want_coeffs)


class _Cascade(torch.autograd.Function):
    """:func:`biquad_cascade` under autograd."""

    @staticmethod
    def forward(ctx, coeffs, state, x):
        y, s_out = _cascade(coeffs, state, x)
        ctx.save_for_backward(coeffs, state, x, y)
        return y, s_out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_y, g_state):
        coeffs, state, x, y = ctx.saved_tensors
        g_c, g_s, g_x = biquad_cascade_bwd(coeffs, state, x, y, g_y, g_state,
                                           ctx.needs_input_grad[0])
        return g_c, g_s, g_x


biquad_cascade.launches = 0
biquad_cascade.bwd_launches = 0


def dyn_biquad_cascade(coeffs: torch.Tensor, state: torch.Tensor,
                       x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample-varying cascade, time-parallel: ``coeffs`` [..., T, K,
    5], ``state`` [..., K, 2], ``x`` [..., T]."""
    if _empty(coeffs, x):
        return x, state
    y = x
    new_states = []
    for i in range(coeffs.shape[-2]):
        c = coeffs[..., i, :]                       # [..., T, 5]
        y, s = _stage_assoc(y, c[..., 0], c[..., 1], c[..., 2], c[..., 3],
                            c[..., 4], state[..., i, :])
        new_states.append(s)
    return y, torch.stack(new_states, dim=-2)


def _seq_plain(coeff_at: Callable[[int], torch.Tensor], k: int,
               state: torch.Tensor, x: torch.Tensor, outs=None):
    """The per-sample DF2T loop: stage after stage within each sample,
    every product and sum rounded on its own, ``(c1 y + c3 yi) + s2``.
    ``outs`` (a list of K empty lists) receives each stage's output a
    sample."""
    s1 = [state[..., i, 0] for i in range(k)]
    s2 = [state[..., i, 1] for i in range(k)]
    ys = []
    for t in range(x.shape[-1]):
        y = x[..., t]
        c = coeff_at(t)
        for i in range(k):
            ci = c[i]
            yi = ci[0] * y + s1[i]
            s1[i] = ci[1] * y + ci[3] * yi + s2[i]
            s2[i] = ci[2] * y + ci[4] * yi
            y = yi
            if outs is not None:
                outs[i].append(yi)
        ys.append(y)
    new_state = torch.stack(
        [torch.stack(torch.broadcast_tensors(a, b), dim=-1)
         for a, b in zip(s1, s2)], dim=-2)
    return torch.stack(ys, dim=-1), new_state


def _per_stage(c: torch.Tensor):
    """[..., K, 5] -> per stage, per coefficient [...] tensors."""
    return [c[..., i, :].unbind(-1) for i in range(c.shape[-2])]


def _seq_plain_run(coeffs, state, x, dyn: bool, save: bool = False):
    """The plain loop of either form; with ``save`` also the stage
    signals [K + 1, rows, T] (the input, then each stage's output) at the
    common batch shape, as the kernel's saving form writes them."""
    if dyn:
        per_t = coeffs.unbind(-3)

        def coeff_at(t):
            return _per_stage(per_t[t])
    else:
        stages = _per_stage(coeffs)

        def coeff_at(t):
            return stages
    k_n = coeffs.shape[-2]
    outs = [[] for _ in range(k_n)] if save else None
    y, st = _seq_plain(coeff_at, k_n, state, x, outs)
    if not save:
        return y, st
    sig = torch.stack([x.expand(y.shape)] + [
        torch.stack(torch.broadcast_tensors(*o), dim=-1).expand(y.shape)
        for o in outs]).reshape(k_n + 1, -1, x.shape[-1])
    return y, st, sig


def biquad_cascade_seq_plain(coeffs: torch.Tensor, state: torch.Tensor,
                             x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`biquad_cascade_seq`."""
    if _empty(coeffs, x):
        return x, state
    return _seq_plain_run(coeffs, state, x, dyn=False)


def dyn_biquad_cascade_seq_plain(coeffs: torch.Tensor, state: torch.Tensor,
                                 x: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`dyn_biquad_cascade_seq`."""
    if _empty(coeffs, x):
        return x, state
    return _seq_plain_run(coeffs, state, x, dyn=True)


def _seq_rows(coeffs, state, x, dyn: bool):
    """:func:`_batch_rows` of a sequential cascade, after checking that
    per-sample coefficients cover the input."""
    if dyn and coeffs.shape[-3] != x.shape[-1]:
        raise ValueError(f"per-sample coefficients cover {coeffs.shape[-3]}"
                         f" samples, the input {x.shape[-1]}")
    return _batch_rows(coeffs, state, x, 3 if dyn else 2)


def _seq_cuda(coeffs: torch.Tensor, state: torch.Tensor, x: torch.Tensor,
              dyn: bool, save: bool = False):
    """Launch ``csrc/biquad.cu`` once per group of up to 32 stages.
    Broadcast inputs are made contiguous at the common batch shape;
    coefficients shared by every row are read with a row stride of 0.
    With ``save`` the saving form also writes the stage signals [K + 1,
    rows, T], returned third."""
    t_n, k_n = x.shape[-1], coeffs.shape[-2]
    batch, xr, st, cr, row_stride = _seq_rows(coeffs, state, x, dyn)
    rows = int(np.prod(batch, dtype=np.int64))
    _build.check_cuda(torch.float32, x.device, x=xr, state=st, coeffs=cr)
    lib = _build.load("biquad", _SIGS)
    st_out = torch.empty_like(st)
    sig = None
    if save:
        sig = xr.new_empty((k_n + 1, rows, t_n))
        sig[0].copy_(xr.reshape(rows, t_n))
    src = xr
    for k0 in range(0, k_n, LANES):
        y = torch.empty_like(xr)
        common = (_build.ptr(src), _build.ptr(cr), _build.ptr(st),
                  _build.ptr(y), _build.ptr(st_out))
        tail = (rows, t_n, k_n, k0, min(LANES, k_n - k0), row_stride,
                k_n * 5 if dyn else 0, int(dyn), _build.stream_of(xr))
        if save:
            err = lib.lsp_biquad_seq_save(*common, _build.ptr(sig), *tail)
        else:
            err = lib.lsp_biquad_seq(*common, *tail)
        _build.check(err, "biquad_seq kernel")
        biquad_cascade_seq.launches += 1
        if dyn:
            dyn_biquad_cascade_seq.launches += 1
        src = y
    return (src, st_out, sig) if save else (src, st_out)


def _seq(coeffs, state, x, dyn: bool, save: bool = False):
    """Either form outside autograd: the plain loop for CPU tensors, the
    kernel for CUDA tensors."""
    if _build.is_cpu(coeffs, state, x):
        return _seq_plain_run(coeffs, state, x, dyn, save)
    return _seq_cuda(coeffs, state, x, dyn, save)


class _SeqCascade(torch.autograd.Function):
    """:func:`biquad_cascade_seq` and :func:`dyn_biquad_cascade_seq`
    under autograd: the forward saves the stage signals where the
    coefficients want a gradient."""

    @staticmethod
    def forward(ctx, coeffs, state, x, dyn):
        want = ctx.needs_input_grad[0]
        out = _seq(coeffs, state, x, dyn, save=want)
        ctx.save_for_backward(coeffs, state, x, out[2] if want else None)
        ctx.dyn = dyn
        return out[0], out[1]

    @staticmethod
    @once_differentiable
    def backward(ctx, g_y, g_state):
        coeffs, state, x, sig = ctx.saved_tensors
        bwd = dyn_biquad_cascade_seq_bwd if ctx.dyn else biquad_cascade_seq_bwd
        g_c, g_s, g_x = bwd(coeffs, state, x, sig, g_y, g_state,
                            ctx.needs_input_grad[0])
        return g_c, g_s, g_x, None


def biquad_cascade_seq(coeffs: torch.Tensor, state: torch.Tensor,
                       x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential cascade: the exact per-sample DF2T order (the
    reference's own precision class; ~80 dB from float64 for near-unit
    poles, where the float32 associative scan drops to ~40 dB).
    Shapes as :func:`biquad_cascade`.  Differentiable in all three
    (:func:`biquad_cascade_seq_bwd`)."""
    if _empty(coeffs, x):
        return x, state
    if _build.needs_grad(coeffs, state, x):
        return _SeqCascade.apply(coeffs, state, x, False)
    return _seq(coeffs, state, x, dyn=False)


biquad_cascade_seq.launches = 0


def dyn_biquad_cascade_seq(coeffs: torch.Tensor, state: torch.Tensor,
                           x: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential cascade with per-sample coefficients ``[..., T, K,
    5]``: the precision class of the reference's own float32 recurrence,
    for near-unit-pole (low-frequency) dynamic filters.  Runs the same
    kernel library as :func:`biquad_cascade_seq` (its per-sample form)
    and counts its launches there too, and in its own ``launches``.
    Differentiable in all three (:func:`dyn_biquad_cascade_seq_bwd`)."""
    if _empty(coeffs, x):
        return x, state
    if _build.needs_grad(coeffs, state, x):
        return _SeqCascade.apply(coeffs, state, x, True)
    return _seq(coeffs, state, x, dyn=True)


dyn_biquad_cascade_seq.launches = 0


# ---------------------------------------------------------------------------
# the sequential cascade's adjoint
# ---------------------------------------------------------------------------


def _sum_rows(p: torch.Tensor) -> torch.Tensor:
    """Sum over the first axis in order, in float64 (the backward
    kernel's ``sums_kernel``)."""
    acc = p[0].double()
    for r in range(1, p.shape[0]):
        acc = acc + p[r].double()
    return acc


def _fold(p: torch.Tensor, batch, shape) -> torch.Tensor:
    """Per-row coefficient gradients ``p`` [rows, *tail] (coefficients
    broadcast over some of the batch axes, not all) summed over those
    axes one after the other, each in order, in float64."""
    tail = tuple(shape[len(shape) - (p.ndim - 1):])
    g = p.reshape(tuple(batch) + tail)
    lead = tuple(shape[:len(shape) - len(tail)])
    pad = len(batch) - len(lead)
    folds = [d for d in range(len(batch))
             if (1 if d < pad else lead[d - pad]) == 1 and g.shape[d] != 1]
    if not folds:   # one row a coefficient set: the terms as they are
        return g.reshape(shape)
    g = g.double()
    for d in folds:
        acc = g.narrow(d, 0, 1)
        for i in range(1, g.shape[d]):
            acc = acc + g.narrow(d, i, 1)
        g = acc
    return g.reshape(shape)


def _coef_grad(p, row_stride, batch, coeffs, sums):
    """The coefficients' gradient from the per-row terms ``p`` (float64
    sums of the static form, float32 terms of the per-sample form):
    summed over the rows by ``sums`` where all rows share the
    coefficients (row stride 0), else folded onto the broadcast axes."""
    if row_stride == 0:
        g = sums(p.reshape(p.shape[0], -1))
    else:
        g = _fold(p, batch, coeffs.shape)
    return g.to(coeffs.dtype).reshape(coeffs.shape)


def _seq_adjoint_plain(cr, row_stride, dyn, sig, g_y, g_s, want):
    """The adjoint loop on rows: ``g_y`` [rows, T], ``g_s`` [rows, K, 2],
    ``sig`` the saved stage signals [K + 1, rows, T] (used with
    ``want``).  Per sample in reverse, per stage from the last, ``gy =
    fma(c3, l1, fma(c4, l2, g))``, ``g_u = fma(c0, gy, fma(c1, l1, c2
    l2))`` (the FMAs through :func:`_mul_add`, as the kernel's
    ``__fmaf_rn``), the terms ``gy u, l1 u, l2 u, l1 y, l2 y``, then
    ``(l1, l2) = (gy, l1)``.  Returns (g_x [rows, T], g_state [rows, K,
    2], the per-row coefficient terms or None)."""
    rows, t_n = g_y.shape
    k_n = g_s.shape[-2]
    if dyn:
        cv = cr.reshape((rows, t_n, k_n, 5) if row_stride else (t_n, k_n, 5))

        def coef_at(t):
            return cv[:, t] if row_stride else cv[t]
    else:
        cv = cr.reshape((rows, k_n, 5) if row_stride else (k_n, 5))

        def coef_at(t):
            return cv
    l1 = [g_s[:, k, 0] for k in range(k_n)]
    l2 = [g_s[:, k, 1] for k in range(k_n)]
    acc = [g_y.new_zeros((rows, 5), dtype=torch.float64)
           for _ in range(k_n)] if want and not dyn else None
    gc = g_y.new_empty((rows, t_n, k_n, 5)) if want and dyn else None
    gx = torch.empty_like(g_y)
    for t in reversed(range(t_n)):
        g = g_y[:, t]
        c_t = coef_at(t)
        for k in reversed(range(k_n)):
            c0, c1, c2, c3, c4 = c_t[..., k, :].unbind(-1)
            gy = _mul_add(c3, l1[k], _mul_add(c4, l2[k], g))
            g_u = _mul_add(c0, gy, _mul_add(c1, l1[k], c2 * l2[k]))
            if want:
                u, yo = sig[k, :, t], sig[k + 1, :, t]
                terms = torch.stack([gy * u, l1[k] * u, l2[k] * u,
                                     l1[k] * yo, l2[k] * yo], dim=-1)
                if dyn:
                    gc[:, t, k] = terms
                else:
                    acc[k] = acc[k] + terms.double()
            l1[k], l2[k] = gy, l1[k]
            g = g_u
        gx[:, t] = g
    g_state = torch.stack([torch.stack([a, b], dim=-1)
                           for a, b in zip(l1, l2)], dim=-2)
    part = (gc if dyn else torch.stack(acc, dim=-2)) if want else None
    return gx, g_state, part


def _seq_adjoint_cuda(cr, row_stride, dyn, sig, g_y, g_s, want, counter):
    """The adjoint on ``csrc/biquad_bwd.cu``: one launch per group of up
    to 32 stages, the last group first, each counted in ``counter``."""
    rows, t_n = g_y.shape
    k_n = g_s.shape[-2]
    _build.check_cuda(torch.float32, g_y.device, g_y=g_y, g_state=g_s,
                      coeffs=cr)
    if want:
        _build.check_cuda(torch.float32, g_y.device, sig=sig)
    lib = _build.load("biquad_bwd", _BWD_SIGS)
    gs_out = torch.empty_like(g_s)
    part = gc = None
    if want and dyn:
        gc = g_y.new_empty((rows, t_n, k_n, 5))
    elif want:
        part = g_y.new_empty((rows, k_n, 5), dtype=torch.float64)
    g = g_y
    for k0 in reversed(range(0, k_n, LANES)):
        g_out = torch.empty_like(g_y)
        _build.check(lib.lsp_biquad_seq_bwd(
            _build.ptr(sig) if want else None, _build.ptr(g), _build.ptr(cr),
            _build.ptr(g_s), _build.ptr(g_out), _build.ptr(gs_out),
            None if part is None else _build.ptr(part),
            None if gc is None else _build.ptr(gc), rows, t_n, k_n, k0,
            min(LANES, k_n - k0), row_stride, k_n * 5 if dyn else 0,
            int(dyn), int(want), _build.stream_of(g_y)),
            "biquad_seq_bwd kernel")
        counter.launches += 1
        g = g_out
    return g, gs_out, (gc if dyn else part) if want else None


def _sums_cuda(counter):
    """:func:`_sum_rows` on the card (``sums_kernel``), counted in
    ``counter.sum_launches``."""
    def sums(p):
        out = torch.empty(p.shape[1:], dtype=torch.float32, device=p.device)
        _build.check(_build.load("biquad_bwd", _BWD_SIGS)
                     .lsp_biquad_seq_bwd_sums(
                         _build.ptr(p), _build.ptr(out), p.shape[0],
                         p.shape[1], int(p.dtype == torch.float64),
                         _build.stream_of(p)), "biquad_seq_bwd sums kernel")
        counter.sum_launches += 1
        return out
    return sums


def _seq_bwd(coeffs, state, x, sig, g_y, g_state, want_coeffs, dyn,
             counter, plain):
    t_n, k_n = x.shape[-1], coeffs.shape[-2]
    batch, _, _, cr, row_stride = _seq_rows(coeffs, state, x, dyn)
    rows = int(np.prod(batch, dtype=np.int64))
    g_y = g_y.expand(batch + (t_n,)).contiguous().reshape(rows, t_n)
    g_s = g_state.expand(batch + (k_n, 2)).contiguous().reshape(rows, k_n, 2)
    if want_coeffs and sig is None:
        raise ValueError("the coefficients' gradient needs the forward's "
                         "stage signals")
    if plain or _build.is_cpu(cr, g_y, g_s):
        gx, gs, part = _seq_adjoint_plain(cr, row_stride, dyn, sig, g_y, g_s,
                                          want_coeffs)
        sums = _sum_rows
    else:
        gx, gs, part = _seq_adjoint_cuda(cr, row_stride, dyn, sig, g_y, g_s,
                                         want_coeffs, counter)
        sums = _sums_cuda(counter)
    g_c = _coef_grad(part, row_stride, batch, coeffs, sums) \
        if want_coeffs else None
    return (g_c, gs.reshape(batch + (k_n, 2)).sum_to_size(state.shape),
            gx.reshape(batch + (t_n,)).sum_to_size(x.shape))


def biquad_cascade_seq_bwd_plain(coeffs, state, x, sig, g_y, g_state,
                                 want_coeffs=True):
    """Plain PyTorch version of :func:`biquad_cascade_seq_bwd`, on any
    device."""
    return _seq_bwd(coeffs, state, x, sig, g_y, g_state, want_coeffs, False,
                    biquad_cascade_seq_bwd, True)


def biquad_cascade_seq_bwd(coeffs, state, x, sig, g_y, g_state,
                           want_coeffs=True):
    """Backward of :func:`biquad_cascade_seq`: the cotangents of (y,
    state') -> those of (coeffs, state, x).  ``sig`` is the forward's
    stage signals [K + 1, rows, T] (``_SeqCascade`` saves them; needed
    only with ``want_coeffs``).  The reverse-time transpose of the DF2T
    step, last stage first (``csrc/biquad_bwd.cu`` states it); the
    coefficients' terms summed over time per row in float64, then over
    the rows in order (or folded onto the axes they broadcast over),
    rounded once.  The plain loop for CPU tensors; for CUDA tensors the
    kernel (a launch per group of up to 32 stages, counted in
    ``biquad_cascade_seq_bwd.launches``, and one of the row sums where the
    rows share the coefficients, in ``.sum_launches``), bit for bit the
    plain version."""
    return _seq_bwd(coeffs, state, x, sig, g_y, g_state, want_coeffs, False,
                    biquad_cascade_seq_bwd, False)


def dyn_biquad_cascade_seq_bwd_plain(coeffs, state, x, sig, g_y, g_state,
                                     want_coeffs=True):
    """Plain PyTorch version of :func:`dyn_biquad_cascade_seq_bwd`, on any
    device."""
    return _seq_bwd(coeffs, state, x, sig, g_y, g_state, want_coeffs, True,
                    dyn_biquad_cascade_seq_bwd, True)


def dyn_biquad_cascade_seq_bwd(coeffs, state, x, sig, g_y, g_state,
                               want_coeffs=True):
    """Backward of :func:`dyn_biquad_cascade_seq`: as
    :func:`biquad_cascade_seq_bwd`, each sample's coefficients taking
    that sample's terms (summed over the rows in float64 in order where
    the rows share them).  Launches counted in
    ``dyn_biquad_cascade_seq_bwd.launches`` and ``.sum_launches``."""
    return _seq_bwd(coeffs, state, x, sig, g_y, g_state, want_coeffs, True,
                    dyn_biquad_cascade_seq_bwd, False)


def seq_bwd_chain_ops() -> int:
    """The dependent operations a step of the adjoint's recurrence puts
    on its chain (``kChainOps`` in csrc/biquad_bwd.cu; builds it)."""
    return int(_build.load("biquad_bwd", _BWD_SIGS)
               .lsp_biquad_seq_bwd_chain_ops())


for _f in (biquad_cascade_seq_bwd, dyn_biquad_cascade_seq_bwd):
    _f.launches = 0
    _f.sum_launches = 0


def impulse_response(coeffs: torch.Tensor, length: int) -> torch.Tensor:
    """Impulse response of a cascade from zero state (time-parallel)."""
    x = torch.zeros(length, dtype=torch.float32, device=coeffs.device)
    x[0] = 1.0
    st = init_state(coeffs.shape[-2], tuple(coeffs.shape[:-2]),
                    device=coeffs.device)
    y, _ = biquad_cascade(coeffs, st, x)
    return y


def np_biquad_cascade_f64(coeffs: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Float64 sequential golden model (host) for SNR tests: the same
    per-stage DF2T recurrence, in float64."""
    y = np.asarray(x, np.float64).copy()
    coeffs = np.asarray(coeffs, np.float64)
    for (b0, b1, b2, a1, a2) in coeffs:
        s1 = 0.0
        s2 = 0.0
        out = np.empty_like(y)
        for n in range(y.shape[-1]):
            v = b0 * y[n] + s1
            s1 = b1 * y[n] + a1 * v + s2
            s2 = b2 * y[n] + a2 * v
            out[n] = v
        y = out
    return y
