"""The dynamic delay line with in-buffer feedback: the port of the
``lax.scan`` of the JAX package's models/util/delay.py
``DynamicDelay.process`` (:104-122; reference DynamicDelay.cpp).

Per row, over a ring of M = max_delay + 1 samples whose state keeps the
JAX layout (the newest sample at index M - 1): per sample n, with
``d = clip(delay[n], 0, max_delay)`` and ``f = clip(fdelay[n], 0, d)``,
the input is written at the head, ``s = ring[head - d]`` is read, ``s *
fgain[n]`` is added into ``ring[head - d + f]``, and the output re-reads
``ring[head - d]`` (``s + s * fgain[n]`` where f == 0).

:func:`dynamic_delay` runs :func:`dynamic_delay_plain` (a Python loop
over T, each step vectorised over the rows, on a circular ring) for CPU
tensors and launches ``csrc/delay.cu``'s ``delay_kernel`` for CUDA
tensors (a block a row: producer warps compute each step's slots and,
for each of its two reads, the last write before it in its batch of 32,
an x or an r, or none; the chain warp runs a batch a lane a step and
settles the steps that read an r in shuffle rounds; the ring in shared
memory beside the records, or in a global scratch row where it does not
fit, ``lsp_delay_smem_bytes`` 0), counting launches in
``dynamic_delay.launches``.  Both round ``s * g`` and then the add, as
the JAX step does, so the three agree bit for bit.

Under autograd :func:`dynamic_delay` runs as a ``torch.autograd.Function``
whose forward also saves each step's s and whose backward,
:func:`dynamic_delay_bwd`, is the adjoint of the step in reverse time
over a ring of adjoints (``csrc/delay.cu`` states it): the plain loop
:func:`dynamic_delay_bwd_plain` for CPU tensors, ``delay_bwd_kernel`` for
CUDA tensors (a block a row: producer warps compute each step's slots
and, for each slot it reads, the step before it in its batch of 32 that
wrote it last; the chain warp runs a batch a lane a step, counted in
``dynamic_delay_bwd.launches``), bit for bit the same.  x, fgain and the
buffer take gradients; the delays are int32 and take none.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from lsp_dsp_units_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"lsp_dynamic_delay": [_P] * 8 + [_I] * 3 + [_P],
         "lsp_dynamic_delay_save": [_P] * 9 + [_I] * 3 + [_P],
         "lsp_dynamic_delay_bwd": [_P] * 10 + [_I] * 3 + [_P],
         "lsp_delay_smem_bytes": [_I], "lsp_delay_bwd_smem_bytes": [_I],
         "lsp_delay_chain_ops": [],
         "lsp_delay_bwd_chain_ops": []}


def _lib():
    return _build.load("delay", _SIGS)


def chain_ops() -> int:
    """The dependent operations a step puts on the chain through the
    ring (``kChainOps`` in csrc/delay.cu; builds the kernel)."""
    return int(_lib().lsp_delay_chain_ops())


def bwd_chain_ops() -> int:
    """The same for the adjoint's step (``kBwdChainOps``)."""
    return int(_lib().lsp_delay_bwd_chain_ops())


def _inputs(buffer, x, delay, fgain, fdelay, max_delay):
    """Checks; the inputs broadcast to x's shape as [rows, T] and the
    ring as [rows, M]."""
    m = int(max_delay) + 1
    if buffer.shape != x.shape[:-1] + (m,):
        raise ValueError(f"buffer must be {tuple(x.shape[:-1]) + (m,)} "
                         f"beside x {tuple(x.shape)}, got "
                         f"{tuple(buffer.shape)}")
    if delay.dtype != torch.int32 or fdelay.dtype != torch.int32:
        raise ValueError("delay and fdelay must be int32")
    t = x.shape[-1]
    rows = int(np.prod(x.shape[:-1], dtype=np.int64))

    def rt(v, dtype):
        return v.to(dtype).expand(x.shape).contiguous().reshape(rows, t)

    # float32 on the main path; the float64 gradient checks keep float64
    return (m, rows, t, rt(x, x.dtype), rt(delay, torch.int32),
            rt(fgain, x.dtype), rt(fdelay, torch.int32),
            buffer.contiguous().reshape(rows, m))


def _slots(ds, fs, m, t, max_delay, device):
    """The tail and feed slots of every step [rows, T] on the circular
    ring (the head is sample i's slot i mod M; the slots do not depend on
    the ring)."""
    d = torch.clamp(ds, 0, max_delay)
    f = torch.minimum(torch.clamp(fs, min=0), d)
    head = torch.arange(t, device=device) % m
    tail = torch.remainder(head - d, m).to(torch.int64)
    return tail, torch.remainder(tail + f, m)


def _delay_plain(buffer, x, delay, fgain, fdelay, max_delay, save=False):
    """The plain loop; with ``save`` also each step's s [rows, T]."""
    m, rows, t, xs, ds, gs, fs, ring = _inputs(buffer, x, delay, fgain,
                                               fdelay, max_delay)
    ring = ring.clone()
    y = torch.empty_like(xs)
    sv = torch.empty_like(xs) if save else None
    tail, feed = _slots(ds, fs, m, t, max_delay, x.device)
    for i in range(t):
        h = i % m
        ring[:, h] = xs[:, i]
        ti = tail[:, i:i + 1]
        s = ring.gather(1, ti)
        ring.scatter_add_(1, feed[:, i:i + 1], s * gs[:, i:i + 1])
        y[:, i] = ring.gather(1, ti)[:, 0]
        if save:
            sv[:, i] = s[:, 0]
    out = torch.roll(ring, -((m - 1 + t) % m + 1) % m, dims=-1)
    return out.reshape(buffer.shape), y.reshape(x.shape), sv


def dynamic_delay_plain(buffer, x, delay, fgain, fdelay, max_delay: int):
    """Plain PyTorch version of :func:`dynamic_delay`."""
    return _delay_plain(buffer, x, delay, fgain, fdelay, max_delay)[:2]


def _delay_cuda(buffer, x, delay, fgain, fdelay, max_delay, save=False):
    """The kernel; with ``save`` its saving form, which also writes each
    step's s [rows, T]."""
    m, rows, t, xs, ds, gs, fs, ring = _inputs(buffer, x, delay, fgain,
                                               fdelay, max_delay)
    _build.check_cuda(torch.float32, x.device, x=xs, fgain=gs, ring=ring)
    _build.check_cuda(torch.int32, x.device, delay=ds, fdelay=fs)
    y = torch.empty_like(xs)
    out = torch.empty_like(ring)
    sv = torch.empty_like(xs) if save else None
    lib = _lib()
    scratch = None if lib.lsp_delay_smem_bytes(int(max_delay)) > 0 \
        else torch.empty_like(ring)
    ptrs = [_build.ptr(v) for v in (xs, ds, gs, fs, ring, out, y)]
    ptrs.append(None if scratch is None else _build.ptr(scratch))
    tail = (rows, t, int(max_delay), _build.stream_of(x))
    _build.check(lib.lsp_dynamic_delay_save(*ptrs, _build.ptr(sv), *tail)
                 if save else lib.lsp_dynamic_delay(*ptrs, *tail),
                 "dynamic delay kernel")
    dynamic_delay.launches += 1
    return out.reshape(buffer.shape), y.reshape(x.shape), sv


def _delay(buffer, x, delay, fgain, fdelay, max_delay, save=False):
    if _build.is_cpu(buffer, x, delay, fgain, fdelay):
        return _delay_plain(buffer, x, delay, fgain, fdelay, max_delay, save)
    return _delay_cuda(buffer, x, delay, fgain, fdelay, max_delay, save)


def dynamic_delay(buffer, x, delay, fgain, fdelay, max_delay: int):
    """The dynamic delay over x [..., T] with per-sample ``delay`` and
    ``fdelay`` (int32) and ``fgain`` (float32), each broadcast to x's
    shape; ``buffer`` [..., max_delay + 1] the ring in the JAX layout.
    Returns (buffer', y [..., T]).  Differentiable in the buffer, x and
    fgain (:func:`dynamic_delay_bwd`)."""
    if _build.needs_grad(buffer, x, fgain):
        return _DynamicDelay.apply(buffer, x, delay, fgain, fdelay,
                                   int(max_delay))
    return _delay(buffer, x, delay, fgain, fdelay, max_delay)[:2]


dynamic_delay.launches = 0


def _bwd_rows(x, delay, fgain, fdelay, s, g_y, g_buf, max_delay):
    m, rows, t = int(max_delay) + 1, s.shape[0], x.shape[-1]

    def rt(v, dtype):
        return v.to(dtype).expand(x.shape).contiguous().reshape(rows, t)
    return (m, rows, t, rt(g_y, x.dtype), rt(delay, torch.int32),
            rt(fgain, x.dtype), rt(fdelay, torch.int32),
            g_buf.contiguous().reshape(rows, m))


def dynamic_delay_bwd_plain(buffer, x, delay, fgain, fdelay, s, g_y, g_buf,
                            max_delay: int):
    """Plain PyTorch version of :func:`dynamic_delay_bwd`: the adjoint of
    the JAX scan body (models/util/delay.py:98-124) in reverse time on a
    circular ring of adjoints lam [rows, M], per step ``lam[tail] +=
    g_y``, ``g_fgain = lam[feed] s``, ``lam[tail] += lam[feed] fgain``,
    ``g_x = lam[head]``, ``lam[head] = 0``."""
    m, rows, t, gys, ds, gs, fs, g_out = _bwd_rows(x, delay, fgain, fdelay, s,
                                                   g_y, g_buf, max_delay)
    tail, feed = _slots(ds, fs, m, t, max_delay, x.device)
    lam = torch.roll(g_out, ((m - 1 + t) % m + 1) % m, dims=-1)
    gx = torch.empty_like(gys)
    gg = torch.empty_like(gys)
    for i in reversed(range(t)):
        ti, fi = tail[:, i:i + 1], feed[:, i:i + 1]
        lam.scatter_add_(1, ti, gys[:, i:i + 1])
        lf = lam.gather(1, fi)
        gg[:, i] = (lf * s[:, i:i + 1])[:, 0]
        lam.scatter_add_(1, ti, lf * gs[:, i:i + 1])
        h = i % m
        gx[:, i] = lam[:, h]
        lam[:, h] = 0.0
    return lam, gx, gg


def _delay_bwd_cuda(x, delay, fgain, fdelay, s, g_y, g_buf, max_delay):
    """``delay_bwd_kernel``: a block a row, the adjoint ring in shared
    memory beside the kernel's records, or in a global scratch row where
    it does not fit (``lsp_delay_bwd_smem_bytes`` 0)."""
    m, rows, t, gys, ds, gs, fs, g_out = _bwd_rows(x, delay, fgain, fdelay, s,
                                                   g_y, g_buf, max_delay)
    _build.check_cuda(torch.float32, x.device, g_y=gys, fgain=gs, s=s,
                      g_buf=g_out)
    _build.check_cuda(torch.int32, x.device, delay=ds, fdelay=fs)
    g_in, gx, gg = (torch.empty_like(g_out), torch.empty_like(gys),
                    torch.empty_like(gys))
    lib = _lib()
    scratch = None if lib.lsp_delay_bwd_smem_bytes(int(max_delay)) > 0 \
        else torch.empty_like(g_out)
    _build.check(lib.lsp_dynamic_delay_bwd(
        *(_build.ptr(v) for v in (gys, ds, gs, fs, s, g_out, g_in, gx, gg)),
        None if scratch is None else _build.ptr(scratch), rows, t,
        int(max_delay), _build.stream_of(x)), "dynamic delay bwd kernel")
    dynamic_delay_bwd.launches += 1
    return g_in, gx, gg


def dynamic_delay_bwd(buffer, x, delay, fgain, fdelay, s, g_y, g_buf,
                      max_delay: int):
    """Backward of :func:`dynamic_delay`: the cotangents of (buffer', y)
    -> those of the buffer, x and fgain, each as [rows, M] / [rows, T]
    (fgain's per sample, before any sum over its broadcast axes).  ``s``
    is the forward's s a step [rows, T].  The plain loop for CPU tensors;
    for CUDA tensors ``delay_bwd_kernel`` (:func:`_delay_bwd_cuda`,
    counted in ``dynamic_delay_bwd.launches``), bit for bit the plain
    version."""
    if _build.is_cpu(x, delay, fgain, fdelay, s, g_y, g_buf):
        return dynamic_delay_bwd_plain(buffer, x, delay, fgain, fdelay, s,
                                       g_y, g_buf, max_delay)
    return _delay_bwd_cuda(x, delay, fgain, fdelay, s, g_y, g_buf, max_delay)


dynamic_delay_bwd.launches = 0


class _DynamicDelay(torch.autograd.Function):
    """:func:`dynamic_delay` under autograd: the forward saves each
    step's s, the backward is :func:`dynamic_delay_bwd`."""

    @staticmethod
    def forward(ctx, buffer, x, delay, fgain, fdelay, max_delay):
        out, y, s = _delay(buffer, x, delay, fgain, fdelay, max_delay,
                           save=True)
        ctx.save_for_backward(buffer, x, delay, fgain, fdelay, s)
        ctx.max_delay = max_delay
        return out, y

    @staticmethod
    @once_differentiable
    def backward(ctx, g_buf, g_y):
        buffer, x, delay, fgain, fdelay, s = ctx.saved_tensors
        g_in, gx, gg = dynamic_delay_bwd(buffer, x, delay, fgain, fdelay, s,
                                         g_y, g_buf, ctx.max_delay)
        return (g_in.reshape(buffer.shape),
                gx.reshape(x.shape),
                None,
                gg.reshape(x.shape).sum_to_size(fgain.shape)
                if ctx.needs_input_grad[3] else None,
                None, None)
