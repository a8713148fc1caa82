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
tensors and launches ``csrc/delay.cu`` (one warp per row, the ring in
shared memory, or in a global scratch row above 227 KB) for CUDA
tensors, counting launches in ``dynamic_delay.launches``.  Both round
``s * g`` and then the add, as the JAX step does, so the three agree bit
for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"lsp_dynamic_delay": [_P] * 8 + [_I] * 3 + [_P],
         "lsp_delay_smem_bytes": [_I], "lsp_delay_chain_ops": []}


def _lib():
    return _build.load("delay", _SIGS)


def chain_ops() -> int:
    """The dependent operations a step puts on the chain through the
    ring (``kChainOps`` in csrc/delay.cu; builds the kernel)."""
    return int(_lib().lsp_delay_chain_ops())


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

    return (m, rows, t, rt(x, torch.float32), rt(delay, torch.int32),
            rt(fgain, torch.float32), rt(fdelay, torch.int32),
            buffer.contiguous().reshape(rows, m))


def dynamic_delay_plain(buffer, x, delay, fgain, fdelay, max_delay: int):
    """Plain PyTorch version of :func:`dynamic_delay`."""
    m, rows, t, xs, ds, gs, fs, ring = _inputs(buffer, x, delay, fgain,
                                               fdelay, max_delay)
    ring = ring.clone()
    y = torch.empty_like(xs)
    # the head is sample i's slot i mod M (it starts at M - 1); the
    # slots each step reads and writes do not depend on the ring
    d = torch.clamp(ds, 0, max_delay)
    f = torch.minimum(torch.clamp(fs, min=0), d)
    head = torch.arange(t, device=x.device) % m
    tail = torch.remainder(head - d, m).to(torch.int64)
    feed = torch.remainder(tail + f, m)
    for i in range(t):
        h = i % m
        ring[:, h] = xs[:, i]
        ti = tail[:, i:i + 1]
        s = ring.gather(1, ti)
        ring.scatter_add_(1, feed[:, i:i + 1], s * gs[:, i:i + 1])
        y[:, i] = ring.gather(1, ti)[:, 0]
    out = torch.roll(ring, -((m - 1 + t) % m + 1) % m, dims=-1)
    return out.reshape(buffer.shape), y.reshape(x.shape)


def dynamic_delay(buffer, x, delay, fgain, fdelay, max_delay: int):
    """The dynamic delay over x [..., T] with per-sample ``delay`` and
    ``fdelay`` (int32) and ``fgain`` (float32), each broadcast to x's
    shape; ``buffer`` [..., max_delay + 1] the ring in the JAX layout.
    Returns (buffer', y [..., T])."""
    _build.no_grad_route("dynamic_delay", buffer, x, delay, fgain, fdelay)
    if _build.is_cpu(buffer, x, delay, fgain, fdelay):
        return dynamic_delay_plain(buffer, x, delay, fgain, fdelay,
                                   max_delay)
    m, rows, t, xs, ds, gs, fs, ring = _inputs(buffer, x, delay, fgain,
                                               fdelay, max_delay)
    _build.check_cuda(torch.float32, x.device, x=xs, fgain=gs, ring=ring)
    _build.check_cuda(torch.int32, x.device, delay=ds, fdelay=fs)
    y = torch.empty_like(xs)
    out = torch.empty_like(ring)
    lib = _lib()
    scratch = None if lib.lsp_delay_smem_bytes(int(max_delay)) > 0 \
        else torch.empty_like(ring)
    _build.check(lib.lsp_dynamic_delay(
        *(_build.ptr(v) for v in (xs, ds, gs, fs, ring, out, y)),
        None if scratch is None else _build.ptr(scratch), rows, t,
        int(max_delay), _build.stream_of(x)), "dynamic delay kernel")
    dynamic_delay.launches += 1
    return out.reshape(buffer.shape), y.reshape(x.shape)


dynamic_delay.launches = 0
