"""Profiling helpers: the port of utils/profiling.py.

``trace(logdir)`` captures a ``torch.profiler`` trace of a region (host
and, where there is a card, device activity) for TensorBoard or a Chrome
trace viewer; ``time_fn`` measures the steady-state time of a step, best of
several timed windows, each ended by ``torch.cuda.synchronize()`` where
the step's output lies on a card, so that the window holds the device's
work and not only its enqueue.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional, Tuple

import torch

from lsp_dsp_units_tpu_torch.utils.tree import leaves_with_path


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profiler trace of the enclosed region into ``logdir``::

        with profiling.trace("traces/step") as prof:
            state, y = chain.step(params, state, x)
        print(prof.key_averages().table(sort_by="cuda_time_total"))
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)) as prof:
        yield prof


def tensor_leaves(tree):
    """The tensor leaves of a result tree (the JAX package's
    ``jax_leaves``)."""
    return [leaf for _, leaf in leaves_with_path(tree)
            if torch.is_tensor(leaf)]


def _wait(out) -> None:
    if any(t.is_cuda for t in tensor_leaves(out)):
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, iters: int = 10, windows: int = 3,
            samples_per_call: Optional[int] = None,
            ) -> Tuple[float, Optional[float]]:
    """Steady-state timing of ``fn(*args)``.

    Carries nothing between calls: pass a closure if the step is
    stateful.  Returns ``(seconds_per_call, samples_per_second)``, the
    second None unless ``samples_per_call`` is given.  The first call
    (kernel builds, allocator warm-up) is excluded; the best of
    ``windows`` windows of ``iters`` calls is kept.
    """
    _wait(fn(*args))
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        _wait(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    rate = None if samples_per_call is None else samples_per_call / best
    return best, rate
