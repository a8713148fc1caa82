"""Run a function on N ranks, one spawned process each.

    results = spawn(fn, n, args=(...), device="cpu")

Each process starts from a fresh import (the ``spawn`` method: it imports
only ``fn``'s module and what that imports), joins a process group over a
file store in a temporary directory (gloo for ``device="cpu"``, NCCL on
card ``rank % device_count`` otherwise), calls ``fn(*args)`` and sends
back its result, tensors as numpy arrays.  ``fn`` must be a module-level
function.  The whole run has one deadline: a rank that fails, hangs or
dies fails the call, and every process is stopped before it returns.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

from lsp_dsp_units_tpu_torch.utils.tree import tree_map


def _to_host(leaf):
    import torch
    return leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else leaf


def _rank_main(fn, rank: int, n: int, store: str, device: str,
               timeout: float, args: Sequence, results) -> None:
    import torch
    import torch.distributed as dist
    from lsp_dsp_units_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    try:
        init_distributed(store, n, rank, platform=device, timeout=timeout)
        results.put((rank, True, tree_map(_to_host, fn(*args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, n: int, args: Sequence = (), device: str = "cuda",
          timeout: float = 120.0) -> List[Any]:
    """``fn(*args)`` on ranks 0..n-1, on the card (one a rank, NCCL)
    unless ``device`` is "cpu" (gloo); returns their results in rank
    order.  Raises RuntimeError with the first failing rank's traceback,
    or when the ranks have not all answered within ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got, error = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        store = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n, store, device, timeout, args,
                                   results)) for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(got) < n and error is None:
                try:
                    rank, ok, val = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if dead:
                        error = f"rank {dead[0]} died (exit code " \
                                f"{procs[dead[0]].exitcode})"
                    elif time.monotonic() > deadline:
                        error = f"ranks {sorted(set(range(n)) - set(got))} " \
                                f"did not answer within {timeout} s"
                    continue
                if ok:
                    got[rank] = val
                else:
                    error = f"rank {rank} failed:\n{val}"
        finally:
            for p in procs:
                p.join(timeout=10.0 if error is None else 0.5)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
    if error is not None:
        raise RuntimeError(f"spawn({fn.__name__}, {n}): {error}")
    return [got[r] for r in range(n)]
