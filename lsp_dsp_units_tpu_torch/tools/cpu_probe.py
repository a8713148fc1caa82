"""Probe the port's CPU entry points for outputs that differ from one
fresh process to the next.

    python3 -m lsp_dsp_units_tpu_torch.tools.cpu_probe [--procs 64]
        [--paths step,step_ring,oversampler,oscillator,noise]

PyTorch's CPU kernels split a tensor of more than 32768 elements over the
intra-op thread pool, and in some fresh processes the first
transcendental call (exp, sin, log, tanh) came out ~1.5e-4 off on one
worker's share.  Each path below runs at full width as the first work of
``--procs`` fresh processes, one after another, each with PyTorch's
default thread count, and each process's output is held bit for bit
against the first process's.  Printed: for each path, the processes that
differ and the largest relative difference of any element; the last line
is the same as one JSON object.  Exit code 1 if any path differed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

MODULE = "lsp_dsp_units_tpu_torch.tools.cpu_probe"
SR = 48000
C, RANK, T = 64, 14, 16384       # the bench graph's width, two blocks


def _x(seed: int, *shape, scale: float) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32))


def _step() -> torch.Tensor:
    from lsp_dsp_units_tpu_torch.pipeline import FilterConvChain
    chain = FilterConvChain(SR, C, rank=RANK, ir_seconds=1.0, device="cpu")
    params = chain.build()
    _, y = chain.step(params, chain.init_state(params), _x(1, C, T,
                                                            scale=1.0))
    return y


def _step_ring() -> torch.Tensor:
    from lsp_dsp_units_tpu_torch.pipeline import FilterConvChain
    chain = FilterConvChain(SR, C, rank=RANK, ir_seconds=1.0, device="cpu")
    params = chain.build()
    _, y = chain.step_ring(params, chain.init_ring_state(params),
                           _x(2, C, chain.block, scale=1.0))
    return y


def _oversampler() -> torch.Tensor:
    from lsp_dsp_units_tpu_torch.models.util.oversampler import Oversampler
    ovs = Oversampler(SR, ratio=4, quality="x3", filtering=True,
                      device="cpu")
    _, y = ovs.process(ovs.init_state((C,), device="cpu"),
                       _x(3, C, T, scale=0.7), torch.tanh)
    return y


def _oscillator() -> torch.Tensor:
    from lsp_dsp_units_tpu_torch.models.util.oscillator import (
        FunctionGenerator, Oscillator)
    osc = Oscillator(SR, FunctionGenerator.SINE, frequency=441.7,
                     amplitude=0.8, device="cpu")
    _, y = osc.process(osc.init_state(), C * T)
    return y


def _noise() -> torch.Tensor:
    from lsp_dsp_units_tpu_torch.models.noise import (NoiseColor,
                                                      NoiseGenerator)
    gen = NoiseGenerator(SR, color=NoiseColor.PINK, lcg_seed=7,
                         device="cpu")
    _, y = gen.process(gen.init_state(), T)
    return y


PATHS = {"step": _step, "step_ring": _step_ring,
         "oversampler": _oversampler, "oscillator": _oscillator,
         "noise": _noise}


def _child(path: str, out: str) -> None:
    y = PATHS[path]()
    np.save(out, y.detach().numpy())


def probe(path: str, procs: int, tmp: str) -> dict:
    """``procs`` fresh processes of ``path``, one at a time; the first
    one's output is the reference."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=root)
    out = os.path.join(tmp, f"{path}.npy")
    ref = None
    differ, worst = [], 0.0
    t0 = time.perf_counter()
    for i in range(procs):
        subprocess.run([sys.executable, "-m", MODULE, "--child", path, out],
                       cwd=root, env=env, check=True, timeout=900)
        y = np.load(out).astype(np.float64)
        if ref is None:
            ref = y
        elif not np.array_equal(y, ref, equal_nan=True):
            differ.append(i)
            scale = max(float(np.max(np.abs(ref))), 1e-30)
            worst = max(worst, float(np.max(np.abs(y - ref))) / scale)
    return dict(procs=procs, differ=len(differ), which=differ,
                max_rel=worst, seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=64)
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--child", nargs=2, metavar=("PATH", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child(*args.child)
        return 0
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        for path in args.paths.split(","):
            r = res[path] = probe(path, args.procs, tmp)
            print(f"{path}: {r['differ']} of {r['procs'] - 1} processes "
                  f"differ from the first (largest relative difference "
                  f"{r['max_rel']:.3g}), {r['seconds']:.0f} s", flush=True)
    print(json.dumps(dict(torch=torch.__version__,
                          threads=torch.get_num_threads(), paths=res)))
    return 1 if any(r["differ"] for r in res.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
