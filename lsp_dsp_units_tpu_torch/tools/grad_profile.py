"""Where the time of #1's adjoint routes goes on the card, alone and
inside the training steps.

    python3 -m lsp_dsp_units_tpu_torch.tools.grad_profile [--out F]

At the main paths' shapes (64 channels, rank 14: N = 16384):

* each adjoint route of kernel #1 (``rfft_packed_bwd`` whole frame and
  zero-pad, ``irfft_packed_bwd`` whole, first and last half) at
  ``step``'s [128, N] (two blocks of 64 channels a call), and the
  zero-pad one at ``step_ring``'s [64, N]: the mean time of a call by
  CUDA events around 1, 10 and 50 back-to-back calls behind a spin
  kernel (``chip_smoke.py``'s ``time_ms`` takes 50), the host's time to
  enqueue a call, the wall time of a call (host clock over back-to-back
  calls ending in a sync), and every kernel of a call by torch.profiler after
  uncounted calls (``tools/launch_profile.py``): name, ms a launch,
  launches a call;
* the same routes inside the training steps: every kernel of one
  forward + backward of two calls of ``step`` and of eight blocks of
  ``step_ring`` (torch.profiler, after uncounted steps), by name with
  its ms and launches, the step's events, enqueue and wall times, and
  the adjoints' launch counters of that run.

Prints one JSON object (the card's name and power limit in ``card``).
It times the checkout it is run from; to profile another, copy this file
and ``tools/launch_profile.py`` into that checkout's ``tools/``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from lsp_dsp_units_tpu_torch import pipeline
from lsp_dsp_units_tpu_torch.ops import fft_packed as fp
from lsp_dsp_units_tpu_torch.tools import launch_profile as lp

C, RANK, SR = 64, 14, 48000
B = 1 << (RANK - 1)
N = 2 * B
STEP_BLOCKS = 2                      # step's blocks a call
RING_BLOCKS = 8                      # step_ring's blocks under one loss
SPIN_CYCLES = 200_000_000            # ~0.1 s at 1.98 GHz
COUNTERS = ((fp.rfft_packed, "bwd_launches"),
            (fp.rfft_packed_zeropad, "bwd_launches"),
            (fp.irfft_packed, "bwd_launches"))


def events_ms(fn, reps: int) -> float:
    """Mean device time of a call: CUDA events around ``reps`` calls
    enqueued behind a spin kernel."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def enqueue_ms(fn, reps: int = 50) -> float:
    """The host's time to enqueue a call, the card held by a spin."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def wall_ms(fn, reps: int) -> float:
    """What a caller waits for a call: the host clock over ``reps``
    back-to-back calls ending in a synchronisation, no spin kernel."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def kernel_table(fn, calls: int, warm: int = 3) -> list:
    """Every kernel of ``fn()`` by torch.profiler, counted over ``calls``
    calls after ``warm`` uncounted ones (tools/launch_profile.py): (name,
    ms a call, launches a call), the most time first; the name is the
    profiler's, cut to 150 characters."""
    rows = lp.device_kernels(fn, calls, warm)
    return [dict(name=k[:150], ms=ms / calls, launches=n / calls)
            for k, (ms, n) in sorted(rows.items(), key=lambda r: -r[1][0])]


def adjoint_cases(gen):
    """The routes and their arguments: step's four (and the whole-frame
    inverse's) at [128, N], step_ring's zero-pad one at [64, N]."""
    rows = C * STEP_BLOCKS

    def r(*shape):
        return torch.randn(*shape, generator=gen).cuda()
    gre, gim, g_half, g_full = r(rows, B), r(rows, B), r(rows, B), r(rows, N)
    rre, rim = r(C, B), r(C, B)
    return {
        "rfft_zeropad": (fp.rfft_packed_bwd, (gre, gim, N, 1)),
        "rfft": (fp.rfft_packed_bwd, (gre, gim, N, 0)),
        "irfft": (fp.irfft_packed_bwd, (g_full, N, False)),
        "irfft_first": (fp.irfft_packed_bwd, (g_half, N, "first")),
        "irfft_last": (fp.irfft_packed_bwd, (g_half, N, "last")),
        "ring_rfft_zeropad": (fp.rfft_packed_bwd, (rre, rim, N, 1)),
    }


def training_steps(gen):
    """One forward + backward of two calls of step, and of RING_BLOCKS
    blocks of step_ring, with x requiring grad."""
    chain = pipeline.FilterConvChain(SR, C, rank=RANK, ir_seconds=1.0)
    params = chain.build()
    xs = [torch.randn(C, STEP_BLOCKS * B, generator=gen).cuda() * 2.0
          for _ in range(2)]
    xr = [torch.randn(C, B, generator=gen).cuda() * 0.25
          for _ in range(RING_BLOCKS)]
    st0 = chain.init_state(params)

    def step():
        x0, x1 = (x.detach().requires_grad_(True) for x in xs)
        s, y0 = chain.step(params, st0, x0)
        _, y1 = chain.step(params, s, x1)
        (torch.sum(y0 * y0) + torch.sum(y1 * y1)).backward()

    def ring():
        s = chain.init_ring_state(params)
        total = 0.0
        for x in xr:
            s, y = chain.step_ring(params, s, x.detach().requires_grad_(True))
            total = total + torch.sum(y * y)
        total.backward()

    return {"step_2_calls": step, f"step_ring_{RING_BLOCKS}_blocks": ring}


def counted(fn) -> dict:
    """The adjoints' launch counters over one call of ``fn``."""
    torch.cuda.synchronize()
    for f, attr in COUNTERS:
        setattr(f, attr, 0)
    fn()
    torch.cuda.synchronize()
    return {f"{f.__name__}.{attr}": getattr(f, attr) for f, attr in COUNTERS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("grad_profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    gen = torch.Generator().manual_seed(20)
    out = dict(card=card, adjoints={}, steps={})
    for name, (fn, a) in adjoint_cases(gen).items():
        call = (lambda f, a: lambda: f(*a))(fn, a)
        kern = kernel_table(call, 10)
        rec = dict(events_ms={str(k): events_ms(call, k) for k in (1, 10, 50)},
                   enqueue_ms=enqueue_ms(call), wall_ms=wall_ms(call, 50),
                   kernels_ms=sum(r["ms"] for r in kern), kernels=kern,
                   counters=counted(call))
        out["adjoints"][name] = rec
        print(f"{name}: events " + ", ".join(
            f"{k} calls {v:.4f}" for k, v in rec["events_ms"].items())
            + f" ms a call; host {rec['enqueue_ms']:.4f} ms to enqueue a "
            f"call, wall {rec['wall_ms']:.4f}; kernels "
            f"{rec['kernels_ms']:.4f} ms a call: " + "; ".join(
                f"{r['name'][:70]} {r['ms']:.4f} x {r['launches']:g}"
                for r in kern), flush=True)
    for name, fn in training_steps(gen).items():
        kern = kernel_table(fn, 2, warm=2)
        rec = dict(events_ms=events_ms(fn, 1), enqueue_ms=enqueue_ms(fn, 1),
                   wall_ms=wall_ms(fn, 5),
                   kernels_ms=sum(r["ms"] for r in kern), kernels=kern,
                   counters=counted(fn))
        out["steps"][name] = rec
        launches = sum(r["launches"] for r in kern)
        print(f"{name}: events {rec['events_ms']:.4f} ms, host "
              f"{rec['enqueue_ms']:.4f} ms to enqueue, wall "
              f"{rec['wall_ms']:.4f}, kernels {rec['kernels_ms']:.4f} ms "
              f"over {launches:g} launches; counters {rec['counters']}",
              flush=True)
        for r in kern[:25]:
            print(f"  {r['ms']:.4f} ms x {r['launches']:g}  {r['name']}",
                  flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(dict(card=card, adjoints={
        k: dict(events_ms=v["events_ms"], enqueue_ms=v["enqueue_ms"],
                wall_ms=v["wall_ms"], kernels_ms=v["kernels_ms"])
        for k, v in out["adjoints"].items()},
        steps={k: dict(events_ms=v["events_ms"], wall_ms=v["wall_ms"],
                       kernels_ms=v["kernels_ms"])
               for k, v in out["steps"].items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
