"""The sharded chain across processes: N worker processes, one gloo rank
on the CPU each, joined by ``torch.distributed`` (the port's twin of the
JAX package's ``benchmarks/multihost_demo.py``).

The mesh is (1, N): the time axis crosses the process boundary, so the
convolver's halos, the IIR summaries and the gathered dynamics all travel
between processes.  Worker 0 holds the distributed result against the
single-process ``step`` (>= 95 dB on each of 2 calls) and the
time-sharded ILUFS gate against the sequential meter (within 1e-5
relative), and prints one JSON line with ``"ok"``.

    python3 -m lsp_dsp_units_tpu_torch.tools.multihost_demo --workers 4

The workers find their rank in ``LSP_COORDINATOR``, ``LSP_NUM_PROCESSES``
and ``LSP_PROCESS_ID`` (``parallel.mesh.init_distributed``).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKER_TIMEOUT_S = 300


def worker() -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from lsp_dsp_units_tpu_torch.models.meters.loudness import ILUFSMeter
    from lsp_dsp_units_tpu_torch.ops import biquad_block
    from lsp_dsp_units_tpu_torch.parallel import mesh as pmesh
    from lsp_dsp_units_tpu_torch.parallel.meters import (
        ilufs_integrated_time_sharded)
    from lsp_dsp_units_tpu_torch.pipeline import FilterConvChain

    torch.set_num_threads(1)
    pmesh.init_distributed(platform="cpu")
    try:
        pid, n = dist.get_rank(), dist.get_world_size()
        mesh = pmesh.make_mesh(chan=1, time=n, device_type="cpu")
        tg = mesh.get_group(pmesh.TIME_AXIS)

        chain = FilterConvChain(48000, 4, rank=8, ir_seconds=0.02,
                                device="cpu")
        params = chain.build()
        rng = np.random.default_rng(0)
        xs = [torch.from_numpy((rng.standard_normal(
            (4, chain.block * 2 * n)) * 0.25).astype(np.float32))
            for _ in range(2)]
        step = chain.sharded_step(mesh, params)
        st = pmesh.chan_sharding(mesh, chain.init_state(params))
        outs = []
        for x in xs:
            st, y = step(st, pmesh.chan_time_sharding(mesh, x))
            outs.append(pmesh.gather_chan_time(mesh, y))

        # the 400 ms gating blocks straddle the process boundaries; the
        # two-stage gate reduces across processes
        meter = ILUFSMeter(48000, 4, max_int_time_s=10.0, device="cpu")
        xl = torch.from_numpy((rng.standard_normal(
            (4, n * 3 * meter.blk_size)) * 0.2).astype(np.float32))
        fp = biquad_block.precompute_fused(meter._coeffs.numpy(),
                                           meter.blk_size, device="cpu")
        loud_sh = float(ilufs_integrated_time_sharded(
            meter, fp, pmesh.time_sharding(mesh, xl), tg))
    finally:
        dist.destroy_process_group()

    if pid != 0:
        return
    ref = chain.init_state(params)
    snrs = []
    for x, got in zip(xs, outs):
        ref, y_ref = chain.step(params, ref, x)
        err = (got - y_ref).double()
        snrs.append(10.0 * float(torch.log10(
            torch.sum(y_ref.double() ** 2)
            / torch.clamp(torch.sum(err * err), min=1e-30))))
    mst, _ = meter.process(meter.init_state(), xl)
    loud_ref = float(mst.loudness)
    loud_ok = loud_ref > 0.0 and abs(loud_sh - loud_ref) <= 1e-5 * loud_ref
    ok = all(s >= 95.0 for s in snrs) and loud_ok
    print(json.dumps({"processes": n, "snr_db_per_step": snrs,
                      "ilufs_sharded": loud_sh, "ilufs_sequential": loud_ref,
                      "ok": ok}), flush=True)
    if not ok:
        raise SystemExit(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--worker", action="store_true",
                    help="run as one worker (set by the launcher)")
    args = ap.parse_args(argv)
    if args.worker:
        worker()
        return 0
    # an ephemeral port for rank 0's store, so that concurrent runs
    # cannot collide
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, LSP_COORDINATOR=f"127.0.0.1:{port}",
               LSP_NUM_PROCESSES=str(args.workers),
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lsp_dsp_units_tpu_torch.tools.multihost_demo",
         "--worker"], env=dict(env, LSP_PROCESS_ID=str(pid)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
        for pid in range(args.workers)]
    ok = True
    try:
        for pid, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                ok = False
                print(f"# worker {pid} timed out", file=sys.stderr)
                continue
            for line in out.splitlines():
                if line.startswith("{"):
                    print(line)
            if p.returncode != 0:
                ok = False
                print(f"# worker {pid} rc={p.returncode}: {err[-800:]}",
                      file=sys.stderr)
    finally:
        # one hung worker must not leave its peers waiting on it
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
