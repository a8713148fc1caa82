"""The port's multi-process entry points on gloo ranks on the CPU:
``entry.dryrun_multichip`` (the twin of the JAX package's
``__graft_entry__.dryrun_multichip``: the sharded chain against the
single-process step at >= 95 dB over two calls, and the time-sharded
loudness gate and global meters against their sequential forms) and
``tools/multihost_demo.py``, whose worker 0 holds the distributed result
against the single-process ``step`` (>= 95 dB) and prints a JSON line
with ``"ok"``.  Each run has its own deadline, so a rank that hangs fails
the test instead of the whole run.  One card tests world size 1 only
(``chip_smoke.py``); these gloo processes prove the multi-rank
behaviour."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from lsp_dsp_units_tpu_torch.entry import dryrun_multichip
from lsp_dsp_units_tpu_torch.parallel import mesh as pmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_S = 120.0


@pytest.mark.parametrize("n, mesh", [(1, (1, 1)), (2, (1, 2)),
                                     (4, (2, 2))])
def test_dryrun_multichip_on_cpu(n, mesh):
    got = dryrun_multichip(n, device="cpu", timeout=SPAWN_S)
    assert tuple(got["mesh"]) == mesh
    assert min(got["snr_db"]) >= 95.0
    assert abs(got["ilufs_sharded"] - got["ilufs_sequential"]) <= \
        1e-5 * got["ilufs_sequential"]


def test_dryrun_multichip_never_moves_to_the_cpu():
    """More ranks than cards on ``device="cuda"`` raises; it does not run
    on the CPU instead."""
    with pytest.raises(RuntimeError, match="CUDA devices"):
        dryrun_multichip(torch.cuda.device_count() + 1)


def test_multihost_demo_two_workers():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    out = subprocess.run(
        [sys.executable, "-m", "lsp_dsp_units_tpu_torch.tools.multihost_demo",
         "--workers", "2"], capture_output=True, text=True, timeout=240,
        env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-800:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["ok"] is True and line["processes"] == 2
    assert min(line["snr_db_per_step"]) >= 95.0


def test_mesh_helpers_at_world_size_one(monkeypatch):
    """The rank's place from the environment; the mesh's size checked;
    cuts, gathers and ``replicated`` on a state tree (numpy leaves become
    tensors on the rank's device, Python numbers stay)."""
    monkeypatch.delenv("LSP_COORDINATOR", raising=False)
    monkeypatch.setenv("LSP_NUM_PROCESSES", "1")
    monkeypatch.setenv("LSP_PROCESS_ID", "0")
    pmesh.init_distributed(platform="cpu")
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        with pytest.raises(ValueError, match="needs 2 ranks"):
            pmesh.make_mesh(2, 1, "cpu")
        mesh = pmesh.make_mesh(time=1, device_type="cpu")
        tree = {"b": (np.ones((2, 3), np.float32), 7), "a": None}
        rep = pmesh.replicated(mesh, tree)
        assert torch.is_tensor(rep["b"][0]) and rep["b"][1] == 7
        assert rep["a"] is None
        x = torch.arange(12.0).reshape(2, 6)
        assert torch.equal(pmesh.gather_chan_time(
            mesh, pmesh.chan_time_sharding(mesh, x)), x)
        st = pmesh.chan_sharding(mesh, tree)
        assert torch.equal(pmesh.gather_chan(mesh, st)["b"][0],
                           torch.ones(2, 3))
    finally:
        dist.destroy_process_group()


def test_init_distributed_needs_a_coordinator(monkeypatch):
    monkeypatch.delenv("LSP_COORDINATOR", raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        pmesh.init_distributed(num_processes=2, process_id=0,
                               platform="cpu")
    assert not dist.is_initialized()
