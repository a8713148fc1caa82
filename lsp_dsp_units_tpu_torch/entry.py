"""The port's counterparts of the JAX package's ``__graft_entry__``:

* :func:`entry` — a forward step of the filter + convolver + dynamics
  chain on small shapes (4 channels, rank 9, a 0.05 s IR, two blocks per
  call), on an explicit device::

      fn, args = entry("cuda")
      state, y = fn(*args)

* :func:`dryrun_multichip` — the whole chain step over an n-rank
  ('chan', 'time') mesh on tiny shapes, held against the single-process
  step, with the global meters' collectives.
"""

from __future__ import annotations

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.pipeline import FilterConvChain


def entry(device):
    """Returns (fn, (params, state, x)) with ``fn(params, state, x) ->
    (state', y)`` the chain's :meth:`FilterConvChain.step`."""
    chain = FilterConvChain(sample_rate=48000, channels=4, rank=9,
                            ir_seconds=0.05, device=device)
    params = chain.build()
    state = chain.init_state(params)
    x = torch.zeros((4, chain.block * 2), dtype=torch.float32,
                    device=chain.device)

    def fn(params, state, x):
        return chain.step(params, state, x)

    return fn, (params, state, x)


def _snr_db(ref: torch.Tensor, out: torch.Tensor) -> float:
    ref = ref.double()
    err = out.double() - ref
    return 10.0 * float(torch.log10(
        torch.clamp(torch.sum(ref * ref), min=1e-30)
        / torch.clamp(torch.sum(err * err), min=1e-30)))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def dryrun_rank(device_type: str) -> dict:
    """One rank's part of :func:`dryrun_multichip`, inside a started
    process group: the mesh (``time = 2`` when the rank count is even),
    two sharded steps of the rank-8 chain on DC input against two
    single-process steps (>= 95 dB each), then the time-sharded ILUFS gate
    (within 1e-5 relative of the sequential meter) and the global mean
    square, true peak and correlation against their local values."""
    import torch.distributed as dist

    from lsp_dsp_units_tpu_torch.models.meters.loudness import ILUFSMeter
    from lsp_dsp_units_tpu_torch.ops import biquad_block
    from lsp_dsp_units_tpu_torch.parallel import mesh as pmesh
    from lsp_dsp_units_tpu_torch.parallel.meters import (
        global_correlation, global_mean_square, global_true_peak,
        ilufs_integrated_time_sharded)

    n = dist.get_world_size()
    time = 2 if n % 2 == 0 and n >= 2 else 1
    chan = n // time
    mesh = pmesh.make_mesh(chan, time, device_type)
    dev = pmesh.mesh_device(mesh)
    tg = mesh.get_group(pmesh.TIME_AXIS)

    channels = max(chan * 2, 4)
    chain = FilterConvChain(48000, channels, rank=8, ir_seconds=0.02,
                            device=dev)
    params = chain.build()
    state = chain.init_state(params)
    t = chain.block * 2 * time
    x = torch.full((channels, t), 0.1, dtype=torch.float32, device=dev)

    step = chain.sharded_step(mesh, params)
    st, xl = pmesh.chan_sharding(mesh, state), pmesh.chan_time_sharding(
        mesh, x)
    st, y1 = step(st, xl)
    _check(y1.shape == xl.shape, f"output shape {tuple(y1.shape)}")
    _check(bool(torch.isfinite(y1).all()), "non-finite output")
    st, y2 = step(st, xl)          # the carried state
    ys = [pmesh.gather_chan_time(mesh, y) for y in (y1, y2)]
    st_ref, y_ref = chain.step(params, state, x)
    _, y2_ref = chain.step(params, st_ref, x)
    snrs = [_snr_db(r, y) for r, y in zip((y_ref, y2_ref), ys)]
    _check(min(snrs) >= 95.0, f"sharded vs single-process below 95 dB: "
           f"{snrs}")

    # the meters' collectives over the same mesh (100 ms quarters of 800
    # samples at 8 kHz, 4 a time rank)
    meter = ILUFSMeter(sample_rate=8000, channels=channels,
                       max_int_time_s=10.0, device=dev)
    blk = meter.blk_size
    rng = np.random.default_rng(3)
    xm = torch.from_numpy((rng.normal(size=(channels, time * 4 * blk))
                           * 0.2).astype(np.float32)).to(dev)
    st_m, _ = meter.process(meter.init_state(), xm)
    loud_ref = float(st_m.loudness)
    fp = biquad_block.precompute_fused(meter._coeffs.cpu().numpy(), blk,
                                       device=dev)
    xs = pmesh.time_sharding(mesh, xm)
    loud = float(ilufs_integrated_time_sharded(meter, fp, xs, tg))
    ms = global_mean_square(xs, tg)
    tp = global_true_peak(xs, tg)
    cor = global_correlation(xs, torch.roll(xs, 1, dims=0), tg)
    _check(abs(loud - loud_ref) <= 1e-5 * max(loud_ref, 1e-9),
           f"sharded ILUFS gate {loud} != sequential {loud_ref}")
    x64 = xm.double()
    _check(torch.allclose(ms.double(), (x64 ** 2).mean(-1), rtol=1e-5),
           "global mean square")
    _check(torch.allclose(tp.double(), x64.abs().amax(-1), rtol=1e-6),
           "global true peak")
    _check(bool(torch.isfinite(cor).all()), "non-finite correlation")
    return dict(mesh=(chan, time), snr_db=snrs, ilufs_sharded=loud,
                ilufs_sequential=loud_ref)


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 300.0) -> dict:
    """The JAX package's ``dryrun_multichip`` on ``n_devices`` ranks: the
    full chain step over a ('chan', 'time') mesh (channels data-parallel,
    time split with halos, the summary-exchange IIR and the all-gathered
    dynamics), two steps against the single-process step, and the global
    meters.  Returns rank 0's readings.

    One rank runs in this process (NCCL on the card, gloo on the CPU; no
    process group may be running).  More ranks run in spawned processes,
    one a card (``device="cuda"``, at most ``torch.cuda.device_count()``)
    or one gloo process a rank (``device="cpu"``).
    """
    import torch.distributed as dist

    from lsp_dsp_units_tpu_torch.parallel import launch
    from lsp_dsp_units_tpu_torch.parallel.mesh import init_distributed

    kind = torch.device(device).type
    if kind == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(f"dryrun_multichip({n_devices}): "
                           f"{torch.cuda.device_count()} CUDA devices")
    if n_devices > 1:
        return launch.spawn(dryrun_rank, n_devices, args=(kind,),
                            device=kind, timeout=timeout)[0]
    init_distributed(num_processes=1, process_id=0, platform=kind,
                     timeout=timeout)
    try:
        return dryrun_rank(kind)
    finally:
        dist.destroy_process_group()
