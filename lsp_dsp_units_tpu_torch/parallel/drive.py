"""The sharded layer on global arrays, one rank's part: each function
here cuts global numpy inputs into this rank's shard, runs a function of
``parallel/`` (or ``FilterConvChain.sharded_step``) and gathers the
global result, so that a run over N ranks can be held against a
single-process computation of the same inputs.

    results = launch.spawn(run_cases, n, args=(chan, time, cases),
                           device="cpu")

``cases`` maps a name to ``(kind, kwargs)``, a kind being the name of
one of the functions below; ``run_cases`` builds the
('chan', 'time') mesh over gloo ranks on the CPU and returns ``{name:
result}`` for this rank.  Results that the JAX package replicates (carried
states, meter values) come back as this rank's copy, so a caller can check
that every rank holds the same.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.parallel import mesh as pm


def _t(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32)).to(dev)


def left_halo(mesh, x, overlap: int):
    """x [C, T] sharded (chan, time) -> each shard's halo, gathered [C,
    time x overlap]."""
    from lsp_dsp_units_tpu_torch.parallel.halo import left_halo as halo
    y = halo(pm.chan_time_sharding(mesh, x), overlap,
             mesh.get_group(pm.TIME_AXIS))
    return pm.gather_chan_time(mesh, y)


def fir(mesh, ir, block: int, xs, carry: bool):
    """Calls x [C, T] of the halo FIR (time-sharded, every channel), with
    the FDL carried from call to call when ``carry``."""
    from lsp_dsp_units_tpu_torch.ops import fftconv
    from lsp_dsp_units_tpu_torch.parallel.halo import fir_conv_time_sharded
    dev, tg = pm.mesh_device(mesh), mesh.get_group(pm.TIME_AXIS)
    h = fftconv.parse_ir(_t(ir, dev), block)
    st = fftconv.init_fdl(h, (xs[0].shape[0],), dev) if carry else None
    ys = []
    for x in xs:
        xl = pm.time_sharding(mesh, x)
        if carry:
            y, st = fir_conv_time_sharded(h, block, xl, tg, carry=st)
        else:
            y = fir_conv_time_sharded(h, block, xl, tg)
        ys.append(pm.gather_time(mesh, y))
    return dict(y=ys, carry=st)


def biquad_time(mesh, coeffs, x):
    """The time-sharded biquad cascade [K, 5] on x [C, T] from zero
    state: (y gathered, this rank's state')."""
    from lsp_dsp_units_tpu_torch.ops import biquad
    from lsp_dsp_units_tpu_torch.parallel.time_iir import (
        biquad_cascade_time_sharded)
    dev = pm.mesh_device(mesh)
    st = biquad.init_state(len(coeffs), (x.shape[0],), device=dev)
    y, s = biquad_cascade_time_sharded(_t(coeffs, dev), st,
                                       pm.time_sharding(mesh, x),
                                       mesh.get_group(pm.TIME_AXIS))
    return dict(y=pm.gather_time(mesh, y), state=s)


def fused_time(mesh, coeffs, block: int, x):
    """The time-sharded fused cascade of ``coeffs`` at ``block`` on x
    [C, T] from zero state: (y gathered, this rank's state')."""
    from lsp_dsp_units_tpu_torch.ops import biquad_block as bb
    from lsp_dsp_units_tpu_torch.parallel.fused_iir import (
        fused_cascade_time_sharded)
    dev = pm.mesh_device(mesh)
    fp = bb.precompute_fused(np.asarray(coeffs), block, device=dev)
    st = bb.init_state(len(coeffs), (x.shape[0],), dev)
    y, s = fused_cascade_time_sharded(fp, st, pm.time_sharding(mesh, x),
                                      mesh.get_group(pm.TIME_AXIS))
    return dict(y=pm.gather_time(mesh, y), state=s)


def meters(mesh, x, y, both_axes: bool):
    """The global meters of x, y [C, T] time-sharded, reduced over the
    time group or (``both_axes``) over (chan, time)."""
    from lsp_dsp_units_tpu_torch.parallel.meters import (
        global_correlation, global_mean_square, global_true_peak)
    groups = (tuple(mesh.get_group(a) for a in (pm.CHAN_AXIS, pm.TIME_AXIS))
              if both_axes else mesh.get_group(pm.TIME_AXIS))
    xs, ys = pm.time_sharding(mesh, x), pm.time_sharding(mesh, y)
    return dict(ms=global_mean_square(xs, groups),
                tp=global_true_peak(xs, groups),
                cor=global_correlation(xs, ys, groups))


def ilufs(mesh, x, sample_rate: int):
    """Integrated loudness of x [C, T] time-sharded (K-weighted)."""
    from lsp_dsp_units_tpu_torch.models.meters.loudness import ILUFSMeter
    from lsp_dsp_units_tpu_torch.ops import biquad_block as bb
    from lsp_dsp_units_tpu_torch.parallel.meters import (
        ilufs_integrated_time_sharded)
    dev = pm.mesh_device(mesh)
    meter = ILUFSMeter(sample_rate, channels=x.shape[0],
                       max_int_time_s=10.0, device=dev)
    fp = bb.precompute_fused(meter._coeffs.cpu().numpy(), meter.blk_size,
                             device=dev)
    return ilufs_integrated_time_sharded(meter, fp, pm.time_sharding(mesh, x),
                                         mesh.get_group(pm.TIME_AXIS))


def chain(mesh, xs, channels: int, rank: int, ir_seconds: float):
    """Calls x [C, T] of ``FilterConvChain(48000, channels, rank,
    ir_seconds).sharded_step`` from its initial state: the outputs
    gathered, and this rank's final (channel-sharded) state."""
    from lsp_dsp_units_tpu_torch.pipeline import FilterConvChain
    dev = pm.mesh_device(mesh)
    ch = FilterConvChain(48000, channels, rank=rank, ir_seconds=ir_seconds,
                         device=dev)
    params = ch.build()
    step = ch.sharded_step(mesh, params)
    st = pm.chan_sharding(mesh, ch.init_state(params))
    ys = []
    for x in xs:
        st, y = step(st, pm.chan_time_sharding(mesh, x))
        ys.append(pm.gather_chan_time(mesh, y))
    return dict(y=ys, state=st)


def chain_grad(mesh, x, channels: int, rank: int, ir_seconds: float):
    """One call of ``FilterConvChain(48000, channels, rank,
    ir_seconds).sharded_step`` on x [C, T] from its initial state, each
    rank's loss the sum of its output shard squared: d/dx gathered [C,
    T], and d/d the compressor's 20 leaves (0-d tensors that require
    grad), this rank's part, whose sum over the ranks is the gradient of
    the whole output's energy."""
    from lsp_dsp_units_tpu_torch import convert
    from lsp_dsp_units_tpu_torch.pipeline import FilterConvChain
    from lsp_dsp_units_tpu_torch.utils.tree import tree_flatten
    dev = pm.mesh_device(mesh)
    ch = FilterConvChain(48000, channels, rank=rank, ir_seconds=ir_seconds,
                         device=dev)
    params = ch.build()
    params = params._replace(comp=convert.compressor_params_from_jax(
        params.comp, dev, requires_grad=True))
    xl = pm.chan_time_sharding(mesh, x).requires_grad_(True)
    _, y = ch.sharded_step(mesh, params)(
        pm.chan_sharding(mesh, ch.init_state(params)), xl)
    torch.sum(y * y).backward()
    return dict(x=pm.gather_chan_time(mesh, xl.grad),
                comp=[torch.zeros(()) if v.grad is None else v.grad
                      for v in tree_flatten(params.comp)[0]])


KINDS = dict(left_halo=left_halo, fir=fir, biquad_time=biquad_time,
             fused_time=fused_time, meters=meters, ilufs=ilufs, chain=chain,
             chain_grad=chain_grad)


def run_cases(chan: int, time: int,
              cases: Dict[str, Tuple[str, dict]]) -> dict:
    """Rank body for ``launch.spawn`` (gloo, CPU): every case on one
    (chan, time) mesh."""
    mesh = pm.make_mesh(chan, time, "cpu")
    return {name: KINDS[kind](mesh, **kw)
            for name, (kind, kw) in cases.items()}
