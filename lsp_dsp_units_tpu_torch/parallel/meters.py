"""Global meter reductions over sharded signals: the port of
parallel/meters.py.  Sums, maxima and the loudness gate are all-reduced
over the mesh's process groups (``groups``: one group, or a tuple of
groups for a reduction over both mesh dimensions).
"""

from __future__ import annotations

import torch

from lsp_dsp_units_tpu_torch.parallel.mesh import (
    Group, Groups, axis_index, groups_size, pmax, ppermute_right, psum,
    zeros_in_graph)


def global_mean_square(x: torch.Tensor, groups: Groups) -> torch.Tensor:
    """Mean square over the whole (sharded) time axis of each row:
    x [..., T_local] -> [...]."""
    total = psum(torch.sum(x * x, dim=-1), groups)
    return total / (x.shape[-1] * groups_size(groups))


def global_true_peak(tp_local: torch.Tensor, groups: Groups) -> torch.Tensor:
    """Max-reduce per-sample true-peak values across shards."""
    return pmax(torch.amax(torch.abs(tp_local), dim=-1), groups)


def global_correlation(a: torch.Tensor, b: torch.Tensor,
                       groups: Groups) -> torch.Tensor:
    """Normalized correlation over the whole sharded signals."""
    sums = psum(torch.stack([torch.sum(a * b, dim=-1),
                             torch.sum(a * a, dim=-1),
                             torch.sum(b * b, dim=-1)]), groups)
    sxy, sxx, syy = sums.unbind(0)
    return sxy / torch.sqrt(torch.clamp(sxx * syy, min=1e-36))


def _gated_mean(loud: torch.Tensor, above: torch.Tensor,
                group: Group) -> torch.Tensor:
    s, n = psum(torch.stack([torch.sum(torch.where(above, loud, 0.0)),
                             torch.sum(above.to(loud.dtype))]),
                group).unbind(0)
    return torch.where(n > 0, s / torch.clamp(n, min=1.0), 0.0)


def global_loudness_blocks(block_loudness: torch.Tensor, group: Group,
                           abs_thresh: float, rel_thresh: float,
                           valid: torch.Tensor = None) -> torch.Tensor:
    """Two-stage BS.1770 gated mean over time-sharded 400 ms block
    loudness values: block_loudness [M_local] per rank -> the integrated
    loudness, a 0-d tensor.  ``valid`` [M_local] bool masks positions
    that hold no block (the first shard's warm-up quarters)."""
    above = block_loudness > abs_thresh
    if valid is not None:
        above = above & valid
    l1 = _gated_mean(block_loudness, above, group)
    gate = torch.clamp(l1 * rel_thresh, min=abs_thresh)
    above2 = block_loudness > gate
    if valid is not None:
        above2 = above2 & valid
    return _gated_mean(block_loudness, above2, group)


def ilufs_integrated_time_sharded(meter, fparams, x_local: torch.Tensor,
                                  group: Group) -> torch.Tensor:
    """Integrated BS.1770-5 loudness of a time-sharded signal:

    1. the K-weighting IIR exactly across the shard boundaries
       (parallel.fused_iir);
    2. local 100 ms quarter square-sums; the 3 quarters before each shard
       arrive from the left neighbour, so the 75 %-overlapped 400 ms
       gating blocks that straddle boundaries are formed exactly;
    3. the two-stage gated mean over every rank's block loudness
       (:func:`global_loudness_blocks`).

    ``meter`` is the port's ``ILUFSMeter`` (sizes and channel weights);
    ``fparams`` its weighting cascade from
    ``ops.biquad_block.precompute_fused(coeffs, block=meter.blk_size)``
    (None: no weighting).  x_local: [C, T_local], T_local a multiple of
    ``meter.blk_size``.  Returns the integrated loudness (power domain,
    the sequential meter's ``state.loudness`` after the whole signal), the
    same on every rank.
    """
    from lsp_dsp_units_tpu_torch.models.meters.loudness import (
        GATING_ABS_THRESH, GATING_REL_THRESH)
    from lsp_dsp_units_tpu_torch.ops import biquad_block
    from lsp_dsp_units_tpu_torch.parallel.fused_iir import (
        fused_cascade_time_sharded)

    c, t_loc = x_local.shape[0], x_local.shape[-1]
    if t_loc % meter.blk_size:
        raise ValueError(f"shard of {t_loc} samples is not a multiple of "
                         f"the quarter {meter.blk_size}")
    m = t_loc // meter.blk_size
    if m < 3:
        raise ValueError("each shard must hold at least 3 gating quarters")

    if fparams is not None:
        st0 = biquad_block.init_state(meter._coeffs.shape[0], (c,),
                                      x_local.device)
        y, _ = fused_cascade_time_sharded(fparams, st0, x_local, group)
    else:
        y = x_local

    # channel-weighted quarter loudness contributions [m]
    sq = torch.sum((y * y).reshape(c, m, meter.blk_size), dim=-1)
    q = torch.sum(meter.weights[:, None] * sq, dim=0) * meter.avg_coeff

    # the left neighbour's last 3 quarters (a cyclic exchange, rank 0's
    # masked, as in the JAX package)
    halo = ppermute_right(q[-3:], group, cyclic=True)
    idx = axis_index(group)
    if idx == 0:
        halo = zeros_in_graph(halo)
    qh = torch.cat([halo, q], dim=0)                   # [m + 3]
    blocks = qh[3:] + qh[2:-1] + qh[1:-2] + qh[:-3]    # [m]
    gidx = idx * m + torch.arange(m, device=q.device)
    valid = gidx >= 3                  # a full block needs 4 quarters
    return global_loudness_blocks(blocks, group, GATING_ABS_THRESH,
                                  GATING_REL_THRESH, valid=valid)
