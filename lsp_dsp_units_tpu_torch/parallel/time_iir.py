"""Exact IIR biquad cascades over a time-sharded axis: the port of
parallel/time_iir.py.

Each rank computes the prefix affine maps of its local block
(ops.biquad.stage_prefix); the rank's summary (the 2x2 end-of-block
matrix product and the zero-state response, 6 floats a stage and row) is
all-gathered over the time group; every rank then composes its true
incoming state and finishes locally (ops.biquad.stage_apply).  Traffic per
stage is 6 floats a rank and row, whatever the block length.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lsp_dsp_units_tpu_torch.ops import biquad as biquad_ops
from lsp_dsp_units_tpu_torch.parallel.mesh import (
    Group, all_gather, axis_index, replicate_last)


def _stage_sharded(x: torch.Tensor, b0, b1, b2, a1, a2,
                   s_global: torch.Tensor, group: Group
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One stage over a time-sharded last axis.  ``s_global`` [..., 2] is
    the stream state entering the first shard.  Returns (y_local,
    s_out_global), the state after the last shard, on every rank."""
    a_scan, v_scan = biquad_ops.stage_prefix(x, b0, b1, b2, a1, a2)
    # local summary s_out = A_loc s_in + v_loc: [..., 6] = A (4) || v (2)
    summary = torch.stack([p[..., -1] for p in a_scan + v_scan], dim=-1)
    every = all_gather(summary, group)                 # [n, ..., 6]
    # compose the predecessors serially (n is the rank count: small); this
    # rank's incoming state is taken by index, so that every rank's graph
    # holds every summary and reaches the gather's backward
    s = [s_global]
    for i in range(every.shape[0]):
        a00, a01, a10, a11, v0, v1 = every[i].unbind(-1)
        s.append(torch.stack([a00 * s[i][..., 0] + a01 * s[i][..., 1] + v0,
                              a10 * s[i][..., 0] + a11 * s[i][..., 1] + v1],
                             dim=-1))
    s_in = torch.stack(s[:-1])[axis_index(group)]
    y, _ = biquad_ops.stage_apply(x, b0, a_scan, v_scan, s_in)
    return y, replicate_last(s[-1], group)


def biquad_cascade_time_sharded(coeffs: torch.Tensor, state: torch.Tensor,
                                x: torch.Tensor, group: Group
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serial biquad cascade over a time-sharded signal (exact).

    Args:
      coeffs: [K, 5] or [..., K, 5], the same on every time rank.
      state: [..., K, 2] stream state entering the first shard.
      x: [..., T_local] this rank's time shard.
      group: the time axis's process group.

    Returns (y_local, state'), state' the stream state after the last
    shard, bitwise the same on every rank.
    """
    y = x
    new_states = []
    for i in range(coeffs.shape[-2]):
        c = coeffs[..., i, :]
        if c.ndim == 1:
            b0, b1, b2, a1, a2 = c.unbind(-1)
        else:
            b0, b1, b2, a1, a2 = (c[..., j:j + 1] for j in range(5))
        y, s = _stage_sharded(y, b0, b1, b2, a1, a2, state[..., i, :],
                              group)
        new_states.append(s)
    return y, torch.stack(new_states, dim=-2)
