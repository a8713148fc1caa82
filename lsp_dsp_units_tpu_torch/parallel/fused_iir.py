"""Time-sharded execution of the fused block cascade (exact): the port of
parallel/fused_iir.py.

The fused cascade (ops.biquad_block.FusedCascadeParams) decomposes each
block as ``y = y_zero(x) + G s`` / ``s' = M s + W x``.  Across a
time-sharded axis each rank:

1. runs its local blocks from zero state (ops.biquad_block.
   cascade_block_fused: the per-block zero-state outputs through the
   packed FFT kernel #1 where the frame size routes there, and the state
   ``d`` its input alone leaves at the shard's end);
2. all-gathers the ``d`` summaries (2K floats a rank and row) and
   composes its true incoming state serially (the rank count is small);
3. corrects its outputs in closed form, ``y[j] += G M^j s_in``: nothing
   is computed twice.

The transitions M^m and G M^j are computed on the host in float64 and
rounded once to float32, as the fused kernel's own matrices are.  The
small contractions are broadcast multiply-and-sums
(``biquad_block._matvec``), pinned in code: no library matmul, so global
TF32 settings cannot change them (the JAX package pins them at
``Precision.HIGH``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.ops import biquad_block as bb
from lsp_dsp_units_tpu_torch.parallel.mesh import (
    Group, all_gather, axis_index, replicate_last)


def host_m_powers(params: bb.FusedCascadeParams, m_blocks: int):
    """(M^m [2K, 2K], [G M^j for j < m] [m, B, 2K]) in float64 on the
    host, rounded once to float32, on the params' device.  The JAX package
    falls back to a traced float32 chain when its params are tracers; the
    port's params are always concrete tensors, so it keeps the host
    branch, the one the JAX package's ``sharded_step`` takes."""
    m64 = params.m_mat.detach().cpu().double().numpy()
    g64 = params.g_mat.detach().cpu().double().numpy()
    pows = [np.eye(m64.shape[0])]
    for _ in range(m_blocks):
        pows.append(m64 @ pows[-1])
    gm = np.stack([g64 @ pows[j] for j in range(m_blocks)], 0)
    dev = params.m_mat.device
    return (torch.from_numpy(pows[m_blocks].astype(np.float32)).to(dev),
            torch.from_numpy(gm.astype(np.float32)).to(dev))


def fused_cascade_time_sharded(params: bb.FusedCascadeParams,
                               state: torch.Tensor, x: torch.Tensor,
                               group: Group, powers=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., T_local] (a multiple of B) on this rank; ``state`` [..., K,
    2] the stream state entering the first shard (the same on every
    rank).  ``powers`` is :func:`host_m_powers` for T_local / B blocks,
    computed here when None (a round trip to the host: pass it to keep a
    stream of calls from waiting on the device).  Returns (y_local,
    state_out), the state after the last shard, bitwise the same on every
    rank."""
    b = bb.fused_block_size(params)
    k2 = params.m_mat.shape[0]
    t_loc = x.shape[-1]
    if t_loc % b:
        raise ValueError(f"shard of {t_loc} samples is not a multiple of "
                         f"the block {b}")
    m_blocks = t_loc // b

    # 1. local pass from zero state: y_zero and d, the state the local
    #    input alone leaves at the shard's end
    zero = torch.zeros(x.shape[:-1] + state.shape[-2:], dtype=torch.float32,
                       device=x.device)
    y_zero, d_dev = bb.cascade_block_fused(params, zero, x)
    d_dev = d_dev.reshape(d_dev.shape[:-2] + (k2,))

    # 2. exchange summaries; every rank's transition is M^m
    m_shard, gm = powers or host_m_powers(params, m_blocks)
    d_all = all_gather(d_dev, group)                   # [n, ..., 2K]
    # the state entering each shard, composed serially (the rank count is
    # small); this rank's is taken by index, so that every rank's graph
    # holds the gathered summaries and reaches the gather's backward
    s_ins = [state.reshape(state.shape[:-2] + (k2,))]
    for i in range(d_all.shape[0] - 1):
        s_ins.append(bb._matvec(m_shard, s_ins[-1]) + d_all[i])
    s_in = torch.stack(s_ins)[axis_index(group)]

    # 3. closed-form correction y[j] += G M^j s_in, gm [m, B, 2K]
    lead = s_in.shape[:-1]
    gmb = gm.reshape((m_blocks,) + (1,) * len(lead) + gm.shape[1:])
    corr = bb._matvec(gmb, s_in)                       # [m, ..., B]
    y = y_zero + torch.movedim(corr, 0, -2).reshape(x.shape)

    # the state after the last shard, made the same everywhere
    s_final = bb._matvec(m_shard, s_in) + d_dev
    s_final = replicate_last(s_final, group)
    return y.to(x.dtype), s_final.reshape(state.shape)
