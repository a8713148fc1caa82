"""Halo exchange along a time-sharded axis: the port of parallel/halo.py.

Overlap-save FFT convolution needs the previous ``K - 1`` input samples at
each block boundary; when time is sharded across ranks, those samples live
on the left neighbour and arrive by point-to-point sends over the time
group (``mesh.ppermute_right``, the JAX package's ``ppermute``).
"""

from __future__ import annotations

import torch

from lsp_dsp_units_tpu_torch.ops import fftconv
from lsp_dsp_units_tpu_torch.ops.cplx import rfft_sc
from lsp_dsp_units_tpu_torch.parallel.mesh import (
    Group, axis_index, ppermute_right, replicate_last)


def left_halo(x: torch.Tensor, overlap: int, group: Group) -> torch.Tensor:
    """The last ``overlap`` samples before this rank's shard x [...,
    T_local]: [..., overlap], zeros for the part before sample 0.  When
    ``overlap > T_local`` the halo spans several shards and is assembled
    by chained hops."""
    t_local = x.shape[-1]
    if overlap <= t_local:
        return ppermute_right(x[..., -overlap:], group)
    # piece k (k = 1 nearest) comes from the k-th left neighbour
    hops = -(-overlap // t_local)
    pieces = []
    shard = x
    got = 0
    for _ in range(hops):
        shard = ppermute_right(shard, group)
        take = min(t_local, overlap - got)
        pieces.append(shard[..., -take:])
        got += take
    return torch.cat(pieces[::-1], dim=-1)


def fir_conv_time_sharded(h_spectra: fftconv.Spectra, block: int,
                          x: torch.Tensor, group: Group, carry=None):
    """Exact FIR convolution of a time-sharded signal: local FDL + halo.

    Each rank pulls ``(P + 1) * block`` halo samples from its left
    neighbour(s) (P partitions of history for the FDL spectra plus one
    block of overlap-save history), by chained hops where the halo is
    longer than a shard.

    Args:
      h_spectra: [P, B + 1] IR spectra (ops.fftconv.parse_ir).
      block: partition block size B.
      x: [..., T_local], T_local a multiple of ``block``.
      group: the time axis's process group.
      carry: optional ``fftconv.FDLState``, the stream state at the end of
        the previous call (the same on every time rank).  Without it,
        halo blocks before the call's start are zeros: right only at the
        stream's start.

    Returns y [..., T_local], this rank's shard of the causal convolution;
    with ``carry``, ``(y, new_carry)``, the stream state after this call,
    the same on every time rank.
    """
    p = h_spectra.re.shape[-2]
    halo = (p + 1) * block
    t_local = x.shape[-1]
    if halo <= t_local:
        hist = ppermute_right(x[..., -halo:], group)
    else:
        chunks = []
        need = halo
        chunk = x
        while need > 0:
            chunk = ppermute_right(chunk, group)
            chunks.insert(0, chunk)
            need -= t_local
        hist = torch.cat(chunks, dim=-1)[..., -halo:]

    # warm the FDL with the P halo blocks (newest at index 0), then run
    # the local shard
    warm = hist.reshape(hist.shape[:-1] + (p + 1, block))
    shift = axis_index(group) * (t_local // block)
    if carry is not None and shift <= p:
        # with this rank starting ``shift`` blocks into the call, warm
        # index k holds absolute block start - 1 - P + k; blocks before
        # the call's start arrived as zeros.  The newest of them (k = P -
        # shift) is the carried history: patch it so the frame that
        # straddles the call's start is right.
        warm = warm.clone()
        warm[..., p - shift, :] = carry.history

    # FDL slot q (newest first) is the frame of warm blocks P - 1 - q and
    # P - q.  With a carry, slots q >= shift hold frames wholly before the
    # call's start, which the carried state's slots q - shift already
    # hold: only the newest min(shift, P) frames are transformed (the JAX
    # package transforms all P and overwrites the older ones)
    fresh = p if carry is None else min(shift, p)
    spec_re, spec_im = [], []
    if fresh:
        frames = torch.cat([warm[..., p - fresh:-1, :],
                            warm[..., p - fresh + 1:, :]], dim=-1)
        sre, sim = rfft_sc(frames)
        spec_re.append(torch.flip(sre, dims=(-2,)))
        spec_im.append(torch.flip(sim, dims=(-2,)))
    if fresh < p:
        spec_re.append(carry.spec_re[..., :p - fresh, :])
        spec_im.append(carry.spec_im[..., :p - fresh, :])
    st = fftconv.FDLState(spec_re=torch.cat(spec_re, dim=-2),
                          spec_im=torch.cat(spec_im, dim=-2),
                          history=warm[..., -1, :].contiguous())

    fin, y = fftconv.fdl_process(h_spectra, st, x)
    if carry is None:
        return y
    # the last time rank's final FDL is the stream state after this call
    return y, fftconv.FDLState(*(replicate_last(v, group) for v in fin))
