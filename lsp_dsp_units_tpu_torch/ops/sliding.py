"""Trailing-window running sums: the port of ops/sliding.py.

One prefix sum and a difference replace the per-sample add/subtract
recurrence.  The prefix is two-level (a cumsum within groups of 128
plus a cumsum of the group totals), the same association as the JAX
function, so both packages round alike.
"""

from __future__ import annotations

import torch

_GROUP = 128


def sliding_sum(frame: torch.Tensor, n: int, t: int) -> torch.Tensor:
    """Trailing-window sums over ``frame = [n history, t new]`` (last
    axis): ``out[i] = sum(frame[i+1 .. i+n])`` for i in [0, t)."""
    length = frame.shape[-1]
    if length <= 2 * _GROUP:
        cz = torch.cat([torch.zeros_like(frame[..., :1]),
                        torch.cumsum(frame, dim=-1)], dim=-1)
        return cz[..., n + 1: n + 1 + t] - cz[..., 1: 1 + t]
    pad = (-length) % _GROUP
    fp = torch.nn.functional.pad(frame, (0, pad))
    k = fp.shape[-1] // _GROUP
    g = fp.reshape(fp.shape[:-1] + (k, _GROUP))
    inner = torch.cumsum(g, dim=-1)                    # [..., K, G]
    totals = inner[..., -1]                            # [..., K]
    outer = torch.cumsum(totals, dim=-1) - totals      # exclusive
    p_incl = (inner + outer[..., None]).reshape(fp.shape[:-1]
                                                + (k * _GROUP,))
    return p_incl[..., n: n + t] - p_incl[..., :t]
