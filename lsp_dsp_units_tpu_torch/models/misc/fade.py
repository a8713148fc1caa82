"""Linear fade-in / fade-out ramps on torch tensors: the port of
models/misc/fade.py (reference: src/main/misc/fade.cpp)."""

from __future__ import annotations

import torch


def fade_in(x: torch.Tensor, fade_len: int) -> torch.Tensor:
    """Linear fade over the first ``fade_len`` samples of the last axis."""
    if fade_len <= 0:
        return x
    i = torch.arange(x.shape[-1], dtype=x.dtype, device=x.device)
    return x * torch.clamp(i / float(fade_len), max=1.0)


def fade_out(x: torch.Tensor, fade_len: int) -> torch.Tensor:
    """Linear fade over the last ``fade_len`` samples of the last axis."""
    if fade_len <= 0:
        return x
    n = x.shape[-1]
    i = torch.arange(n, dtype=x.dtype, device=x.device)
    # gain = (n-1-i)/fade_len clipped to [0,1], with the final sample at 0
    return x * torch.clamp((n - 1 - i) / float(fade_len), 0.0, 1.0)
