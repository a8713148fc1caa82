"""Correlometer: normalized sliding correlation of two signals, the port
of models/meters/correlometer.py (reference: src/main/meters/
Correlometer.cpp).

``corr[n] = sum(xy) / sqrt(sum(x^2) * sum(y^2))`` over the trailing
window.  The reference updates the three sums incrementally with a
periodic full recompute to cancel float drift (Correlometer.cpp:
134-180); here each call recomputes them as prefix-sum differences
(``ops/sliding``), which bounds drift per call by construction.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from lsp_dsp_units_tpu_torch.ops.sliding import sliding_sum


class CorrelometerState(NamedTuple):
    win_a: torch.Tensor    # [..., N]
    win_b: torch.Tensor    # [..., N]


class Correlometer:
    def __init__(self, window: int):
        self.window = int(window)

    def init_state(self, batch_shape: Tuple[int, ...] = (),
                   device="cuda") -> CorrelometerState:
        shape = tuple(batch_shape) + (self.window,)
        return CorrelometerState(
            win_a=torch.zeros(shape, dtype=torch.float32, device=device),
            win_b=torch.zeros(shape, dtype=torch.float32, device=device))

    def process(self, state: CorrelometerState, a: torch.Tensor,
                b: torch.Tensor) -> Tuple[CorrelometerState, torch.Tensor]:
        n = self.window
        t = a.shape[-1]
        fa = torch.cat([state.win_a, a], dim=-1)
        fb = torch.cat([state.win_b, b], dim=-1)
        s_xy = sliding_sum(fa * fb, n, t)
        s_xx = sliding_sum(fa * fa, n, t)
        s_yy = sliding_sum(fb * fb, n, t)
        den = torch.sqrt(torch.clamp(s_xx * s_yy, min=0.0))
        corr = torch.where(den > 1e-18, s_xy / torch.clamp(den, min=1e-18),
                           0.0)
        return CorrelometerState(win_a=fa[..., -n:].contiguous(),
                                 win_b=fb[..., -n:].contiguous()), corr
