"""Bypass: click-free dry/wet crossfade switch
(reference: src/main/ctl/Bypass.cpp:106-208), the port of
models/ctl/bypass.py.

State: the current ramp gain in [0, 1] (0 = wet / on-path, 1 = dry /
bypassed, the reference's convention) and the per-sample delta.  The
linear ramp is closed-form over a block: gain[n] = clip(g0 + delta n, 0,
1).  Each product and sum is rounded on its own, as the JAX unit's
element-wise operations are, so both agree bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class BypassState(NamedTuple):
    gain: torch.Tensor     # [...] current dry mix gain
    delta: torch.Tensor    # [...] per-sample ramp increment (+ towards dry)


class Bypass:
    def __init__(self, sample_rate: int = 48000, time_ms: float = 5.0):
        self.sample_rate = int(sample_rate)
        length = max(1.0, time_ms * 0.001 * sample_rate)
        self.step = 1.0 / length

    def init_state(self, batch_shape: Tuple[int, ...] = (),
                   bypassed: bool = False, device="cuda") -> BypassState:
        g = 1.0 if bypassed else 0.0
        return BypassState(
            gain=torch.full(tuple(batch_shape), g, dtype=torch.float32,
                            device=device),
            delta=torch.zeros(tuple(batch_shape), dtype=torch.float32,
                              device=device))

    def set_bypass(self, state: BypassState, bypass) -> BypassState:
        """Switch target (reference Bypass::set_bypass): ramps toward dry
        when True, toward wet when False (a bool or a bool tensor)."""
        on = torch.as_tensor(bypass, device=state.delta.device)
        d = torch.where(on, self.step, -self.step).to(torch.float32)
        return state._replace(delta=torch.broadcast_to(
            d, state.delta.shape).clone())

    def process(self, state: BypassState, dry: torch.Tensor,
                wet: torch.Tensor) -> Tuple[BypassState, torch.Tensor]:
        """Mix dry/wet across the block with the running ramp:
        out = wet + (dry - wet) gain.  The reference emits with the
        current gain and increments afterwards, so sample 0 still carries
        the pre-ramp gain."""
        t = dry.shape[-1]
        n = torch.arange(t, dtype=torch.float32, device=dry.device)
        g = torch.clamp(state.gain[..., None] + state.delta[..., None] * n,
                        0.0, 1.0)
        out = wet + (dry - wet) * g
        new_gain = torch.clamp(state.gain + state.delta * t, 0.0, 1.0)
        return state._replace(gain=new_gain), out

    def is_bypassed(self, state: BypassState) -> torch.Tensor:
        return state.gain >= 1.0
