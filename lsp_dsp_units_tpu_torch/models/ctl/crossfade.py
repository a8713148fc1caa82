"""Crossfade: linear fade between two sources over N samples
(reference: src/main/ctl/Crossfade.cpp), the port of
models/ctl/crossfade.py.  The state stays two 0-d tensors (the JAX
unit's), so a checkpoint of either package loads into the other.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class CrossfadeState(NamedTuple):
    counter: torch.Tensor   # [] int32 remaining fade samples
    gain: torch.Tensor      # [] float32 current fade-in gain


def _state(counter, gain, device) -> CrossfadeState:
    return CrossfadeState(
        counter=torch.as_tensor(counter, dtype=torch.int32, device=device),
        gain=torch.as_tensor(gain, dtype=torch.float32, device=device))


class Crossfade:
    def __init__(self, sample_rate: int = 48000, time_s: float = 0.005):
        self.samples = max(1, int(sample_rate * time_s))
        self.delta = 1.0 / self.samples

    def init_state(self, device="cuda") -> CrossfadeState:
        # the reference's construct() starts with fGain = 1.0
        # (Crossfade.cpp:44), so a never-toggled crossfade passes the new
        # (fade-in) source; reset() is what zeroes it
        return _state(0, 1.0, device)

    def reset(self, state: CrossfadeState) -> CrossfadeState:
        """(reference Crossfade::reset, Crossfade.cpp:61-64)"""
        return _state(0, 0.0, state.gain.device)

    def toggle(self, state: CrossfadeState) -> CrossfadeState:
        """Restart the fade (reference Crossfade::toggle), only when not
        already active."""
        active = state.counter > 0
        return CrossfadeState(
            counter=torch.where(active, state.counter,
                                torch.full_like(state.counter, self.samples)),
            gain=torch.where(active, state.gain,
                             torch.zeros_like(state.gain)))

    def process(self, state: CrossfadeState, fade_out: Optional[torch.Tensor],
                fade_in: Optional[torch.Tensor], count: int
                ) -> Tuple[CrossfadeState, torch.Tensor]:
        """Mix fade_out -> fade_in across the running fade window
        (reference Crossfade.cpp:96-220)."""
        dev = state.gain.device
        n = torch.arange(count, dtype=torch.float32, device=dev)
        g = torch.clamp(state.gain + self.delta * n, 0.0, 1.0)
        active = n < state.counter.to(torch.float32)
        # past the window: 1 once the fade has run (a decision; the JAX
        # unit forms delta * counter at its default float width)
        done = (state.gain.double() + self.delta * state.counter.double()
                ) > 0.0
        g_eff = torch.where(active, g, done.to(torch.float32))
        if fade_in is None and fade_out is None:
            out = torch.zeros(count, dtype=torch.float32, device=dev)
        elif fade_out is None:
            out = fade_in * g_eff
        elif fade_in is None:
            out = fade_out * (1.0 - g_eff)
        else:
            out = fade_out * (1.0 - g_eff) + fade_in * g_eff
        used = torch.clamp(state.counter, max=count)
        return CrossfadeState(
            counter=state.counter - used,
            gain=state.gain + self.delta * used.to(torch.float32)), out

    def active(self, state: CrossfadeState) -> torch.Tensor:
        return state.counter > 0
