"""Sidechain level detector: the port of models/util/sidechain.py
(reference Sidechain.cpp).  The chain uses the RMS mode; its CUDA path
runs the same sliding RMS inside the kernel of ops/env.py.

* PEAK    — |x| * gain.
* RMS     — sliding sum of squares over the reactivity window, sqrt.
* UNIFORM — sliding mean of |x| * gain.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Tuple

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.ops.sliding import sliding_sum


class SidechainMode(enum.Enum):
    PEAK = "peak"
    RMS = "rms"
    UNIFORM = "uniform"


class SidechainState(NamedTuple):
    window: torch.Tensor   # [..., N] trailing detector samples (RMS: squared)
    rms: torch.Tensor      # [...] carried accumulator


class Sidechain:
    def __init__(self, sample_rate: int = 48000,
                 mode: SidechainMode = SidechainMode.RMS,
                 reactivity_ms: float = 10.0, gain: float = 1.0):
        self.sample_rate = int(sample_rate)
        self.mode = mode
        self.reactivity_ms = float(reactivity_ms)
        # reference Sidechain.cpp:119-128
        self.reactivity = max(int(sample_rate * reactivity_ms / 1000.0), 1)
        self.tau = float(
            1.0 - np.exp(np.log(1.0 - np.sqrt(0.5)) / self.reactivity))
        self.gain = float(gain)

    def init_state(self, batch_shape: Tuple[int, ...] = (),
                   device=None) -> SidechainState:
        n = self.reactivity if self.mode != SidechainMode.PEAK else 1
        return SidechainState(
            window=torch.zeros(tuple(batch_shape) + (n,),
                               dtype=torch.float32, device=device),
            rms=torch.zeros(tuple(batch_shape), dtype=torch.float32,
                            device=device))

    def process(self, state: SidechainState, x: torch.Tensor
                ) -> Tuple[SidechainState, torch.Tensor]:
        """x: detector signal [..., T].  Returns (state', level)."""
        x = torch.abs(x) * self.gain
        n = self.reactivity
        if self.mode == SidechainMode.PEAK:
            return state, x
        if self.mode == SidechainMode.RMS:
            frame = torch.cat([state.window, x * x], dim=-1)
            win = sliding_sum(frame, n, x.shape[-1])
            y = torch.sqrt(torch.clamp(win / n, min=0.0))
        else:
            frame = torch.cat([state.window, x], dim=-1)
            y = torch.clamp(sliding_sum(frame, n, x.shape[-1]), min=0.0) / n
        return state._replace(window=frame[..., -n:].contiguous()), y
