"""Sidechain conditioner: the port of models/util/sidechain.py (reference
Sidechain.cpp, Sidechain.h:35-51).

Source select (stereo -> detector) and level estimation mode:

* PEAK    — |x| * gain.
* RMS     — sliding sum of squares over the reactivity window, sqrt
            (ops/env_units.sliding_rms: the CUDA kernel for CUDA tensors).
* LPF     — one-pole smoother (time-parallel first-order scan).
* UNIFORM — sliding mean of |x| * gain (float64 prefix sums).
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Tuple

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.ops import dynamics as dyn
from lsp_dsp_units_tpu_torch.ops.env_units import sliding_rms
from lsp_dsp_units_tpu_torch.ops.sliding import sliding_sum


class SidechainSource(enum.Enum):
    MIDDLE = "middle"
    SIDE = "side"
    LEFT = "left"
    RIGHT = "right"
    AMIN = "amin"
    AMAX = "amax"


class SidechainMode(enum.Enum):
    PEAK = "peak"
    RMS = "rms"
    LPF = "lpf"
    UNIFORM = "uniform"


class SidechainState(NamedTuple):
    window: torch.Tensor   # [..., N] trailing detector samples (RMS: squared)
    rms: torch.Tensor      # [...] carried accumulator / LPF state


def select_source(left: torch.Tensor, right: torch.Tensor,
                  source: SidechainSource) -> torch.Tensor:
    """Stereo source selection (reference Sidechain::preprocess, stereo
    non-midside path): detector = |selected|."""
    if source == SidechainSource.MIDDLE:
        s = 0.5 * (left + right)
    elif source == SidechainSource.SIDE:
        s = 0.5 * (left - right)
    elif source == SidechainSource.LEFT:
        s = left
    elif source == SidechainSource.RIGHT:
        s = right
    elif source == SidechainSource.AMIN:
        return torch.minimum(torch.abs(left), torch.abs(right))
    else:  # AMAX
        return torch.maximum(torch.abs(left), torch.abs(right))
    return torch.abs(s)


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
                   device="cuda") -> SidechainState:
        n = self.reactivity if self.mode in (SidechainMode.RMS,
                                             SidechainMode.UNIFORM) else 1
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
        if self.mode == SidechainMode.LPF:
            rms, y = dyn.onepole_lowpass(state.rms, x, self.tau)
            return state._replace(rms=rms), torch.clamp(y, min=0.0)
        if self.mode == SidechainMode.RMS:
            win, y = sliding_rms(state.window, x, n, 1.0)
            return state._replace(window=win), y
        # UNIFORM: the prefix sums in float64, so that the mean does not
        # hang on the order a device's cumsum adds in
        frame = torch.cat([state.window, x], dim=-1)
        win = sliding_sum(frame.double(), n, x.shape[-1])
        y = (torch.clamp(win, min=0.0) / n).to(x.dtype)
        return state._replace(window=frame[..., -n:].contiguous()), y
