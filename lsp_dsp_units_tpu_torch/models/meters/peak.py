"""PeakMeter (peak + hold + release decay) and Panometer (pan position),
the port of models/meters/peak.py (reference: src/main/meters/
PeakMeter.cpp, Panometer.cpp).

PeakMeter's per-sample follower runs in ``ops/riders`` (``csrc/
riders.cu`` on the card); Panometer is element-wise over two sliding
sums (``ops/sliding``).
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Tuple

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.ops import riders
from lsp_dsp_units_tpu_torch.ops.sliding import sliding_sum


class PeakMeterState(NamedTuple):
    peak: torch.Tensor      # [...]
    counter: torch.Tensor   # [...] int32 hold countdown


class PeakMeter:
    """Peak detector with hold and exponential release
    (reference PeakMeter.cpp:101-150 update/process semantics)."""

    def __init__(self, sample_rate: int = 48000, hold_ms: float = 500.0,
                 release_ms: float = 1000.0):
        self.sample_rate = int(sample_rate)
        self.hold = max(0, int(sample_rate * hold_ms / 1000.0))
        rel_samples = max(sample_rate * release_ms / 1000.0, 1.0)
        self.tau = float(np.exp(np.log(1.0 - np.sqrt(0.5)) / rel_samples))

    def init_state(self, batch_shape: Tuple[int, ...] = (),
                   device="cuda") -> PeakMeterState:
        shape = tuple(batch_shape)
        return PeakMeterState(
            peak=torch.zeros(shape, dtype=torch.float32, device=device),
            counter=torch.zeros(shape, dtype=torch.int32, device=device))

    def process(self, state: PeakMeterState, x: torch.Tensor,
                ) -> Tuple[PeakMeterState, torch.Tensor]:
        """x [..., T] -> per-sample held peak [..., T].  As the reference
        (PeakMeter.cpp:130-149), the release decays UNCONDITIONALLY (peak
        *= tau, no clamp at the current sample); the input re-latches
        through the rising branch once the decayed peak falls to it."""
        return riders.peak_meter(self, state, x)


class PanLaw(enum.Enum):
    LINEAR = "linear"
    EQUAL_POWER = "equal_power"


class PanometerState(NamedTuple):
    win_a: torch.Tensor    # [..., N] squared-sample windows
    win_b: torch.Tensor


class Panometer:
    """Pan position estimate between two channels over a sliding window
    (reference Panometer.cpp:131-186): pan = sr/(sl+sr) with sl/sr the
    windowed energies (sqrt'ed for the LINEAR pan law).

    The JAX package's state is one pair ([N]); here ``batch_shape``
    gives several pairs, and the windows' carry is taken along the last
    axis (``[..., -N:]``), which for one pair is the JAX package's."""

    def __init__(self, period: int, law: PanLaw = PanLaw.LINEAR,
                 default: float = 0.5):
        self.period = int(period)
        self.law = law
        self.default = float(default)

    def init_state(self, batch_shape: Tuple[int, ...] = (),
                   device="cuda") -> PanometerState:
        shape = tuple(batch_shape) + (self.period,)
        return PanometerState(
            win_a=torch.zeros(shape, dtype=torch.float32, device=device),
            win_b=torch.zeros(shape, dtype=torch.float32, device=device))

    def process(self, state: PanometerState, a: torch.Tensor,
                b: torch.Tensor) -> Tuple[PanometerState, torch.Tensor]:
        n = self.period
        t = a.shape[-1]
        fa = torch.cat([state.win_a, a * a], dim=-1)
        fb = torch.cat([state.win_b, b * b], dim=-1)
        va = sliding_sum(fa, n, t) / n
        vb = sliding_sum(fb, n, t) / n
        if self.law == PanLaw.LINEAR:
            sl = torch.sqrt(torch.abs(va))
            sr = torch.sqrt(torch.abs(vb))
            eps = 1e-18
        else:
            sl, sr = torch.abs(va), torch.abs(vb)
            eps = 1e-36
        den = sl + sr
        pan = torch.where(den > eps, sr / torch.clamp(den, min=eps),
                          self.default)
        return PanometerState(win_a=fa[..., -n:].contiguous(),
                              win_b=fb[..., -n:].contiguous()), pan
