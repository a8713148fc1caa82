"""TruePeakMeter: BS.1770-5 true peak estimation, the port of
models/meters/true_peak.py (reference: src/main/meters/
TruePeakMeter.cpp).

Oversample to >= 192 kHz with the smallest {2,3,4,6,8}x ratio
(TruePeakMeter.cpp:85-99) using the 16-bit-quality Lanczos kernel
(TruePeakMeter.cpp:160-186), on ``ops/resample.upsample``, then take the
largest magnitude of each polyphase group back at the input rate
(TruePeakMeter.cpp:115-147).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from lsp_dsp_units_tpu_torch.ops import resample

TRUE_PEAK_FREQUENCY = 192000  # reference TruePeakMeter.cpp


def oversampling_multiplier(sample_rate: int) -> int:
    """(reference TruePeakMeter::calc_oversampling_multiplier)"""
    if sample_rate >= TRUE_PEAK_FREQUENCY:
        return 1
    for m in (2, 3, 4, 6, 8):
        if sample_rate * m >= TRUE_PEAK_FREQUENCY:
            return m
    return 8


class TruePeakState(NamedTuple):
    hist: torch.Tensor   # [..., 2*lobes] upsampler history


class TruePeakMeter:
    def __init__(self, sample_rate: int = 48000, quality: str = "16bit"):
        self.sample_rate = int(sample_rate)
        self.ratio = oversampling_multiplier(sample_rate)
        self.lobes = resample.QUALITY_LOBES[quality]

    def latency(self) -> int:
        return self.lobes if self.ratio > 1 else 0

    def init_state(self, batch_shape: Tuple[int, ...] = (),
                   device="cuda") -> TruePeakState:
        return TruePeakState(hist=resample.upsample_history(
            self.lobes, batch_shape, device=device))

    def process(self, state: TruePeakState, x: torch.Tensor,
                ) -> Tuple[TruePeakState, torch.Tensor]:
        """Per-sample true-peak estimate [..., T] at the input rate."""
        if self.ratio == 1:
            return state, torch.abs(x)
        hist, hi = resample.upsample(state.hist, x, self.ratio, self.lobes)
        t = x.shape[-1]
        groups = torch.abs(hi).reshape(x.shape[:-1] + (t, self.ratio))
        return TruePeakState(hist=hist), torch.amax(groups, dim=-1)

    def process_max(self, state: TruePeakState, x: torch.Tensor,
                    ) -> Tuple[TruePeakState, torch.Tensor]:
        """Scalar true peak of the block (reference process_max,
        TruePeakMeter.cpp:197-231)."""
        state, tp = self.process(state, x)
        return state, torch.amax(tp, dim=-1)
