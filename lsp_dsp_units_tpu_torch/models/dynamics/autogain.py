"""AutoGain and SimpleAutoGain: loudness-driven gain riders, the port of
models/dynamics/autogain.py (reference: src/main/dynamics/AutoGain.cpp,
SimpleAutoGain.cpp).

AutoGain follows the reference: a per-sample state machine with short
and long timing loops (dB/s grow/fall factors), surge up/down flags, an
internal soft compressor curve (calc_compressor / eval_curve,
AutoGain.cpp:169-207) and output gain limiting.  The recurrence runs in
``ops/riders`` (the CUDA kernel ``csrc/riders.cu`` for CUDA tensors, the
plain per-sample loop for CPU tensors), vectorised over channels.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.ops import riders

GAIN_AMP_M_72_DB = 10.0 ** (-72.0 / 20.0)
GAIN_AMP_P_6_DB = 10.0 ** (6.0 / 20.0)


def _calc_compressor(x1: float, x2: float, y2: float):
    """(reference AutoGain::calc_compressor)"""
    dy = y2 - x1
    dx = x2 - x1
    dx1 = 1.0 / dx
    dx2 = dx1 * dx1
    return {k: float(v) for k, v in dict(
        x1=x1, x2=x2, t=y2, d=x1, c=1.0,
        b=3.0 * dy * dx2 - 2.0 * dx1,
        a=(1.0 - 2.0 * dy * dx1) * dx2).items()}


def _eval_curve(c, x: torch.Tensor) -> torch.Tensor:
    """The compressor curve on float32 x (reference AutoGain.cpp:205:
    ``((a v + b) v + c v) + d``, a quadratic, not the cubic the
    coefficients were derived for; ported verbatim), rounded as the JAX
    package rounds it on the CPU (``ops/riders.eval_curve``)."""
    return riders.eval_curve({k: torch.tensor(float(np.float32(v)),
                                              dtype=torch.float32,
                                              device=x.device)
                              for k, v in c.items()}, x)


def _eval_gain(c, x: torch.Tensor) -> torch.Tensor:
    return _eval_curve(c, x) / torch.clamp(x, min=riders.TINY_LEVEL)


class AutoGainState(NamedTuple):
    gain: torch.Tensor        # [...] current gain
    out_gain: torch.Tensor    # [...] limiting gain
    surge_up: torch.Tensor    # [...] bool
    surge_down: torch.Tensor  # [...] bool


class AutoGain:
    def __init__(self, sample_rate: int = 48000,
                 silence: float = GAIN_AMP_M_72_DB,
                 deviation: float = GAIN_AMP_P_6_DB,
                 short_grow_db_s: float = 20.0, short_fall_db_s: float = 40.0,
                 long_grow_db_s: float = 2.0, long_fall_db_s: float = 2.0,
                 max_gain: float = 10.0, use_max_gain: bool = False,
                 quick_amplifier: bool = False):
        self.sample_rate = int(sample_rate)
        self.silence = float(silence)
        self.deviation = float(deviation)
        ksr = (np.log(10.0) / 20.0) / sample_rate
        self.short_kgrow = float(np.exp(short_grow_db_s * ksr))
        self.short_kfall = float(np.exp(-short_fall_db_s * ksr))
        self.long_kgrow = float(np.exp(long_grow_db_s * ksr))
        self.long_kfall = float(np.exp(-long_fall_db_s * ksr))
        qd = np.sqrt(self.deviation)
        self.short_comp = _calc_compressor(1.0 / self.deviation,
                                           self.deviation, 1.0)
        self.out_comp = _calc_compressor(qd, self.deviation * qd,
                                         self.deviation)
        self.max_gain = float(max_gain)
        self.use_max_gain = bool(use_max_gain)
        self.quick_amp = bool(quick_amplifier)

    def init_state(self, batch_shape: Tuple[int, ...] = (),
                   device="cuda") -> AutoGainState:
        shape = tuple(batch_shape)
        return AutoGainState(
            gain=torch.ones(shape, dtype=torch.float32, device=device),
            out_gain=torch.ones(shape, dtype=torch.float32, device=device),
            surge_up=torch.zeros(shape, dtype=torch.bool, device=device),
            surge_down=torch.zeros(shape, dtype=torch.bool, device=device))

    def process(self, state: AutoGainState, l_long: torch.Tensor,
                l_short: torch.Tensor, l_exp: torch.Tensor,
                ) -> Tuple[AutoGainState, torch.Tensor]:
        """(state, long loudness, short loudness, expected loudness)
        [..., T] -> (state', vca gain) -- reference AutoGain::process.
        ``l_exp`` is broadcast to ``l_long``'s shape."""
        return riders.autogain(self, state, l_long, l_short, l_exp)


class SimpleAutoGainState(NamedTuple):
    gain: torch.Tensor


class SimpleAutoGain:
    """Gain rider toward a target level with grow/fall speeds
    (reference SimpleAutoGain.cpp)."""

    def __init__(self, sample_rate: int = 48000, silence: float =
                 GAIN_AMP_M_72_DB, deviation: float = 1.0,
                 grow_db_s: float = 20.0, fall_db_s: float = 20.0,
                 min_gain: float = 0.001, max_gain: float = 1000.0):
        self.sample_rate = int(sample_rate)
        self.silence = float(silence)
        self.deviation = max(float(deviation), 1.0)
        ksr = (np.log(10.0) / 20.0) / sample_rate
        self.kgrow = float(np.exp(grow_db_s * ksr))
        self.kfall = float(np.exp(-fall_db_s * ksr))
        self.min_gain = float(min_gain)
        self.max_gain = float(max_gain)

    def init_state(self, batch_shape: Tuple[int, ...] = (),
                   device="cuda") -> SimpleAutoGainState:
        return SimpleAutoGainState(gain=torch.ones(
            tuple(batch_shape), dtype=torch.float32, device=device))

    def process(self, state: SimpleAutoGainState, level: torch.Tensor,
                target: torch.Tensor,
                ) -> Tuple[SimpleAutoGainState, torch.Tensor]:
        """``target`` is broadcast to ``level``'s shape."""
        return riders.simple_autogain(self, state, level, target)
