"""Expander, upward or downward: the port of models/dynamics/expander.py
(reference Expander.cpp).  :meth:`Expander.build` designs the knee on the
host in float64 and rounds it once to float32 host numbers;
:meth:`Expander.process` runs the envelope through
``ops.dynamics.peak_envelope`` (the CUDA kernel of ops/env_units.py for
CUDA tensors) and the knee gain as element-wise PyTorch.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Tuple

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.models.misc import interpolation as interp
from lsp_dsp_units_tpu_torch.ops import dynamics as dyn

# reference Expander.cpp:32-36
MINIMUM_TILT = 0.001
UPPER_THRESHOLD = 13.815510558    # log(1e6)
LOWER_THRESHOLD = -16.118095651   # log(1e-7)
MIN_LOWER_THRESHOLD = 1e-7
MAX_UPPER_THRESHOLD = 1e6


class ExpanderMode(enum.Enum):
    DOWNWARD = "downward"
    UPWARD = "upward"


class ExpanderParams(NamedTuple):
    knee: dyn.ExpKnee
    tau_attack: float
    tau_release: float
    release_thresh: float
    hold: int


def _f32(v) -> float:
    return float(np.float32(v))


def _square_roots(p, y):
    """Roots of p0 x^2 + p1 x + p2 = y (reference Expander.cpp:44-58)."""
    a, b, c = p[0], -p[1], p[2] - y
    d = np.sqrt(max(b * b - 4.0 * a * c, 0.0))
    k = 1.0 / (2.0 * a)
    return (b + d) * k, (b - d) * k


class Expander:
    def __init__(self, sample_rate: int = 48000,
                 mode: ExpanderMode = ExpanderMode.DOWNWARD,
                 attack_thresh: float = 0.25, release_thresh: float = 0.0,
                 attack_ms: float = 20.0, release_ms: float = 100.0,
                 knee: float = 0.7071, ratio: float = 2.0,
                 hold_ms: float = 0.0):
        self.sample_rate = int(sample_rate)
        self.mode = mode
        self.attack_thresh = float(attack_thresh)
        self.release_thresh = float(release_thresh)
        self.attack_ms = float(attack_ms)
        self.release_ms = float(release_ms)
        self.knee = float(knee)
        self.ratio = float(ratio)
        self.hold_ms = float(hold_ms)

    def build(self) -> ExpanderParams:
        """Knee design (reference Expander::update_settings,
        Expander.cpp:200-259)."""
        start = self.attack_thresh * self.knee
        end = self.attack_thresh / self.knee
        log_ks, log_ke = np.log(start), np.log(end)
        log_th = np.log(self.attack_thresh)
        tilt0 = self.ratio - 1.0
        tilt1 = log_th * (1.0 - self.ratio)
        upward = self.mode == ExpanderMode.UPWARD
        if upward:
            herm = interp.hermite_quadratic(log_ks, 0.0, 0.0, log_ke, tilt0)
            ut = np.exp((UPPER_THRESHOLD - tilt1)
                        / max(tilt0, MINIMUM_TILT))
            if ut < end:
                r1, r2 = _square_roots(herm, UPPER_THRESHOLD)
                ut = np.exp(max(r1, r2))
            threshold = min(ut, MAX_UPPER_THRESHOLD)
        else:
            herm = interp.hermite_quadratic(log_ke, 0.0, 0.0, log_ks, tilt0)
            dt = np.exp((LOWER_THRESHOLD - tilt1)
                        / max(tilt0, MINIMUM_TILT))
            if dt > start:
                r1, r2 = _square_roots(herm, LOWER_THRESHOLD)
                dt = np.exp(min(r1, r2))
            threshold = max(dt, MIN_LOWER_THRESHOLD)

        knee = dyn.ExpKnee(
            start=_f32(start), end=_f32(end), tilt0=_f32(tilt0),
            tilt1=_f32(tilt1), herm0=_f32(herm[0]), herm1=_f32(herm[1]),
            herm2=_f32(herm[2]), threshold=_f32(threshold), upward=upward)
        return ExpanderParams(
            knee=knee,
            tau_attack=_f32(dyn.tau(self.sample_rate, self.attack_ms)),
            tau_release=_f32(dyn.tau(self.sample_rate, self.release_ms)),
            release_thresh=_f32(self.release_thresh),
            hold=int(round(self.sample_rate * self.hold_ms / 1000.0)))

    def init_state(self, batch_shape: Tuple[int, ...] = (),
                   device="cuda") -> dyn.EnvState:
        return dyn.env_init(batch_shape, device)

    def process(self, params: ExpanderParams, state: dyn.EnvState,
                x: torch.Tensor
                ) -> Tuple[dyn.EnvState, torch.Tensor, torch.Tensor]:
        """(state, detector level x) -> (state', gain, envelope)."""
        state, env = dyn.peak_envelope(
            state, x, params.tau_attack, params.tau_release, params.hold,
            params.release_thresh)
        return state, dyn.expander_gain(params.knee, env), env

    def curve(self, params: ExpanderParams, x: torch.Tensor) -> torch.Tensor:
        return dyn.expander_curve(params.knee, x)

    def amplification(self, params: ExpanderParams,
                      x: torch.Tensor) -> torch.Tensor:
        return dyn.expander_gain(params.knee, x)
