"""Compressor: the port of models/dynamics/compressor.py (reference
Compressor.cpp).  :meth:`Compressor.build` designs the two knees and the
envelope coefficients on the host in float64 and rounds them once to
float32 host numbers.  :meth:`Compressor.process` runs the envelope
through ``ops.dynamics.peak_envelope`` (the CUDA kernel of
ops/env_units.py for CUDA tensors) and the two-knee gain as element-wise
PyTorch.  ``step_ring`` runs the same math inside the fused kernel of
ops/env.py.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Tuple

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.models.misc import interpolation as interp
from lsp_dsp_units_tpu_torch.ops import dynamics as dyn

GAIN_AMP_M_72_DB = 10.0 ** (-72.0 / 20.0)
RATIO_PREC = 1e-5
FLOAT_SAT_P_INF = 1e37  # stand-in for the reference's float saturation


class CompressorMode(enum.Enum):
    DOWNWARD = "downward"
    UPWARD = "upward"
    BOOSTING = "boosting"


class CompressorParams(NamedTuple):
    knees: Tuple[dyn.CompKnee, dyn.CompKnee]
    tau_attack: float
    tau_release: float
    release_thresh: float
    hold: int


def _f32(v) -> float:
    return float(np.float32(v))


class Compressor:
    """Static config + knob values; :meth:`build` -> host params."""

    def __init__(self, sample_rate: int = 48000,
                 mode: CompressorMode = CompressorMode.DOWNWARD,
                 attack_thresh: float = 0.5, release_thresh: float = 0.0,
                 boost_thresh: float = GAIN_AMP_M_72_DB,
                 attack_ms: float = 20.0, release_ms: float = 100.0,
                 knee: float = 0.7071, ratio: float = 4.0,
                 hold_ms: float = 0.0):
        self.sample_rate = int(sample_rate)
        self.mode = mode
        self.attack_thresh = float(attack_thresh)
        self.release_thresh = float(release_thresh)
        self.boost_thresh = float(boost_thresh)
        self.attack_ms = float(attack_ms)
        self.release_ms = float(release_ms)
        self.knee = float(knee)
        self.ratio = float(ratio)
        self.hold_ms = float(hold_ms)

    # -- design (reference Compressor.cpp:88-216) --------------------------
    @staticmethod
    def _knee(start, end, gain, tilt0, tilt1, herm) -> dyn.CompKnee:
        return dyn.CompKnee(_f32(start), _f32(end), _f32(gain), _f32(tilt0),
                            _f32(tilt1), _f32(herm[0]), _f32(herm[1]),
                            _f32(herm[2]))

    def build(self) -> CompressorParams:
        mode = self.mode
        kn = self.knee
        if mode == CompressorMode.UPWARD:
            rr = 1.0 / self.ratio
            th1 = np.log(self.attack_thresh)
            th2 = np.log(self.boost_thresh)
            b = (rr - 1.0) * (th2 - th1)
            k0 = dict(start=self.attack_thresh * kn,
                      end=self.attack_thresh / kn, gain=1.0,
                      tilt0=1.0 - rr, tilt1=(rr - 1.0) * th1)
            k1 = dict(start=self.boost_thresh * kn,
                      end=self.boost_thresh / kn, gain=np.exp(b),
                      tilt0=rr - 1.0, tilt1=(1.0 - rr) * th1)
            h0 = interp.hermite_quadratic(np.log(k0["start"]), 0.0, 0.0,
                                          np.log(k0["end"]), k0["tilt0"])
            h1 = interp.hermite_quadratic(np.log(k1["start"]), b, 0.0,
                                          np.log(k1["end"]), k1["tilt0"])
        elif mode == CompressorMode.BOOSTING:
            rr = 1.0 / max(self.ratio, 1.0 + RATIO_PREC)
            b = np.log(self.boost_thresh)
            th1 = np.log(self.attack_thresh)
            th2 = th1 + b / (rr - 1.0)
            eth2 = np.exp(th2)
            if self.boost_thresh >= 1.0:
                k0 = dict(start=self.attack_thresh * kn,
                          end=self.attack_thresh / kn, gain=1.0,
                          tilt0=1.0 - rr, tilt1=(rr - 1.0) * th1)
                k1 = dict(start=eth2 * kn, end=eth2 / kn,
                          gain=self.boost_thresh,
                          tilt0=rr - 1.0, tilt1=(1.0 - rr) * th1)
                h0 = interp.hermite_quadratic(np.log(k0["start"]), 0.0, 0.0,
                                              np.log(k0["end"]), k0["tilt0"])
                h1 = interp.hermite_quadratic(np.log(k1["start"]), b, 0.0,
                                              np.log(k1["end"]), k1["tilt0"])
            else:
                k0 = dict(start=self.attack_thresh * kn,
                          end=self.attack_thresh / kn, gain=1.0,
                          tilt0=rr - 1.0, tilt1=(1.0 - rr) * th1)
                k1 = dict(start=eth2 * kn, end=eth2 / kn, gain=1.0,
                          tilt0=1.0 - rr, tilt1=(rr - 1.0) * th2)
                h0 = interp.hermite_quadratic(np.log(k0["start"]), 0.0, 0.0,
                                              np.log(k0["end"]), k0["tilt0"])
                h1 = interp.hermite_quadratic(np.log(k1["start"]), 0.0, 0.0,
                                              np.log(k1["end"]), k1["tilt0"])
        else:  # DOWNWARD
            rr = 1.0 / self.ratio
            th1 = np.log(self.attack_thresh)
            k0 = dict(start=self.attack_thresh * kn,
                      end=self.attack_thresh / kn, gain=1.0,
                      tilt0=rr - 1.0, tilt1=(1.0 - rr) * th1)
            k1 = dict(start=FLOAT_SAT_P_INF, end=FLOAT_SAT_P_INF, gain=1.0,
                      tilt0=0.0, tilt1=0.0)
            h0 = interp.hermite_quadratic(np.log(k0["start"]), 0.0, 0.0,
                                          np.log(k0["end"]), k0["tilt0"])
            h1 = np.zeros(3)

        knees = (self._knee(k0["start"], k0["end"], k0["gain"], k0["tilt0"],
                            k0["tilt1"], h0),
                 self._knee(k1["start"], k1["end"], k1["gain"], k1["tilt0"],
                            k1["tilt1"], h1))
        return CompressorParams(
            knees=knees,
            tau_attack=_f32(dyn.tau(self.sample_rate, self.attack_ms)),
            tau_release=_f32(dyn.tau(self.sample_rate, self.release_ms)),
            release_thresh=_f32(self.release_thresh),
            hold=int(round(self.sample_rate * self.hold_ms / 1000.0)))

    # -- execution ----------------------------------------------------------
    def init_state(self, batch_shape: Tuple[int, ...] = (),
                   device="cuda") -> dyn.EnvState:
        return dyn.env_init(batch_shape, device)

    def process(self, params: CompressorParams, state: dyn.EnvState,
                x: torch.Tensor
                ) -> Tuple[dyn.EnvState, torch.Tensor, torch.Tensor]:
        """(state, detector level x) -> (state', gain, envelope); apply
        ``y = gain * signal`` at the call site."""
        state, env = dyn.peak_envelope(
            state, x, params.tau_attack, params.tau_release, params.hold,
            params.release_thresh)
        return state, dyn.compressor_x2_gain(params.knees, env), env

    def curve(self, params: CompressorParams, x: torch.Tensor
              ) -> torch.Tensor:
        """Static transfer curve (reference Compressor::curve)."""
        return dyn.compressor_x2_curve(params.knees, x)

    def amplification(self, params: CompressorParams, x: torch.Tensor
                      ) -> torch.Tensor:
        return dyn.compressor_x2_gain(params.knees, x)
