"""Gate with hysteresis: the port of models/dynamics/gate.py (reference
Gate.cpp).

Two curves (normal / hysteresis), each {threshold, zone, reduction}
mapped to a cubic-Hermite log-log knee (Gate.cpp:180-206).  The active
curve switches to 1 when the envelope exceeds curve 0's end and back to
0 when it falls below curve 1's start; the sample where the crossing is
detected already uses the new curve.  :meth:`Gate.process` runs the
envelope and the curve track through ``ops.env_units.gate_envelope`` (the
CUDA kernel for CUDA tensors); the gain ``where(curves == 0, g0, g1)``
stays element-wise PyTorch outside the kernel, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.models.misc import interpolation as interp
from lsp_dsp_units_tpu_torch.ops import dynamics as dyn
from lsp_dsp_units_tpu_torch.ops.env_units import gate_envelope


class GateParams(NamedTuple):
    """Host floats, or 0-d float32 tensors for the knee fields and the
    taus (the gate then differentiates in them); the hold is an int."""
    knees: Tuple[dyn.GateKnee, dyn.GateKnee]   # [normal, hysteresis]
    tau_attack: float
    tau_release: float
    hold: int


class GateState(NamedTuple):
    env: dyn.EnvState
    curve: torch.Tensor    # [...] int32 active curve (0 normal / 1 hyst)


def _f32(v) -> float:
    return float(np.float32(v))


class Gate:
    def __init__(self, sample_rate: int = 48000, threshold: float = 0.063,
                 zone: float = 0.5, hyst_threshold: Optional[float] = None,
                 hyst_zone: Optional[float] = None, reduction: float = 0.063,
                 attack_ms: float = 20.0, release_ms: float = 100.0,
                 hold_ms: float = 0.0):
        self.sample_rate = int(sample_rate)
        self.threshold = float(threshold)
        self.zone = float(zone)
        self.hyst_threshold = float(hyst_threshold
                                    if hyst_threshold is not None
                                    else threshold)
        self.hyst_zone = float(hyst_zone if hyst_zone is not None else zone)
        self.reduction = float(reduction)
        self.attack_ms = float(attack_ms)
        self.release_ms = float(release_ms)
        self.hold_ms = float(hold_ms)

    def _knee(self, threshold: float, zone: float) -> dyn.GateKnee:
        """(reference Gate::update_settings, Gate.cpp:180-206)"""
        start = threshold * zone
        end = threshold
        gain_start = self.reduction if self.reduction <= 1.0 else 1.0
        gain_end = 1.0 if self.reduction <= 1.0 else 1.0 / self.reduction
        herm = interp.hermite_cubic(np.log(start), np.log(gain_start), 0.0,
                                    np.log(end), np.log(gain_end), 0.0)
        return dyn.GateKnee(_f32(start), _f32(end), _f32(gain_start),
                            _f32(gain_end), _f32(herm[0]), _f32(herm[1]),
                            _f32(herm[2]), _f32(herm[3]))

    def build(self) -> GateParams:
        return GateParams(
            knees=(self._knee(self.threshold, self.zone),
                   self._knee(self.hyst_threshold, self.hyst_zone)),
            tau_attack=_f32(dyn.tau(self.sample_rate, self.attack_ms)),
            tau_release=_f32(dyn.tau(self.sample_rate, self.release_ms)),
            hold=int(round(self.sample_rate * self.hold_ms / 1000.0)))

    def init_state(self, batch_shape: Tuple[int, ...] = (),
                   device="cuda") -> GateState:
        return GateState(env=dyn.env_init(batch_shape, device),
                         curve=torch.zeros(tuple(batch_shape),
                                           dtype=torch.int32, device=device))

    def process(self, params: GateParams, state: GateState, x: torch.Tensor
                ) -> Tuple[GateState, torch.Tensor, torch.Tensor]:
        """(state, detector x [..., T]) -> (state', gain, envelope)."""
        k0, k1 = params.knees
        env_st, cur, env, curves = gate_envelope(
            state.env, state.curve, x, params.tau_attack, params.tau_release,
            params.hold, k0.end, k1.start)
        gain = torch.where(curves == 0, dyn.gate_x1_gain(k0, env),
                           dyn.gate_x1_gain(k1, env))
        return GateState(env=env_st, curve=cur), gain, env

    def curve(self, params: GateParams, x: torch.Tensor,
              hyst: bool = False) -> torch.Tensor:
        return dyn.gate_x1_curve(params.knees[1 if hyst else 0], x)

    def amplification(self, params: GateParams, x: torch.Tensor,
                      hyst: bool = False) -> torch.Tensor:
        return dyn.gate_x1_gain(params.knees[1 if hyst else 0], x)
