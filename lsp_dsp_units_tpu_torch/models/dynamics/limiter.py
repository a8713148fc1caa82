"""Limiter: the lookahead brick-wall limiter with iterative peak patching,
the port of models/dynamics/limiter.py (reference: src/main/dynamics/
Limiter.cpp).

The design (:meth:`Limiter._patch_shape`, :meth:`Limiter.build`) is host
float64 numpy, the JAX package's own arithmetic, its arrays equal to the
JAX package's.  :meth:`Limiter.process` runs ``ops/limiter.limiter``:
the plain PyTorch loop for CPU tensors, the CUDA kernel
``csrc/limiter.cu`` for CUDA tensors.  12 modes = {Hermite, Exp, Line} x
{Thin, Wide, Tail, Duck} patch shapes (Limiter.h:37-53), plus an
optional ALR (automatic level regulation) pre-stage
(Limiter.cpp:675-693).
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Tuple

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.models.misc import interpolation as interp
from lsp_dsp_units_tpu_torch.ops import limiter as lim_ops
from lsp_dsp_units_tpu_torch.ops.limiter import (  # noqa: F401
    GAIN_LOWERING, LIMITER_PEAKS_MAX, MAX_PATCH_ITERS)


class LimiterMode(enum.Enum):
    HERM_THIN = "herm_thin"
    HERM_WIDE = "herm_wide"
    HERM_TAIL = "herm_tail"
    HERM_DUCK = "herm_duck"
    EXP_THIN = "exp_thin"
    EXP_WIDE = "exp_wide"
    EXP_TAIL = "exp_tail"
    EXP_DUCK = "exp_duck"
    LINE_THIN = "line_thin"
    LINE_WIDE = "line_wide"
    LINE_TAIL = "line_tail"
    LINE_DUCK = "line_duck"


class LimiterParams(NamedTuple):
    patch: torch.Tensor   # [P] float32 patch shape 0..1
    middle: int           # peak offset within the patch
    threshold: float      # the rest: float32-rounded host floats
    alr_ks: float
    alr_ke: float
    alr_gain: float
    alr_herm: Tuple[float, float, float]
    alr_tau_att: float
    alr_tau_rel: float


class LimiterState(NamedTuple):
    gcarry: torch.Tensor  # [..., 5L] gain buffer carry (init ones)
    alr_env: torch.Tensor  # [...] ALR envelope


def _f32(v) -> float:
    return float(np.float32(v))


class Limiter:
    def __init__(self, sample_rate: int = 48000,
                 mode: LimiterMode = LimiterMode.HERM_THIN,
                 threshold: float = 1.0, attack_ms: float = 5.0,
                 release_ms: float = 5.0, lookahead_ms: float = 5.0,
                 knee: float = 1.0, alr: bool = False,
                 alr_attack_ms: float = 5.0, alr_release_ms: float = 50.0,
                 alr_knee: float = 0.7071):
        self.sample_rate = int(sample_rate)
        self.mode = mode
        self.threshold = float(threshold)
        # reference-verbatim: `knee` only enters the ALR threshold
        # (Limiter.cpp:459); the patch loop's knee starts at 1.0
        # regardless (Limiter.cpp:715), so with alr=False it is inert
        self.knee = float(knee)
        self.alr = bool(alr)
        self.alr_attack_ms = float(alr_attack_ms)
        self.alr_release_ms = float(alr_release_ms)
        self.alr_knee = float(alr_knee)
        self.lookahead = max(8, int(sample_rate * lookahead_ms / 1000.0))
        self.attack_ms = float(attack_ms)
        self.release_ms = float(release_ms)

    def latency(self) -> int:
        return self.lookahead

    # -- design (reference init_sat/init_exp/init_line,
    #    Limiter.cpp:278-395) ------------------------------------------------
    def _patch_shape(self) -> Tuple[np.ndarray, int]:
        la = self.lookahead
        attack = int(np.clip(int(self.sample_rate * self.attack_ms
                                 / 1000.0), 8, la))
        kind, shape = self.mode.value.split("_")
        # reference-verbatim quirks (do not "fix"):
        # * init_sat derives release from the CLAMPED ATTACK count
        #   (Limiter.cpp:284), so herm modes always have release==attack;
        # * init_exp's shape if-chain tests LM_HERM_* (Limiter.cpp:327-
        #   346), which never matches an exp mode: exp modes always take
        #   the WIDE branch.
        if kind == "herm":
            release = attack
        else:
            release = int(np.clip(int(self.sample_rate * self.release_ms
                                      / 1000.0), 8, la * 2))
        if kind == "exp":
            shape = "wide"
        if shape == "thin":
            n_att, n_plane = attack, attack
        elif shape == "tail":
            n_att, n_plane = attack // 2, attack
        elif shape == "duck":
            n_att, n_plane = attack, attack + release // 2
        else:  # wide
            n_att, n_plane = attack // 2, attack + release // 2
        n_rel = attack + release + 1
        middle = attack

        t = np.arange(n_rel, dtype=np.float64)
        out = np.zeros(n_rel)
        if kind == "herm":
            va = interp.hermite_cubic(-1.0, 0.0, 0.0, n_att, 1.0, 0.0)
            vr = interp.hermite_cubic(n_plane, 1.0, 0.0, n_rel, 0.0, 0.0)
            att_vals = interp.polyval3(va, t)
            rel_vals = interp.polyval3(vr, t)
        elif kind == "exp":
            va = interp.exponent(-1.0, 0.0, n_att, 1.0, 2.0 / attack)
            vr = interp.exponent(n_plane, 1.0, n_rel, 0.0, 2.0 / release)
            att_vals = va[0] + va[1] * np.exp(va[2] * t)
            rel_vals = vr[0] + vr[1] * np.exp(vr[2] * t)
        else:  # line
            va = interp.linear(-1.0, 0.0, n_att, 1.0)
            vr = interp.linear(n_plane, 1.0, n_rel, 0.0)
            att_vals = va[0] * t + va[1]
            rel_vals = vr[0] * t + vr[1]
        out[:n_att] = att_vals[:n_att]
        out[n_att:n_plane] = 1.0
        out[n_plane:] = rel_vals[n_plane:]
        return out, middle

    def build(self, device="cuda") -> LimiterParams:
        patch, middle = self._patch_shape()
        # ALR knee (reference Limiter.cpp:459-469)
        thresh = self.threshold * self.knee * 10 ** (-9.0 / 20.0)
        ks = thresh * self.alr_knee
        ke = 2.0 * thresh - ks
        herm = interp.hermite_quadratic(ks, ks, 1.0, ke, 0.0)
        att = max(self.sample_rate * self.alr_attack_ms / 1000.0, 1.0)
        rel = max(self.sample_rate * self.alr_release_ms / 1000.0, 1.0)
        tau_a = 1.0 - np.exp(np.log(1.0 - np.sqrt(0.5)) / att)
        tau_r = 1.0 - np.exp(np.log(1.0 - np.sqrt(0.5)) / rel)
        return LimiterParams(
            patch=torch.tensor(patch, dtype=torch.float32, device=device),
            middle=int(middle), threshold=_f32(self.threshold),
            alr_ks=_f32(ks), alr_ke=_f32(ke), alr_gain=_f32(thresh),
            alr_herm=tuple(_f32(v) for v in herm),
            alr_tau_att=_f32(tau_a), alr_tau_rel=_f32(tau_r))

    # -- state ----------------------------------------------------------------
    def init_state(self, batch_shape: Tuple[int, ...] = (),
                   device="cuda") -> LimiterState:
        return LimiterState(
            gcarry=torch.ones(tuple(batch_shape) + (5 * self.lookahead,),
                              dtype=torch.float32, device=device),
            alr_env=torch.zeros(tuple(batch_shape), dtype=torch.float32,
                                device=device))

    # -- processing ------------------------------------------------------------
    def process(self, params: LimiterParams, state: LimiterState,
                sc: torch.Tensor) -> Tuple[LimiterState, torch.Tensor]:
        """sc: sidechain level [..., T] -> (state', gain [..., T]).

        The gain is DELAYED by ``lookahead`` samples relative to the
        sidechain (apply it to the equally delayed signal path, as the
        reference's callers do)."""
        gcarry, alr_env, gain, _ = lim_ops.limiter(
            params, state.gcarry, state.alr_env, sc, self.lookahead,
            self.alr)
        return LimiterState(gcarry=gcarry, alr_env=alr_env), gain
