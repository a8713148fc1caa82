"""DynamicProcessor: the 4-dot piecewise dynamics curve (compander), the
port of models/dynamics/dynamic_processor.py (reference: src/main/
dynamics/DynamicProcessor.cpp).

Up to 4 dots {input, output, knee} define 5 log-log ranges with
per-range ratios; the total gain is the sum of per-spline contributions
(spline_amp, DynamicProcessor.cpp:173-184), each a Hermite-quadratic
knee blend.  Attack/release level arrays give a LEVEL-DEPENDENT tau
(solve_reaction, :195-201) inside the shared peak-hold envelope.

:meth:`DynamicProcessor.build` is host float64 numpy (its arrays equal
the JAX package's).  The envelope runs in ``ops/riders`` (the CUDA
kernel ``csrc/riders.cu`` for CUDA tensors, the plain per-sample loop
for CPU tensors); :meth:`reduction` and :meth:`curve` are element-wise
PyTorch on every device.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.models.misc import interpolation as interp
from lsp_dsp_units_tpu_torch.ops import dynamics as dyn
from lsp_dsp_units_tpu_torch.ops import riders
from lsp_dsp_units_tpu_torch.ops.env_units import _mul_add

DOTS = 4
FLOAT_SAT_M_INF = 1e-37
FLOAT_SAT_P_INF = 1e37


class DynProcParams(NamedTuple):
    sp_thresh: torch.Tensor   # [S] float32 per spline
    sp_makeup: torch.Tensor
    sp_kstart: torch.Tensor
    sp_kstop: torch.Tensor
    sp_pre: torch.Tensor
    sp_post: torch.Tensor
    sp_herm: torch.Tensor     # [S, 3]
    att_level: Tuple[float, ...]   # float32-rounded, ascending
    att_tau: Tuple[float, ...]
    rel_level: Tuple[float, ...]
    rel_tau: Tuple[float, ...]
    hold: int


def _f32s(v) -> Tuple[float, ...]:
    return tuple(float(f) for f in np.asarray(v, np.float32).reshape(-1))


class DynamicProcessor:
    def __init__(self, sample_rate: int = 48000, in_ratio: float = 1.0,
                 out_ratio: float = 1.0, hold_ms: float = 0.0,
                 attack_time_ms: Optional[List[float]] = None,
                 release_time_ms: Optional[List[float]] = None):
        self.sample_rate = int(sample_rate)
        self.in_ratio = float(in_ratio)
        self.out_ratio = float(out_ratio)
        self.hold_ms = float(hold_ms)
        self.dots: List[Optional[Tuple[float, float, float]]] = \
            [None] * DOTS
        self.attack_levels: List[Optional[float]] = [None] * DOTS
        self.release_levels: List[Optional[float]] = [None] * DOTS
        self.attack_times = list(attack_time_ms or [20.0] * (DOTS + 1))
        self.release_times = list(release_time_ms or [100.0] * (DOTS + 1))

    def set_dot(self, idx: int, inp: Optional[float],
                out: Optional[float] = None,
                knee: Optional[float] = None) -> None:
        if inp is None:
            self.dots[idx] = None
        else:
            self.dots[idx] = (float(inp), float(out), float(knee))

    def set_attack_level(self, idx: int, level: Optional[float]) -> None:
        self.attack_levels[idx] = level

    def set_release_level(self, idx: int, level: Optional[float]) -> None:
        self.release_levels[idx] = level

    def build(self, device="cuda") -> DynProcParams:
        """(reference update_settings + sort_splines,
        DynamicProcessor.cpp:213-339)"""
        def tau(ms):
            return float(dyn.tau(self.sample_rate, ms))

        att = [(0.0, tau(self.attack_times[0]))]
        rel = [(0.0, tau(self.release_times[0]))]
        for i in range(DOTS):
            if self.attack_levels[i] is not None:
                att.append((float(self.attack_levels[i]),
                            tau(self.attack_times[i + 1])))
            if self.release_levels[i] is not None:
                rel.append((float(self.release_levels[i]),
                            tau(self.release_times[i + 1])))
        att.sort(key=lambda kv: kv[0])
        rel.sort(key=lambda kv: kv[0])

        dots = sorted([d for d in self.dots if d is not None],
                      key=lambda d: d[0])
        n = len(dots)
        sp = dict(thresh=[], makeup=[], kstart=[], kstop=[], pre=[],
                  post=[], herm=[])
        sub = 0.0
        for i, (din, dout, dknee) in enumerate(dots):
            pre = (self.in_ratio - 1.0) if i == 0 else 0.0
            if i + 1 < n:
                dx = np.log(dots[i + 1][0] / din)
                dy = np.log(dots[i + 1][1] / dout)
                post = dy / dx - 1.0
            else:
                post = (1.0 / self.out_ratio) - 1.0
            post -= sub
            sub += post
            thresh = np.log(din)
            knee = np.log(dknee)
            kstop = thresh - knee
            kstart = thresh + knee
            makeup = np.log(dout) - thresh if i == 0 else 0.0
            log_y1 = makeup + pre * knee
            herm = interp.hermite_quadratic(kstart, log_y1, pre, kstop,
                                            post)
            sp["thresh"].append(thresh)
            sp["makeup"].append(makeup)
            sp["kstart"].append(kstart)
            sp["kstop"].append(kstop)
            sp["pre"].append(pre)
            sp["post"].append(post)
            sp["herm"].append(herm)
        sp["herm"] = (np.asarray(sp["herm"]).reshape(n, 3) if n
                      else np.zeros((0, 3)))

        def f32(v):
            return torch.tensor(np.asarray(v, np.float32), device=device)

        return DynProcParams(
            sp_thresh=f32(sp["thresh"]), sp_makeup=f32(sp["makeup"]),
            sp_kstart=f32(sp["kstart"]), sp_kstop=f32(sp["kstop"]),
            sp_pre=f32(sp["pre"]), sp_post=f32(sp["post"]),
            sp_herm=f32(sp["herm"]),
            att_level=_f32s([a[0] for a in att]),
            att_tau=_f32s([a[1] for a in att]),
            rel_level=_f32s([r[0] for r in rel]),
            rel_tau=_f32s([r[1] for r in rel]),
            hold=int(round(self.sample_rate * self.hold_ms / 1000.0)))

    # -- execution ----------------------------------------------------------
    def init_state(self, batch_shape: Tuple[int, ...] = (),
                   device="cuda") -> dyn.EnvState:
        return dyn.env_init(batch_shape, device)

    def process(self, params: DynProcParams, state: dyn.EnvState,
                x: torch.Tensor
                ) -> Tuple[dyn.EnvState, torch.Tensor, torch.Tensor]:
        """(state, detector x) -> (state', gain, envelope)."""
        state, env = riders.dynproc_envelope(params, state, x)
        return state, self.reduction(params, env), env

    def reduction(self, params: DynProcParams, x: torch.Tensor
                  ) -> torch.Tensor:
        """Gain from the spline sum (reference reduction()), rounded as
        the JAX package rounds it on the CPU up to its exp and log."""
        ax = torch.clamp(torch.abs(x), FLOAT_SAT_M_INF, FLOAT_SAT_P_INF)
        lx = torch.log(ax)[..., None]                 # [..., 1]
        d = lx - params.sp_thresh
        makeup = params.sp_makeup.expand_as(d)
        pre_line = _mul_add(params.sp_pre.expand_as(d), d, makeup)
        post_line = _mul_add(params.sp_post.expand_as(d), d, makeup)
        h = params.sp_herm
        lxs = lx.expand_as(d)
        herm = _mul_add(_mul_add(h[:, 0].expand_as(d), lxs,
                                 h[:, 1].expand_as(d)), lxs,
                        h[:, 2].expand_as(d))
        contrib = torch.where(lx <= params.sp_kstart, pre_line,
                              torch.where(lx >= params.sp_kstop, post_line,
                                          herm))
        return torch.exp(torch.sum(contrib, dim=-1))

    def curve(self, params: DynProcParams, x: torch.Tensor) -> torch.Tensor:
        return self.reduction(params, x) * x
