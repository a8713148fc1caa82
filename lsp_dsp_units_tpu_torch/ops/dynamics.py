"""Envelope followers and knee gain curves: the port of ops/dynamics.py
(reference Compressor.cpp:94-95, 231-256, 297-310; Gate.cpp:180-265;
Expander.cpp:205-258, 375-406).

:func:`peak_envelope` is the wrapper of ops/env_units.py: the CUDA
kernel for CUDA tensors, :func:`peak_envelope_plain` (a Python loop over
T) for CPU tensors.  The knees are element-wise PyTorch on host-float
parameters, rounded to float32 once at build time.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.ops.env_units import (  # noqa: F401
    peak_envelope, peak_envelope_plain)


def tau(sample_rate: int, time_ms) -> float:
    """Attack/release smoothing coefficient
    ``1 - exp(log(1 - 1/sqrt(2)) / (ms * sr / 1000))``."""
    samples = np.asarray(sample_rate * time_ms / 1000.0, np.float64)
    with np.errstate(divide="ignore"):
        t = 1.0 - np.exp(np.log(1.0 - np.sqrt(0.5)) / samples)
    return float(np.where(samples <= 0.0, 1.0, t))


class EnvState(NamedTuple):
    envelope: torch.Tensor   # [...] float32
    peak: torch.Tensor       # [...] float32
    hold: torch.Tensor       # [...] int32 remaining hold samples


def env_init(batch_shape: Tuple[int, ...] = (),
             device="cuda") -> EnvState:
    z = torch.zeros(tuple(batch_shape), dtype=torch.float32, device=device)
    return EnvState(envelope=z, peak=z.clone(),
                    hold=torch.zeros(tuple(batch_shape), dtype=torch.int32,
                                     device=device))


def onepole_lowpass(state: torch.Tensor, x: torch.Tensor, k
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-pole smoother ``y[n] = y[n-1] + k (x[n] - y[n-1])`` over x
    [..., T] as a time-parallel first-order affine scan (Sidechain LPF
    mode): log2(T) Hillis-Steele passes of ``(a1, b1) o (a2, b2) = (a1
    a2, a2 b1 + b2)``.  Returns (y[..., -1], y)."""
    if x.shape[-1] == 0:
        return state, x
    kk = np.float32(k)
    a = torch.full_like(x, float(np.float32(1.0) - kk))
    b = x * float(kk)
    off = 1
    while off < x.shape[-1]:
        b = torch.cat([b[..., :off],
                       a[..., off:] * b[..., :-off] + b[..., off:]], dim=-1)
        a = torch.cat([a[..., :off], a[..., :-off] * a[..., off:]], dim=-1)
        off *= 2
    y = a * state[..., None] + b
    return y[..., -1], y


class CompKnee(NamedTuple):
    """One log-domain knee: gain below start, tilt line above end,
    Hermite-quadratic blend between (log-log space).  Host floats,
    rounded to float32."""
    start: float
    end: float
    gain: float
    tilt0: float
    tilt1: float
    herm0: float
    herm1: float
    herm2: float


def comp_knee_gain(k: CompKnee, x: torch.Tensor,
                   lx: torch.Tensor) -> torch.Tensor:
    """Gain of one knee at |x| (log |x| precomputed)."""
    line = torch.exp(lx * k.tilt0 + k.tilt1)
    herm = torch.exp((k.herm0 * lx + k.herm1) * lx + k.herm2)
    return torch.where(x <= k.start, torch.full_like(x, k.gain),
                       torch.where(x >= k.end, line, herm))


def compressor_x2_gain(knees: Tuple[CompKnee, CompKnee],
                       x: torch.Tensor) -> torch.Tensor:
    """Product of two knees (reference ``dsp::compressor_x2_gain``)."""
    ax = torch.abs(x)
    lx = torch.log(torch.clamp(ax, min=1e-36))
    return comp_knee_gain(knees[0], ax, lx) * comp_knee_gain(knees[1], ax,
                                                             lx)


def compressor_x2_curve(knees: Tuple[CompKnee, CompKnee],
                        x: torch.Tensor) -> torch.Tensor:
    return compressor_x2_gain(knees, x) * x


class GateKnee(NamedTuple):
    """Gate knee (reference Gate.cpp:180-206): ``gain_start`` below
    start, ``gain_end`` above end, a log-log Hermite cubic between.  Host
    floats, rounded to float32."""
    start: float
    end: float
    gain_start: float
    gain_end: float
    herm0: float
    herm1: float
    herm2: float
    herm3: float


def gate_x1_gain(k: GateKnee, x: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    lx = torch.log(torch.clamp(ax, min=1e-36))
    herm = torch.exp(((k.herm0 * lx + k.herm1) * lx + k.herm2) * lx
                     + k.herm3)
    return torch.where(ax <= k.start, torch.full_like(ax, k.gain_start),
                       torch.where(ax >= k.end,
                                   torch.full_like(ax, k.gain_end), herm))


def gate_x1_curve(k: GateKnee, x: torch.Tensor) -> torch.Tensor:
    return gate_x1_gain(k, x) * x


class ExpKnee(NamedTuple):
    """Expander knee (reference Expander.cpp:205-258).  Host floats,
    rounded to float32; ``threshold`` is the clamp point of the gain
    cap."""
    start: float
    end: float
    tilt0: float
    tilt1: float
    herm0: float
    herm1: float
    herm2: float
    threshold: float
    upward: bool


def expander_gain(k: ExpKnee, x: torch.Tensor) -> torch.Tensor:
    """Upward/downward expander gain (reference Expander::amplification,
    Expander.cpp:375-406): unity inside the no-expansion region, the tilt
    line beyond the knee, the Hermite blend within.  Upward clamps the
    input at ``threshold`` (the gain saturates there); downward mutes
    (gain 0) below it."""
    ax = torch.abs(x)
    if k.upward:
        ax = torch.clamp(ax, max=k.threshold)
    lx = torch.log(torch.clamp(ax, min=1e-36))
    line = torch.exp(lx * k.tilt0 + k.tilt1)
    herm = torch.exp((k.herm0 * lx + k.herm1) * lx + k.herm2)
    one = torch.ones_like(ax)
    if k.upward:
        return torch.where(ax <= k.start, one,
                           torch.where(ax >= k.end, line, herm))
    g = torch.where(ax >= k.end, one, torch.where(ax <= k.start, line, herm))
    return torch.where(ax < k.threshold, torch.zeros_like(ax), g)


def expander_curve(k: ExpKnee, x: torch.Tensor) -> torch.Tensor:
    return expander_gain(k, x) * x
