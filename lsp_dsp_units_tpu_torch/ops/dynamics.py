"""Envelope follower and compressor knees: the port of the compressor
part of ops/dynamics.py (reference Compressor.cpp:94-95, 231-256,
297-310).  Plain PyTorch; the chain's CUDA path runs the same math
inside the kernel of ops/env.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


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


def env_init(batch_shape: Tuple[int, ...] = (), device=None) -> EnvState:
    z = torch.zeros(tuple(batch_shape), dtype=torch.float32, device=device)
    return EnvState(envelope=z, peak=z.clone(),
                    hold=torch.zeros(tuple(batch_shape), dtype=torch.int32,
                                     device=device))


def peak_envelope(state: EnvState, x: torch.Tensor, tau_attack: float,
                  tau_release: float, hold_samples: int,
                  release_thresh: Optional[float] = None
                  ) -> Tuple[EnvState, torch.Tensor]:
    """Branchy attack/release follower with peak-hold over x [..., T]
    (the detector level).  ``release_thresh=None`` releases with
    ``tau_release`` always (the gate's form).  Returns (state',
    envelope [..., T])."""
    e, peak, hold = state
    ta = torch.tensor(tau_attack, dtype=x.dtype, device=x.device)
    tr = torch.tensor(tau_release, dtype=x.dtype, device=x.device)
    nh = torch.tensor(int(hold_samples), dtype=torch.int32, device=x.device)
    out = torch.empty_like(x)
    for t in range(x.shape[-1]):
        xt = x[..., t]
        d = xt - e
        falling = d < 0.0
        holding = hold > 0
        if release_thresh is None:
            tau_dn = tr
        else:
            tau_dn = torch.where(e > release_thresh, tr, ta)
        e_fall = e + tau_dn * d
        e_rise = e + ta * d
        new_e = torch.where(falling, torch.where(holding, e, e_fall), e_rise)
        rise_peaked = torch.logical_and(~falling, e_rise >= peak)
        peak = torch.where(falling, torch.where(holding, peak, e_fall),
                           torch.where(rise_peaked, e_rise, peak))
        hold = torch.where(falling, torch.where(holding, hold - 1, hold),
                           torch.where(rise_peaked, nh, hold))
        e = new_e
        out[..., t] = e
    return EnvState(e, peak, hold), out


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
