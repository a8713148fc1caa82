"""Lanczos polyphase resampling: the port of ops/resample.py (the
replacement for the reference's ``dsp::lanczos_resample_*`` and
``dsp::downsample_*`` kernels, used by Oversampler.cpp:527-570 and
TruePeakMeter.cpp:160-186).

One parameterized generator: a windowed-sinc (Lanczos) kernel evaluated
per polyphase branch.  Quality tiers map to kernel half-lengths (=
latency in input samples) as the reference's latency table
(Oversampler.cpp:955-1010): 2x->2, 3x->3, 4x->4, 12bit->4, 16bit->10,
24bit->62 samples.  :func:`upsample` forms its polyphase product as a
broadcast multiply-and-sum in float32, so no TF32 setting reaches it.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

#: quality tier -> Lanczos lobe count / latency in input samples
#: (matches reference Oversampler::latency(), Oversampler.cpp:955-1010)
QUALITY_LOBES = {"x2": 2, "x3": 3, "x4": 4,
                 "12bit": 4, "16bit": 10, "24bit": 62}


@lru_cache(maxsize=None)
def lanczos_kernel(ratio: int, lobes: int) -> np.ndarray:
    """Lanczos upsampling kernel, length 2*lobes*ratio + 1, float64.

    ``k[j] = sinc(t) * sinc(t / lobes)`` with ``t = (j - c)/ratio``;
    phase-0 taps hit integers so original samples pass through unchanged.
    """
    c = lobes * ratio
    t = (np.arange(2 * c + 1, dtype=np.float64) - c) / ratio
    x = np.pi * t
    with np.errstate(invalid="ignore", divide="ignore"):
        s = np.where(t == 0.0, 1.0, np.sin(x) / x)
        w = np.where(np.abs(t) >= lobes, 0.0,
                     np.where(t == 0.0, 1.0,
                              np.sin(x / lobes) / (x / lobes)))
    return s * w


@lru_cache(maxsize=None)
def _phase_matrix(ratio: int, lobes: int) -> np.ndarray:
    """Polyphase matrix [2*lobes+1, ratio]: column p holds the taps that
    produce output phase p from an input window of 2*lobes+1 samples.

    Output sample y[i*ratio + p] = sum_j win[i, j] * M[j, p] where
    win[i] = x[i-2a .. i] (with 'a' = lobes of history).
    """
    k = lanczos_kernel(ratio, lobes)
    a = lobes
    m = np.zeros((2 * a + 1, ratio), np.float64)
    c = a * ratio
    # y[n] (output grid) = sum_i x[i] k[n - i*ratio + c]
    # with n = (i0 + a)*ratio + p and window index j = i - i0:
    # tap = k[(a - j)*ratio + p + c - ? ] — derive directly:
    # y[(i0+a)*r + p] = sum_j x[i0+j] * k[(i0+a)*r + p - (i0+j)*r + c]
    #                 = sum_j win[j]  * k[(a-j)*r + p + c]
    for j in range(2 * a + 1):
        idx = (a - j) * ratio + c
        for p in range(ratio):
            q = idx + p
            if 0 <= q < k.size:
                m[j, p] = k[q]
    return m


def upsample_history(lobes: int, batch_shape: Tuple[int, ...] = (),
                     dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Zero input-history state: [..., 2*lobes] samples."""
    return torch.zeros(tuple(batch_shape) + (2 * lobes,), dtype=dtype,
                       device=device)


def upsample(history: torch.Tensor, x: torch.Tensor, ratio: int,
             lobes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming Lanczos upsample by ``ratio``.

    Args:
      history: [..., 2*lobes] carried input samples.
      x: [..., T] input block.
      Returns (history', y [..., T*ratio]).  Latency: ``lobes`` input
      samples (= ratio*lobes output samples).
    """
    a = lobes
    m = torch.as_tensor(_phase_matrix(ratio, lobes), dtype=x.dtype,
                        device=x.device)
    frame = torch.cat([history, x], dim=-1)               # [..., T+2a]
    t = x.shape[-1]
    wins = frame.unfold(-1, 2 * a + 1, 1)                 # [..., T, 2a+1]
    phases = torch.sum(wins[..., :, :, None] * m, dim=-2)  # [..., T, R]
    y = phases.reshape(x.shape[:-1] + (t * ratio,))
    return frame[..., -2 * a:], y.to(x.dtype)


def downsample(x: torch.Tensor, ratio: int) -> torch.Tensor:
    """Plain decimation (reference ``dsp::downsample_Nx``); anti-alias
    filtering is the caller's responsibility, as in Oversampler.cpp:558-560
    where an optional 30-pole BWC low-pass runs before this."""
    return x[..., ::ratio]


def oversample_rates() -> Tuple[int, ...]:
    """Supported integer ratios (reference over_mode_t: 2,3,4,6,8)."""
    return (2, 3, 4, 6, 8)


def resample_fractional(x: np.ndarray, sr_from: int, sr_to: int,
                        lobes: int = 16) -> np.ndarray:
    """Arbitrary-rate Lanczos resampling of a whole buffer (host, f64) —
    the analog of Sample::resample (reference Sample.cpp:1021-1207), used
    for offline sample-rate conversion.

    Direct windowed-sinc interpolation: output sample m sits at input
    position ``t = m * sr_from / sr_to``; a Lanczos kernel with cutoff
    ``c = min(1, sr_to/sr_from)`` (relative to the input Nyquist) and
    ``lobes`` lobes is evaluated at the fractional offsets and gathered —
    vectorized [M, W] numpy, no polyphase bookkeeping.
    """
    x = np.asarray(x, np.float64)
    if sr_from == sr_to:
        return x.copy()
    n = x.shape[-1]
    m = int(round(n * sr_to / sr_from))
    c = min(1.0, sr_to / sr_from)
    half = int(np.ceil(lobes / c))
    t = np.arange(m, dtype=np.float64) * (sr_from / sr_to)   # [M]
    base = np.floor(t).astype(np.int64)
    offs = np.arange(-half + 1, half + 1)                     # [W]
    idx = base[:, None] + offs[None, :]                       # [M, W]
    tau = t[:, None] - idx                                    # [M, W]
    arg = np.pi * c * tau
    with np.errstate(invalid="ignore", divide="ignore"):
        s = np.where(tau == 0.0, c, np.sin(arg) / (np.pi * tau))
        warg = arg / lobes
        w = np.where(np.abs(c * tau) >= lobes, 0.0,
                     np.where(tau == 0.0, 1.0, np.sin(warg) / warg))
    ker = s * w
    idx_c = np.clip(idx, 0, n - 1)
    valid = (idx >= 0) & (idx < n)
    gathered = x[..., idx_c] * np.where(valid, ker, 0.0)
    return gathered.sum(-1)
