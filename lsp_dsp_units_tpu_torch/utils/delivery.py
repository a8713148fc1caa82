"""Output delivery as TPDF-dithered int16 PCM: the port of
utils/delivery.py.  The noise table comes from the same numpy generator
and seed as the JAX package's, so both deliver the same samples."""

from __future__ import annotations

import numpy as np
import torch

TABLE_EXTRA = 65536          # per-call offset wraps at this many slots


def tpdf_i16_table(channels: int, t: int, seed: int = 7,
                   device="cuda") -> torch.Tensor:
    """[channels, t + TABLE_EXTRA] float32 TPDF noise at +-0.5 LSB."""
    rng = np.random.default_rng(seed)
    delta_half = 0.5 / 32768.0
    noise = ((rng.random((channels, t + TABLE_EXTRA))
              + rng.random((channels, t + TABLE_EXTRA)) - 1.0)
             * delta_half).astype(np.float32)
    return torch.from_numpy(noise).to(device)


def quantize_i16(y: torch.Tensor, table: torch.Tensor, k: int
                 ) -> torch.Tensor:
    """Dither + quantize [C, T] float32 to int16 PCM; ``k`` is the
    per-call table offset (wraps at TABLE_EXTRA)."""
    off = int(k) & (TABLE_EXTRA - 1)
    noise = table[:, off:off + y.shape[-1]]
    return torch.clamp((y + noise) * 32767.0, -32768.0,
                       32767.0).to(torch.int16)
