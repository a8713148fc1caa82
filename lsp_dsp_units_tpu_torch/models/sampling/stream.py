"""InSampleStream — streaming-read adapter over a Sample: a copy of the
JAX package's models/sampling/stream.py (host numpy; reference
src/main/sampling/InSampleStream.cpp, an mm::IInAudioStream view of an
in-memory Sample for saving/streaming).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from lsp_dsp_units_tpu_torch.models.sampling.sample import Sample


class InSampleStream:
    def __init__(self, sample: Sample, delete_on_close: bool = False):
        self._sample: Optional[Sample] = sample
        self._pos = 0
        self._delete = delete_on_close

    @property
    def sample_rate(self) -> int:
        return self._sample.sample_rate

    @property
    def channels(self) -> int:
        return self._sample.channels

    @property
    def length(self) -> int:
        return self._sample.length

    @property
    def position(self) -> int:
        return self._pos

    def seek(self, frames: int) -> int:
        self._pos = int(np.clip(frames, 0, self._sample.length))
        return self._pos

    def read(self, frames: int) -> np.ndarray:
        """Read up to ``frames`` -> [channels, n] (n may be short at EOF)."""
        end = min(self._pos + frames, self._sample.length)
        out = self._sample.data[:, self._pos:end].copy()
        self._pos = end
        return out

    def eof(self) -> bool:
        return self._pos >= self._sample.length

    def close(self) -> None:
        if self._delete:
            self._sample = None
