"""Host-side block streaming: the port of utils/blocks.py.  Drives a
fixed-block processor with arbitrary caller chunk sizes.

The reference rebuffers internally everywhere (e.g. Equalizer.cpp:477-518
accumulates a frame, emits the previous one); here the rebuffering lives
on the host, and each full block goes to the processor as a torch tensor
on the stream's device.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np
import torch


class BlockStream:
    """Wraps ``process(state, x_block) -> (state, y_block)`` (fixed block
    length B on the last axis, torch tensors) into a push API taking any
    chunk size of host samples.  Output is delayed by exactly B samples
    (one block of latency), mirroring the reference's frame-accumulation
    pattern."""

    def __init__(self, process: Callable[[Any, torch.Tensor],
                                         Tuple[Any, torch.Tensor]],
                 state: Any, block: int, batch_shape: Tuple[int, ...] = (),
                 device="cuda"):
        self.process = process
        self.state = state
        self.block = int(block)
        self.batch_shape = tuple(batch_shape)
        self.device = torch.device(device)
        self._in = np.zeros(self.batch_shape + (self.block,), np.float32)
        self._out = np.zeros(self.batch_shape + (self.block,), np.float32)
        self._fill = 0

    @property
    def latency(self) -> int:
        return self.block

    def _run(self, x: np.ndarray) -> None:
        # the processor may keep the block it was given (an overlap-save
        # history does), and on the CPU torch.from_numpy shares the
        # buffer, so the caller hands over x and never refills it
        self.state, y = self.process(
            self.state, torch.from_numpy(x).to(self.device))
        self._out = y.detach().to("cpu", torch.float32).numpy().copy()

    def push(self, x: np.ndarray) -> np.ndarray:
        """Feed ``x`` ([..., n]); returns n output samples (delayed)."""
        x = np.asarray(x)
        n = x.shape[-1]
        out = np.empty_like(x)
        done = 0
        while done < n:
            take = min(self.block - self._fill, n - done)
            self._in[..., self._fill:self._fill + take] = \
                x[..., done:done + take]
            out[..., done:done + take] = \
                self._out[..., self._fill:self._fill + take]
            self._fill += take
            done += take
            if self._fill == self.block:
                self._run(self._in)
                self._in = np.zeros_like(self._in)
                self._fill = 0
        return out

    def flush(self) -> np.ndarray:
        """Drain the one block of buffered latency: the unemitted tail of
        the previous block's output plus (if a partial block is pending)
        the zero-padded partial block's head.  Always returns exactly
        ``block`` samples, for offline tails."""
        tail = self._out[..., self._fill:].copy()
        if self._fill:
            pad = np.zeros_like(self._in)
            pad[..., :self._fill] = self._in[..., :self._fill]
            self._run(pad)
            self._in = np.zeros_like(self._in)
            head = self._out[..., :self._fill].copy()
        else:
            head = np.zeros(self.batch_shape + (0,), self._out.dtype)
        self._fill = 0
        self._out = np.zeros_like(self._out)
        return np.concatenate([tail, head], axis=-1)


def pad_to_multiple(x: np.ndarray, block: int) -> Tuple[np.ndarray, int]:
    """Zero-pad the last axis up to a multiple of ``block``."""
    t = x.shape[-1]
    pad = (-t) % block
    if pad:
        x = np.concatenate(
            [x, np.zeros(x.shape[:-1] + (pad,), x.dtype)], axis=-1)
    return x, pad
