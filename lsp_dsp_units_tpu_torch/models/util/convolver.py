"""Convolver — partitioned FFT convolution engine: the port of
models/util/convolver.py.

A uniform frequency-delay-line (FDL) partitioned overlap-save convolver
(ops/fftconv.py) with zero latency: the newest block contributes through
partition 0 in the same step.  ``rank`` selects the internal block size
2**(rank-1), within the reference's rank range [8, 16].  On the card
each call's transforms run the packed FFT kernels (ops/cplx.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.ops import fftconv
from lsp_dsp_units_tpu_torch.ops.cplx import irfft_sc, rfft_sc, sc_mul

CONVOLVER_RANK_MIN = 8    # reference Convolver.h:28
CONVOLVER_RANK_MAX = 16   # reference Convolver.h:29


class Convolver:
    """Streaming FFT convolver with explicit state.

    Build it with the impulse response, then call :meth:`process` with
    input whose length is a multiple of the internal block, or wrap it in
    utils.blocks.BlockStream for arbitrary chunk sizes."""

    def __init__(self, ir, rank: int = 12, device="cuda"):
        rank = int(np.clip(rank, CONVOLVER_RANK_MIN, CONVOLVER_RANK_MAX))
        self.rank = rank
        self.block = 1 << (rank - 1)
        self.device = torch.device(device)
        ir = torch.as_tensor(ir, dtype=torch.float32, device=self.device)
        self.ir_length = int(ir.shape[-1])
        self.h_spectra = fftconv.parse_ir(ir, self.block)

    @property
    def partitions(self) -> int:
        return self.h_spectra.re.shape[-2]

    def latency(self) -> int:
        """Zero latency, like the reference (direct head segment)."""
        return 0

    def init_state(self, batch_shape: Tuple[int, ...] = ()
                   ) -> fftconv.FDLState:
        return fftconv.init_fdl(self.h_spectra, batch_shape, self.device)

    def process(self, state: fftconv.FDLState, x: torch.Tensor
                ) -> Tuple[fftconv.FDLState, torch.Tensor]:
        """x's last axis must be a multiple of ``self.block``."""
        return fftconv.fdl_process(self.h_spectra, state, x)


def convolve_oneshot(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Full linear convolution truncated to len(x), via one zero-padded
    FFT: for offline use and tests."""
    t = x.shape[-1]
    n = t + h.shape[-1]
    size = 1
    while size < n:
        size <<= 1
    xs = rfft_sc(x, size)
    hs = rfft_sc(h, size)
    y = irfft_sc(sc_mul(xs, hs), size)
    return y[..., :t].to(x.dtype)
