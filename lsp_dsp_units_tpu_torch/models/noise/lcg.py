"""LCG noise generator with uniform/exponential/triangular/gaussian
distributions (reference: src/main/noise/LCG.cpp, LCG.h:32-38), the port
of the JAX package's models/noise/lcg.py.

Two paths: the exact reference-parity path over
:class:`...util.randomizer.Randomizer` (host numpy, the same numbers as
the JAX package's), and a bulk device path drawing from a caller's
``torch.Generator`` (the same distributions, not the same numbers).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.models.util.randomizer import (
    RAND_LAMBDA, RAND_T, RandomFunction, Randomizer)


class LCGDistribution(enum.Enum):
    UNIFORM = "uniform"
    EXPONENTIAL = "exponential"
    TRIANGULAR = "triangular"
    GAUSSIAN = "gaussian"


class LCG:
    def __init__(self, distribution: LCGDistribution =
                 LCGDistribution.UNIFORM, amplitude: float = 1.0,
                 offset: float = 0.0, seed: int | None = None):
        self.distribution = distribution
        self.amplitude = float(amplitude)
        self.offset = float(offset)
        self.rand = Randomizer(seed)

    def process(self, count: int) -> np.ndarray:
        """(reference LCG::process_single semantics over a block)"""
        a, o = self.amplitude, self.offset
        d = self.distribution
        if d == LCGDistribution.EXPONENTIAL:
            # the reference draws sign THEN magnitude PER SAMPLE
            # (LCG.cpp:64-72), so the Randomizer stream interleaves
            # sign0,mag0,sign1,mag1,... — draw 2*count linear values
            # and apply the RND_EXP transform to the odd positions
            u = self.rand.random(RandomFunction.LINEAR, 2 * count)
            sign = np.where(u[0::2] >= 0.5, 1.0, -1.0)
            mag = (np.exp(RAND_LAMBDA * u[1::2]) - 1.0) \
                / (np.exp(RAND_LAMBDA) - 1.0)
            return sign * a * mag + o
        if d == LCGDistribution.TRIANGULAR:
            # the -0.5 sits OUTSIDE the amplitude scaling (asymmetric,
            # non-zero-mean) — reproducing the reference verbatim
            # (LCG.cpp:76)
            return 2.0 * a * self.rand.random(RandomFunction.TRIANGLE,
                                              count) - 0.5 + o
        if d == LCGDistribution.GAUSSIAN:
            return a * self.rand.random(RandomFunction.GAUSSIAN, count) + o
        return 2.0 * a * (self.rand.random(RandomFunction.LINEAR, count)
                          - 0.5) + o


def lcg_device(generator: torch.Generator, shape,
               distribution: LCGDistribution = LCGDistribution.UNIFORM,
               amplitude: float = 1.0, offset: float = 0.0,
               device="cuda") -> torch.Tensor:
    """Bulk float32 noise on ``device`` with the LCG's distribution shapes,
    drawn from ``generator`` (a generator of that device).  Not the
    reference LCG's numbers: use :class:`LCG` for parity."""
    def uniform():
        return torch.rand(shape, generator=generator, device=device)

    if distribution == LCGDistribution.EXPONENTIAL:
        sign = torch.where(uniform() >= 0.5, 1.0, -1.0)
        mag = (torch.exp(RAND_LAMBDA * uniform()) - 1.0) / (
            np.exp(RAND_LAMBDA) - 1.0)
        return sign * amplitude * mag + offset
    if distribution == LCGDistribution.TRIANGULAR:
        rv = uniform()
        tri = torch.where(rv <= 0.5,
                          np.sqrt(2.0) * RAND_T * torch.sqrt(rv),
                          2.0 * RAND_T - torch.sqrt(4.0 - 2.0 * (1.0 + rv))
                          * RAND_T)
        return 2.0 * amplitude * tri - 0.5 + offset  # verbatim LCG.cpp:76
    if distribution == LCGDistribution.GAUSSIAN:
        return amplitude * torch.randn(shape, generator=generator,
                                       device=device) + offset
    return 2.0 * amplitude * (uniform() - 0.5) + offset
