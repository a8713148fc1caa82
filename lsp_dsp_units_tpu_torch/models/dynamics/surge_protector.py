"""SurgeProtector: mutes output on sudden gain surges, the port of
models/dynamics/surge_protector.py (reference: src/main/dynamics/
SurgeProtector.cpp).

An on/off state machine with a transition ramp (sqrt-shaped) and a
shutdown timeout: the gate turns ON when the level exceeds on_threshold,
ramps the gain up over transition samples, and turns OFF after the level
has stayed below off_threshold for shutdown samples.  The per-sample
machine runs in ``ops/riders`` (``csrc/riders.cu`` on the card).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from lsp_dsp_units_tpu_torch.ops import riders


class SurgeProtectorState(NamedTuple):
    on: torch.Tensor               # [...] bool
    shutdown_time: torch.Tensor    # [...] int32
    transition_time: torch.Tensor  # [...] int32


class SurgeProtector:
    def __init__(self, on_threshold: float = 1e-3,
                 off_threshold: float = 1e-4,
                 transition_samples: int = 256,
                 shutdown_samples: int = 48000):
        self.on_threshold = float(on_threshold)
        self.off_threshold = float(off_threshold)
        self.transition_max = int(transition_samples)
        self.shutdown_max = int(shutdown_samples)

    def init_state(self, batch_shape: Tuple[int, ...] = (),
                   device="cuda") -> SurgeProtectorState:
        shape = tuple(batch_shape)
        return SurgeProtectorState(
            on=torch.zeros(shape, dtype=torch.bool, device=device),
            shutdown_time=torch.zeros(shape, dtype=torch.int32,
                                      device=device),
            transition_time=torch.zeros(shape, dtype=torch.int32,
                                        device=device))

    def process(self, state: SurgeProtectorState, x: torch.Tensor,
                ) -> Tuple[SurgeProtectorState, torch.Tensor]:
        """x: detector level [..., T] -> (state', gain [..., T])."""
        return riders.surge_protector(self, state, x)
