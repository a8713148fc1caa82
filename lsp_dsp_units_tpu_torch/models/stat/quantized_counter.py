"""QuantizedCounter: a sliding-window histogram of signal values
(reference: src/main/stat/QuantizedCounter.cpp), the port of
models/stat/quantized_counter.py.  N levels between min and max plus
below/above/NaN buckets, counting only the last ``period`` samples (the
reference keeps a history ring and evicts values older than nPeriod,
evict_values, :228-240).

Each call bincounts the incoming block and bincounts the span of the
history ring it evicts: two passes on the device whatever the block size,
with the ring's bookkeeping (head, count) in 0-d tensors, as in the JAX
unit, so its state (and a checkpoint of it) is the JAX unit's.

Bucket edges follow the reference's C truncation toward zero
(inc_counters, :203-207): ``index = int((x - min) / step)`` puts values
in ``(min - step, min)`` at level 0, not below; only ``x <= min - step``
goes below.  The bucket is a decision, so its rounding is pinned: ``x -
min`` and the division by ``step`` are each one float32 rounding, a true
division (as the JAX unit's element-wise operations round; a tensor
divided by a Python scalar would be a product with its reciprocal on a
CUDA tensor), and an index beyond int32 saturates, as XLA's conversion
does, so it counts above.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

I32 = torch.int32


class QuantizedCounterState(NamedTuple):
    counts: torch.Tensor   # [levels] int32
    below: torch.Tensor    # [] int32
    above: torch.Tensor    # [] int32
    nans: torch.Tensor     # [] int32
    total: torch.Tensor    # [] int32 samples currently in the window
    history: torch.Tensor  # [capacity] float32 ring of the windowed samples
    head: torch.Tensor     # [] int32 ring write position
    count: torch.Tensor    # [] int32 valid samples in the ring


class QuantizedCounter:
    def __init__(self, minimum: float = -1.0, maximum: float = 1.0,
                 levels: int = 256, period: int = 0, capacity: int = 0):
        """``period`` = sliding window length in samples (0: infinite, the
        counts accumulate forever and no history is kept).  ``capacity``
        sizes the history ring (defaults to the period)."""
        self.minimum = float(minimum)
        self.maximum = float(maximum)
        self.levels = int(levels)
        self.step = (self.maximum - self.minimum) / self.levels
        self.period = int(period)
        self.capacity = int(capacity) if capacity else self.period

    def init_state(self, device="cuda") -> QuantizedCounterState:
        def z():
            return torch.zeros((), dtype=I32, device=device)
        return QuantizedCounterState(
            counts=torch.zeros(self.levels, dtype=I32, device=device),
            below=z(), above=z(), nans=z(), total=z(),
            history=torch.zeros(max(self.capacity, 1), dtype=torch.float32,
                                device=device),
            head=z(), count=z())

    def _bucketize(self, x: torch.Tensor):
        """(level index [N], below, above, nan, inside masks)."""
        isnan = torch.isnan(x)
        safe = torch.where(isnan, self.minimum, x)
        step = torch.tensor(self.step, dtype=torch.float32, device=x.device)
        raw = (safe - self.minimum) / step
        below = ~isnan & (raw <= -1.0)
        # trunc(raw) >= levels exactly when raw >= levels (levels is an
        # integer), also where the int32 conversion saturates
        above = ~isnan & (raw >= self.levels)
        inside = ~(isnan | below | above)
        idx = torch.clamp(raw, 0.0, self.levels - 1).to(I32)
        return idx, below, above, isnan, inside

    def _tally(self, x: torch.Tensor, sign: int):
        idx, below, above, isnan, inside = self._bucketize(x)
        # the samples outside the levels go to a spare bin
        bins = torch.bincount(torch.where(inside, idx, self.levels).long(),
                              minlength=self.levels + 1)
        add = (bins[:self.levels] * sign).to(I32)
        return (add, sign * torch.sum(below, dtype=I32),
                sign * torch.sum(above, dtype=I32),
                sign * torch.sum(isnan, dtype=I32))

    def _evict(self, counts, below, above, nans, history, head, count,
               keep):
        """Decrement the tallies of the oldest ``count - keep`` ring
        samples (a masked pass over the whole ring)."""
        cap = history.shape[0]
        lanes = torch.arange(cap, device=history.device)
        excess = torch.clamp(count - keep, min=0)
        start = (head - count) % cap               # the oldest sample
        old = history[(start + lanes) % cap]
        mask = lanes < excess
        sub, eb, ea, _ = self._tally(torch.where(mask, old, torch.nan), -1)
        # lanes not evicted are NaN padding (invisible to the levels and
        # to below/above); evicted NaNs count from the ring itself
        en = -torch.sum(mask & torch.isnan(old), dtype=I32)
        return (counts + sub, below + eb, above + ea, nans + en,
                count - excess)

    def process(self, state: QuantizedCounterState, x: torch.Tensor
                ) -> QuantizedCounterState:
        x = x.reshape(-1)
        n = x.numel()

        if self.period <= 0:
            add, b, a, nn = self._tally(x, +1)
            return state._replace(
                counts=state.counts + add, below=state.below + b,
                above=state.above + a, nans=state.nans + nn,
                total=state.total + n)

        cap = self.capacity
        # samples beyond the ring's capacity would be evicted within this
        # very call: only the last min(n, cap) enter the window
        tail_x = x[-cap:] if n > cap else x
        tn = tail_x.numel()

        # 1. evict the ring samples the new write overwrites
        counts, below, above, nans, count = self._evict(
            state.counts, state.below, state.above, state.nans,
            state.history, state.head, state.count, cap - tn)

        # 2. tally and write the incoming samples
        add, b, a, nn = self._tally(tail_x, +1)
        counts, below, above, nans = (counts + add, below + b, above + a,
                                      nans + nn)
        head = (state.head + tn) % cap
        pos = (head - tn + torch.arange(tn, device=x.device)) % cap
        history = state.history.clone()
        history[pos] = tail_x.to(torch.float32)
        count = count + tn

        # 3. evict everything beyond the window period
        counts, below, above, nans, count = self._evict(
            counts, below, above, nans, history, head, count, self.period)

        return QuantizedCounterState(
            counts=counts, below=below, above=above, nans=nans, total=count,
            history=history, head=head, count=count)
