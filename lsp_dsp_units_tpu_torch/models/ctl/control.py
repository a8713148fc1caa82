"""Control-rate primitives: Counter, Toggle, Blink
(reference: src/main/ctl/{Counter,Toggle,Blink}.cpp), the port's own
copy of models/ctl/control.py.

These are host-side control logic (no audio touches the device), so they
are plain Python state machines, as in the JAX package.
"""

from __future__ import annotations


class Counter:
    """Sample-count event timer firing every N samples / at a frequency
    (reference Counter.cpp)."""

    def __init__(self, sample_rate: int = 48000, frequency: float = 1.0):
        self.sample_rate = int(sample_rate)
        self.frequency = float(frequency)
        self.initial = max(1, int(sample_rate / frequency))
        self.current = self.initial
        self.fired = False
        # which quantity survives a sample-rate change (reference
        # F_INITIAL flag, Counter.h:37): set_initial_value pins the
        # COUNT (frequency recomputed); set_frequency / the
        # preserve_* methods flip the mode
        self._preserve_initial = False

    def set_sample_rate(self, sr: int, reset: bool = True) -> None:
        """On a rate change the pinned quantity survives: in
        initial-value mode the count stays and the frequency is
        recomputed; in frequency mode the count is recomputed
        (reference Counter.cpp:52-63)."""
        self.sample_rate = int(sr)
        if self._preserve_initial:
            self.frequency = self.sample_rate / float(self.initial)
        else:
            self.initial = max(1, int(sr / self.frequency))
        if reset:
            self.current = self.initial

    def set_frequency(self, freq: float, reset: bool = True) -> None:
        self._preserve_initial = False
        self.frequency = float(freq)
        self.initial = max(1, int(self.sample_rate / freq))
        if reset:
            self.current = self.initial

    def set_initial_value(self, value: int, reset: bool = True) -> None:
        self._preserve_initial = True
        self.initial = int(value)
        self.frequency = self.sample_rate / float(value)
        if reset:
            self.current = self.initial

    def preserve_frequency(self) -> None:
        """Future sample-rate changes keep the frequency
        (reference Counter.h:143-145)."""
        self._preserve_initial = False

    def preserve_initial_value(self) -> None:
        """Future sample-rate changes keep the initial count
        (reference Counter.h:151-153)."""
        self._preserve_initial = True

    def pending(self) -> int:
        """Samples left until the next event (reference Counter.h)."""
        return self.current

    def submit(self, samples: int) -> bool:
        """Advance by ``samples``; returns (and latches) the fired flag
        (reference Counter::submit)."""
        left = self.current - int(samples)
        if left <= 0:
            # C-truncated modulo (left <= 0 -> remainder in (-initial, 0]),
            # so the reload lands in (0, initial] as the reference's
            # ssize_t arithmetic does; Python's floor modulo would land in
            # [initial, 2*initial) and drift the timer a full period
            rem = -((-left) % self.initial) if self.initial else 0
            self.current = self.initial + rem
            self.fired = True
        else:
            self.current = left
        return self.fired

    def commit(self) -> bool:
        res = self.fired
        self.fired = False
        return res

    def reset(self) -> bool:
        res = self.fired
        self.current = self.initial
        return res


class Toggle:
    """Debounced on/off toggle (reference Toggle.cpp)."""

    OFF, PENDING, ON = 0, 1, 2

    def __init__(self):
        self.value = 0.0
        self.state = Toggle.OFF

    def init(self) -> None:
        self.value = 0.0
        self.state = Toggle.OFF

    def submit(self, value: float) -> bool:
        if value >= 0.5:
            if self.state == Toggle.OFF:
                self.state = Toggle.PENDING
        else:
            if self.state == Toggle.ON:
                self.state = Toggle.OFF
        self.value = float(value)
        return self.state == Toggle.ON

    def commit(self, off: bool = False) -> bool:
        if self.state != Toggle.PENDING:
            return self.state == Toggle.ON
        if off:
            if self.value < 0.5:
                self.state = Toggle.OFF
        else:
            self.state = Toggle.ON if self.value >= 0.5 else Toggle.OFF
        return self.state == Toggle.ON

    def pending(self) -> bool:
        return self.state == Toggle.PENDING


class Blink:
    """UI LED blink timer (reference Blink.cpp)."""

    def __init__(self, sample_rate: int = 48000, time_s: float = 0.1):
        self.time_s = float(time_s)
        self.time = int(sample_rate * time_s)
        self.counter = 0
        self.on_value = 1.0
        self.off_value = 0.0

    def set_sample_rate(self, sr: int) -> None:
        self.time = int(sr * self.time_s)

    def blink(self, value: float = 1.0) -> None:
        self.counter = self.time
        self.on_value = float(value)

    def blink_max(self, value: float) -> None:
        if self.counter <= 0 or self.on_value < value:
            self.on_value = float(value)
            self.counter = self.time

    def blink_min(self, value: float) -> None:
        if self.counter <= 0 or self.on_value > value:
            self.on_value = float(value)
            self.counter = self.time

    def set_default(self, on: float, off: float) -> None:
        self.on_value = float(on)
        self.off_value = float(off)

    def process(self, samples: int) -> float:
        result = self.on_value if self.counter > 0 else self.off_value
        self.counter -= int(samples)
        return result
