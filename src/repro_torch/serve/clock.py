"""Injectable clocks (copied from ``repro.distributed.fault_tolerance``): the
engine reads time only through a :class:`Clock`, so tests can drive it
with a :class:`ManualClock`."""
from __future__ import annotations

import time


class Clock:
    """Injectable monotonic time source (seconds)."""

    def now(self) -> float:
        raise NotImplementedError


class SystemClock(Clock):
    """Real time (``time.monotonic``)."""

    def now(self) -> float:
        return time.monotonic()


class ManualClock(Clock):
    """Deterministic test clock: time moves only when advanced."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, dt_s: float) -> float:
        if dt_s < 0.0:
            raise ValueError("time is monotonic")
        self._now += float(dt_s)
        return self._now
