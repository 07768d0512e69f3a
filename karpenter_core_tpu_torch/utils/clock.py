"""Injectable clock (the reference uses k8s.io/utils/clock everywhere so
TTL/window logic is testable; FakeClock mirrors clock/testing)."""
from __future__ import annotations

import time


class Clock:
    def now(self) -> float:
        return time.time()

    def since(self, t: float) -> float:
        return self.now() - t


class FakeClock(Clock):
    def __init__(self, start: float = 1_000_000.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def step(self, seconds: float) -> None:
        self._now += seconds

    def set(self, t: float) -> None:
        self._now = t
