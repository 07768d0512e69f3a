"""Pod-trigger batching window (reference: pkg/controllers/provisioning/
batcher.go:33-110; 10s max / 1s idle from options.go:99-100).

Triggers (provisionable-pod events) open a window; the batch closes — and
the provisioner solves — when either no new trigger arrived for
``idle_duration`` or the window has been open ``max_duration``. The batch
boundary IS the solver-invocation boundary: wider batches amortize one
device solve over more pods.
"""
from __future__ import annotations

from typing import Optional


class Batcher:
    def __init__(
        self,
        clock,
        max_duration: float = 10.0,
        idle_duration: float = 1.0,
    ):
        self.clock = clock
        self.max_duration = max_duration
        self.idle_duration = idle_duration
        self._window_start: Optional[float] = None
        self._last_trigger: Optional[float] = None

    def trigger(self) -> None:
        now = self.clock.now()
        if self._window_start is None:
            self._window_start = now
        self._last_trigger = now

    @property
    def open(self) -> bool:
        return self._window_start is not None

    def ready(self) -> bool:
        """The window has closed (batcher.go Wait's two exits)."""
        if self._window_start is None:
            return False
        now = self.clock.now()
        if now - self._window_start >= self.max_duration:
            return True
        return now - self._last_trigger >= self.idle_duration

    def wait_remaining(self) -> float:
        """Seconds until the window would close with no further triggers."""
        if self._window_start is None:
            return 0.0
        now = self.clock.now()
        return max(
            min(
                self.idle_duration - (now - self._last_trigger),
                self.max_duration - (now - self._window_start),
            ),
            0.0,
        )

    def reset(self) -> None:
        self._window_start = None
        self._last_trigger = None
