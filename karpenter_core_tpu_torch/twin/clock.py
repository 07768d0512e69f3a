"""Virtual time for the digital twin.

Every TTL/backoff surface in the control plane already takes an injectable
clock (utils/clock.Clock) or time function: the operator's reconcile
backoffs, the ICE cache, validation TTLs, the recorder's dedupe window.
The solver tier's client-side state — circuit-breaker cooldowns, retry
sleeps, poison-quarantine TTLs — takes ``time_fn``/``sleep`` callables
instead. ``VirtualClock`` is one object that serves both shapes, so the
twin can thread a SINGLE virtual timeline through all of them and replay
days of churn in minutes: ``sleep`` advances time instead of spending it,
and ``monotonic`` aliases ``now`` (virtual time never steps backward —
``advance_to`` is monotone by construction).
"""
from __future__ import annotations

from karpenter_core_tpu_torch.utils.clock import FakeClock


class VirtualClock(FakeClock):
    """A steppable clock that also quacks like time.monotonic/time.sleep."""

    def monotonic(self) -> float:
        return self.now()

    def sleep(self, seconds: float) -> None:
        """A virtual sleep costs virtual time, not wall time — retry
        backoffs and Retry-After waits elapse instantly but still ORDER
        correctly against every TTL riding the same clock."""
        if seconds > 0:
            self.step(seconds)

    def advance_to(self, t: float) -> None:
        """Move to absolute virtual time t, never backward (reconcile
        passes may have stepped past a tick boundary while elapsing
        batcher windows or backoffs)."""
        if t > self.now():
            self.set(t)
