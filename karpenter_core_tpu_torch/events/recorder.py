"""Event recorder with dedupe + rate limiting
(reference: pkg/events/recorder.go:30-100)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

DEDUPE_TTL = 120.0  # 2-minute dedupe cache (recorder.go:35)
RATE_LIMIT_QPS = 10.0


@dataclass
class Event:
    involved_object: str  # "Kind/name"
    type: str  # Normal | Warning
    reason: str
    message: str
    timestamp: float = 0.0

    def dedupe_key(self) -> tuple:
        return (self.involved_object, self.type, self.reason, self.message)


class Recorder:
    """In-memory recorder: events land in .events (the store's apiserver
    role); duplicates within the TTL are dropped, and per-reason token
    buckets cap the flow like the reference's flowcontrol limiter."""

    def __init__(self, clock):
        self.clock = clock
        self.events: List[Event] = []
        self._seen: Dict[tuple, float] = {}
        self._bucket: Dict[str, float] = {}
        self._bucket_t: Dict[str, float] = {}

    def publish(self, *events: Event) -> None:
        for e in events:
            now = self.clock.now()
            e.timestamp = now
            key = e.dedupe_key()
            last = self._seen.get(key)
            if last is not None and now - last < DEDUPE_TTL:
                continue
            if not self._allow(e.reason, now):
                continue
            self._seen[key] = now
            self.events.append(e)
            if len(self._seen) > 4096:
                self._seen = {
                    k: t
                    for k, t in self._seen.items()
                    if now - t < DEDUPE_TTL
                }

    def _allow(self, reason: str, now: float) -> bool:
        tokens = self._bucket.get(reason, RATE_LIMIT_QPS)
        tokens = min(
            RATE_LIMIT_QPS,
            tokens + (now - self._bucket_t.get(reason, now)) * RATE_LIMIT_QPS,
        )
        if tokens < 1.0:
            self._bucket[reason] = tokens
            self._bucket_t[reason] = now
            return False
        self._bucket[reason] = tokens - 1.0
        self._bucket_t[reason] = now
        return True

    def with_reason(self, reason: str) -> List[Event]:
        return [e for e in self.events if e.reason == reason]
