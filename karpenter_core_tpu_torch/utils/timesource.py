"""Process-wide time source for object timestamps.

The reference gets testable time by injecting k8s.io/utils/clock into every
controller AND running envtest with real wall-clock objects. Our dataclass
defaults (ObjectMeta.creation_timestamp, Condition.last_transition_time)
need a seam instead: the Operator points this module at its clock so fake
clocks drive every timestamp consistently."""
from __future__ import annotations

import time
from typing import Callable

_now: Callable[[], float] = time.time


def now() -> float:
    return _now()


def set_source(fn: Callable[[], float]) -> None:
    global _now
    _now = fn
