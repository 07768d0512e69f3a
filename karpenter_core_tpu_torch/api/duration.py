"""NillableDuration — a duration that may be 'Never' (reference: pkg/apis/v1/duration.go)."""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(h|m|s|ms)")
_UNIT = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 1e-3}


def parse_duration(s: "str | int | float | None") -> Optional[float]:
    """Parse a Go-style duration ('1h30m', '15s') to seconds; None/'Never' -> None."""
    if s is None:
        return None
    if isinstance(s, (int, float)):
        return float(s)
    s = s.strip()
    if s == "Never":
        return None
    if s == "0":
        return 0.0
    matches = _DUR_RE.findall(s)
    if not matches or "".join(n + u for n, u in matches) != s:
        raise ValueError(f"cannot parse duration {s!r}")
    return sum(float(n) * _UNIT[u] for n, u in matches)


@dataclass(frozen=True)
class NillableDuration:
    """seconds=None means Never."""

    seconds: Optional[float] = None

    @classmethod
    def parse(cls, s) -> "NillableDuration":
        return cls(parse_duration(s))

    @property
    def is_never(self) -> bool:
        return self.seconds is None

    def __str__(self) -> str:
        return "Never" if self.seconds is None else f"{self.seconds:g}s"


NEVER = NillableDuration(None)
