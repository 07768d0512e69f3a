"""Minimal 5-field cron matching for disruption budget windows
(reference: nodepool.go:353-367 uses robfig/cron)."""
from __future__ import annotations

import time
from typing import Optional


def _parse_field(field: str, lo: int, hi: int) -> set:
    out = set()
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part in ("*", ""):
            rng = range(lo, hi + 1)
        elif "-" in part:
            a, b = part.split("-", 1)
            rng = range(int(a), int(b) + 1)
        else:
            rng = range(int(part), int(part) + 1)
        out.update(v for v in rng if (v - lo) % step == 0 or step == 1)
    return out


def matches(expr: str, ts: float) -> bool:
    """True if the cron expression fires at the minute containing ts (UTC)."""
    fields = expr.split()
    if fields and fields[0].startswith("@"):
        expr = {"@daily": "0 0 * * *", "@hourly": "0 * * * *",
                "@weekly": "0 0 * * 0", "@monthly": "0 0 1 * *"}.get(fields[0], expr)
        fields = expr.split()
    if len(fields) != 5:
        raise ValueError(f"cannot parse cron expression {expr!r}")
    minute, hour, dom, month, dow = fields
    tm = time.gmtime(ts)
    return (
        tm.tm_min in _parse_field(minute, 0, 59)
        and tm.tm_hour in _parse_field(hour, 0, 23)
        and tm.tm_mday in _parse_field(dom, 1, 31)
        and tm.tm_mon in _parse_field(month, 1, 12)
        and (tm.tm_wday + 1) % 7 in _parse_field(dow, 0, 6)
    )


def last_fire_before(expr: str, now: float, horizon_days: int = 35) -> Optional[float]:
    """Most recent fire time <= now, scanned minute-wise back over the horizon."""
    minute = int(now // 60) * 60
    for _ in range(horizon_days * 24 * 60):
        if matches(expr, minute):
            return float(minute)
        minute -= 60
    return None
