"""The program's own spans over the measured window.

The port logs a span at each layer boundary (``karpenter_core_tpu_torch/
tracing.py``): a bounded in-memory log of records with a name, the
request ids they served, their parent, start and end on the
``perf_counter`` clock, and counts. Each ``DeviceScheduler.solve`` and
each ``frontier_core`` call is one request, its root span ``solve`` or
``sweep``.

``window(ctx)`` keeps the requests whose root span started at or after
the window's first call started (its ``t_end - dt``) and ended by the
last call's ``t_end``: the harness's clock is the same ``perf_counter``,
so warm-up calls, and the traced calls after the window, fall outside.
It returns None, and the metric reads nothing, for a program without the
log (a checkout older than it) or a log that no longer reaches back to
the window's start.
"""
from __future__ import annotations

from typing import Dict, List, Optional


def window(ctx) -> Optional[Dict[int, List]]:
    """{request id: its spans, root first} over the window, or None."""
    try:
        from karpenter_core_tpu_torch import tracing
    except ImportError:
        return None
    if not ctx.records:
        return None
    t0 = ctx.records[0]["t_end"] - ctx.records[0]["dt"]
    t1 = ctx.records[-1]["t_end"]
    log = list(tracing.LOG)
    # records are appended as they end: the oldest kept one ending before
    # the window means nothing of the window was pushed out
    if not log or log[0].end > t0:
        ctx.log("program spans: the span log does not reach back to the"
                " window's start")
        return None
    roots = {s.request: s for s in log
             if s.parent is None and s.request is not None
             and t0 <= s.start and s.end <= t1}
    out: Dict[int, List] = {rid: [root] for rid, root in roots.items()}
    for s in log:
        for rid in s.requests:
            spans = out.get(rid)
            if spans is not None and s is not roots[rid]:
                spans.append(s)
    return out


def per_request(ctx, name: str, key: Optional[str] = None
                ) -> Optional[List[float]]:
    """For each request of the window: the seconds of its spans called
    ``name`` summed, or with ``key`` the count ``key`` of those spans
    summed (a span serving several requests counts its share). None when
    the window has no request, or with ``key`` when no span has it."""
    reqs = window(ctx)
    if not reqs:
        return None
    out, seen = [], False
    for spans in reqs.values():
        total = 0.0
        for s in spans:
            if s.name != name:
                continue
            if key is None:
                total += s.end - s.start
            elif s.counts and key in s.counts:
                seen = True
                total += s.counts[key] / len(s.requests)
        out.append(total)
    return out if key is None or seen else None


def log_children(ctx, name: str) -> None:
    """Standard error: the spans a request, and the share of the spans
    called ``name`` that their children cover, over the window."""
    reqs = window(ctx)
    if not reqs:
        return
    whole = kids = 0.0
    for spans in reqs.values():
        for s in spans:
            if s.name == name:
                whole += s.end - s.start
            elif s.parent is not None and s.parent.name == name:
                kids += s.end - s.start
    n = sum(len(spans) for spans in reqs.values()) / len(reqs)
    share = 100.0 * kids / whole if whole else float("nan")
    ctx.log(f"program spans: {n!r} a request over {len(reqs)} requests;"
            f" the children of {name} cover {share!r}% of it")


def log_trace_bounds(ctx, device_ms: Optional[float]) -> None:
    """Standard error: a call's device time beside the traced sub-window's
    scan kernel seconds and busy seconds a call."""
    t = ctx.trace
    if device_ms is None or not t or not t.get("units"):
        return
    ctx.log(f"device {device_ms!r} ms a call; the trace's scan kernel"
            f" {1e3 * t['scan_s'] / t['units']!r} ms and busy"
            f" {1e3 * t['busy_s'] / t['units']!r} ms a call")


def mean_ms(values: Optional[List[float]]) -> Optional[float]:
    """The mean of seconds, in milliseconds (None for None)."""
    if not values:
        return None
    return 1e3 * sum(values) / len(values)
