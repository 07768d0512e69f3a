"""The program's spans of its batching layer over the measured window.

``solve_batch`` logs one span ``batch`` a call (``karpenter_core_tpu_torch/
tracing.py``), naming every member's request and counting the call's
stats; a batched dispatch logs ``dispatch`` with its parts
``dispatch.stack`` and ``dispatch.gather``, a solo one ``dispatch``; each
dispatch carries its device seconds as the count ``device_s``.

``spans(ctx, names)`` keeps the spans of those names that started at or
after the window's first call started and ended by its last call's end
(the harness's clock is the same ``perf_counter``), so warm-up calls and
the traced calls after the window fall outside. It returns None, and the
metric reads nothing, for a program without the span log or a log that no
longer reaches back to the window's start.
"""
from __future__ import annotations

from typing import List, Optional, Sequence


def spans(ctx, names: Sequence[str]) -> Optional[List]:
    """The window's spans called one of ``names``, or None."""
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
    return [s for s in log
            if s.name in names and t0 <= s.start and s.end <= t1]


def grants(ctx) -> Optional[List]:
    """The window's ``batch`` spans, one a grant; None where the program
    has none (a program older than the span)."""
    out = spans(ctx, ("batch",))
    return out or None
