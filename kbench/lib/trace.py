"""The traced sub-window: device time from ``torch.profiler``.

After the measured window, a ``--trace 1`` run profiles a few more calls
of the same entry, with the harness's spans on (``lib/spans.py``) and the
FFD scan's entries captured for their bounds (``lib/roofline.py``). From
the profiler's trace it reads the device's busy seconds (the union of
kernels, copies and fills), the scan kernel's device seconds and launches,
the longest device operations and the idle gaps by the span the host was
in. A trace whose scan kernels fall short of the launches the port's own
counter (``ops/cuda_ffd.counter``) saw is incomplete: the sub-window is
halved until one is whole, and an incomplete trace gives no roofline.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List

from kbench.lib import roofline

SCAN_KERNEL = "k_ffd_scan"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "kbench.window"
# device operation names are C++ signatures; the breakdown keeps the head
NAME_CHARS = 120


@contextlib.contextmanager
def capture_scans(captured: List):
    """Keep each FFD scan launch's inputs and outputs (references only; the
    bounds are worked out after the sub-window, outside the trace)."""
    from karpenter_core_tpu_torch.ops import cuda_ffd

    solo, prefixes = cuda_ffd.cuda_ffd_solve, cuda_ffd.cuda_ffd_solve_prefixes

    def solo_cap(state, steps, statics, *args, **kwargs):
        out = solo(state, steps, statics, *args, **kwargs)
        captured.append(("solo", state, steps, statics, out))
        return out

    def prefixes_cap(state, steps, statics, *args, **kwargs):
        out = prefixes(state, steps, statics, *args, **kwargs)
        captured.append(("stack", None, steps, statics, out))
        return out

    cuda_ffd.cuda_ffd_solve = solo_cap
    cuda_ffd.cuda_ffd_solve_prefixes = prefixes_cap
    try:
        yield
    finally:
        cuda_ffd.cuda_ffd_solve = solo
        cuda_ffd.cuda_ffd_solve_prefixes = prefixes


def _bounds(captured) -> Dict:
    terms = []
    for kind, init, steps, statics, (state, takes, unplaced) in captured:
        if kind == "solo":
            terms.append(roofline.solo_terms(init, steps, statics, state,
                                             takes, unplaced))
        else:
            # the stack's kinds are written in place; an existing slot
            # stays 1 and a slot the scan opened becomes 2, so the kinds
            # at the start are the final 1s
            kind0 = (state.kind == 1).to(state.kind.dtype)
            terms.append(roofline.stack_terms(kind0, steps, statics, state,
                                              takes, unplaced))
    seconds, by = roofline.bound_s(terms)
    return {"bound_s": seconds, "bound_by": by,
            "bytes": sum(t[0] for t in terms),
            "operations": sum(t[1] for t in terms)}


def _union(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _read(path: str) -> Dict:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, spans, ops = [], [], defaultdict(float)
    scans, scan_us = 0, 0.0
    window = None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        s, d = float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATS:
            dev.append((s, s + d))
            ops[e.get("name", cat)] += d
            if SCAN_KERNEL in e.get("name", ""):
                scans += 1
                scan_us += d
        elif cat == "user_annotation":
            if e.get("name") == WINDOW:
                window = (s, s + d)
            else:
                spans.append((s, s + d, e.get("name", "")))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    busy_us = _union(dev)
    gaps = defaultdict(float)
    end = window[0]
    for s, e in sorted(dev) + [(window[1], window[1])]:
        if s > end:
            mid = (s + end) / 2
            inner = [sp for sp in spans if sp[0] <= mid <= sp[1]]
            name = (min(inner, key=lambda sp: sp[1] - sp[0])[2]
                    if inner else "between calls")
            gaps[name] += s - end
        end = max(end, e)
    top = [(k[:NAME_CHARS], v) for k, v in
           sorted(ops.items(), key=lambda kv: -kv[1])[:10]]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us / 1e6, "scans": scans, "scan_s": scan_us / 1e6,
            "trace_window_s": (window[1] - window[0]) / 1e6,
            "device_ops": [[k, v / 1e6] for k, v in top],
            "idle_gaps": [[k, v / 1e6] for k, v in top_gaps]}


def profile(call: Callable[[int], None], start: int, units: int,
            points, log) -> Dict:
    """Profile ``units`` calls from index ``start``, halving until the
    trace holds every scan launch the port counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function

    from kbench.lib.spans import spans
    from karpenter_core_tpu_torch.ops import cuda_ffd

    n, last = units, None
    while n >= 1:
        captured: List = []
        torch.cuda.synchronize()
        launches0 = cuda_ffd.counter.total()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            with tprofile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                with spans(points), capture_scans(captured):
                    with record_function(WINDOW):
                        t0 = time.perf_counter()
                        for k in range(n):
                            call(start + k)
                        torch.cuda.synchronize()
                        t1 = time.perf_counter()
            prof.export_chrome_trace(path)
            out = _read(path)
        counted = cuda_ffd.counter.total() - launches0
        out.update(units=n, counted=counted, window_s=t1 - t0)
        log(f"trace: {n} calls, {out['scans']} {SCAN_KERNEL} in the trace,"
            f" {counted} counted by the port, device busy {out['busy_s']!r}"
            f" s of a {out['window_s']!r}-s window")
        if out["scans"] == counted and counted > 0:
            out.update(_bounds(captured))
            out["complete"] = True
            return out
        last = out
        n //= 2
    last["complete"] = False
    return last
