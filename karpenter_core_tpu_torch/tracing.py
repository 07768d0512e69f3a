"""Spans of the port's own layers, and the device time of its dispatches.

``span(name, request)`` times one region with one ``perf_counter`` pair and,
on exit, appends a :class:`Span` to :data:`LOG`, a bounded in-memory log
holding the newest :data:`CAPACITY` records. A span may add its duration
to a stats key and observe a registry histogram, from the same two
timestamps, so a phase total, its histogram and its span cover one
interval.

Every ``DeviceScheduler.solve`` and every ``frontier_core`` call takes one
request id (:func:`new_request`); each span of that call carries it. A
span's parent is the innermost open span of the same request on its
thread, so the spans of several solves interleaved on one thread
(``solve_batch`` drives their generators in turns) still nest by request.
A span given no request takes its parent's, and a span serving several
requests (a batched dispatch) names all of them and has no parent.

While a torch profiler is running (``torch.autograd.profiler.
_is_profiler_enabled``, a module flag read without a dispatcher call) a
span also enters ``torch.profiler.record_function("karpenter.<name>")``,
so its range lands in the profiler's chrome trace beside the kernels, on
the trace's clock. With the profiler off a span costs two clock reads, a
push and a pop on its thread's stack and one append to the log.

:class:`DeviceTimer` records a CUDA event pair around a dispatch's device
work and files it under each request its span serves. :func:`settle`
reads a request's timers once, when the request is done and its last
host read has waited for all of its work, never by a synchronisation of
its own; each timer's seconds go into its span as ``counts["device_s"]``.
On CPU tensors there is no timer and no ``device_s``.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, Optional, Tuple, Union

import torch
from torch.autograd import profiler as _autograd_profiler

# the newest records the log holds
CAPACITY = 1 << 16
# the profiler range of span "decode" is "karpenter.decode"
PREFIX = "karpenter."

Request = Union[None, int, Tuple[int, ...]]


class Span:
    """One timed region: ``name``, the ``requests`` it served, its
    ``parent`` span (None at a root), ``start`` and ``end`` on the
    ``perf_counter`` clock, and ``counts`` (None, or numbers by name)."""

    __slots__ = ("name", "requests", "parent", "start", "end", "counts")

    def __init__(self, name: str, requests: Tuple[int, ...], parent):
        self.name = name
        self.requests = requests
        self.parent = parent
        self.start = 0.0
        self.end = None
        self.counts: Optional[Dict[str, float]] = None

    @property
    def request(self) -> Optional[int]:
        """The one request this span served (None if it served several
        or none)."""
        return self.requests[0] if len(self.requests) == 1 else None

    @property
    def dt(self) -> float:
        return self.end - self.start

    def count(self, key: str, value: float) -> None:
        """Add ``value`` to count ``key``."""
        if self.counts is None:
            self.counts = {}
        self.counts[key] = self.counts.get(key, 0) + value


LOG: "collections.deque[Span]" = collections.deque(maxlen=CAPACITY)
_requests = itertools.count(1)
_local = threading.local()
# request id -> the timers of its dispatches, until the request settles
_pending: Dict[int, list] = {}


def new_request() -> int:
    """A fresh request id (process-wide, increasing)."""
    return next(_requests)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class span:
    """Context manager over one region; ``with span(...) as s`` gives the
    :class:`Span`, whose ``counts`` the region may fill.

    ``request``: an id, a tuple of ids (a region serving several
    requests), or None (the parent's). ``stats``/``key``: the duration is
    added to ``stats[key]``; ``histogram``: it is observed there. The
    record is logged, and the stats and histogram fed, also when the
    region raises."""

    __slots__ = ("_rec", "_stats", "_key", "_hist", "_range", "_stack")

    def __init__(self, name: str, request: Request = None, *,
                 stats: Optional[dict] = None, key: Optional[str] = None,
                 histogram=None):
        stack = _stack()
        if request is None:
            parent = stack[-1] if stack else None
            requests = parent.requests if parent is not None else ()
        else:
            requests = (request,) if isinstance(request, int) else tuple(
                request)
            parent = None
            if len(requests) == 1:
                rid = requests[0]
                for s in reversed(stack):
                    if rid in s.requests:
                        parent = s
                        break
        self._rec = Span(name, requests, parent)
        self._stack = stack
        self._stats, self._key, self._hist = stats, key, histogram
        self._range = None

    def __enter__(self) -> Span:
        self._stack.append(self._rec)
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(
                PREFIX + self._rec.name)
            self._range.__enter__()
        self._rec.start = time.perf_counter()
        return self._rec

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = time.perf_counter()
        rec = self._rec
        rec.end = end
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        stack = self._stack
        if stack and stack[-1] is rec:
            stack.pop()
        else:  # a generator's span closed out of turn
            try:
                stack.remove(rec)
            except ValueError:
                pass
        LOG.append(rec)
        dt = end - rec.start
        if self._stats is not None:
            self._stats[self._key] = self._stats.get(self._key, 0.0) + dt
        if self._hist is not None:
            self._hist.observe(dt)
        return False


class DeviceTimer:
    """A CUDA event pair around one dispatch's device work, on the current
    stream of ``device``; the ``members`` requests its span serves share
    it equally."""

    __slots__ = ("device", "start", "end", "span", "members")

    def __init__(self, device: torch.device, span_: Span, members: int = 1):
        self.device = device
        self.span = span_
        self.members = members
        self.end = None
        self.start = self._event()
        for rid in span_.requests:
            _pending.setdefault(rid, []).append(self)

    @classmethod
    def begin(cls, device: torch.device, span_: Span,
              members: int = 1) -> Optional["DeviceTimer"]:
        """A started timer, or None for a device without events (the
        CPU) or a span that serves no request."""
        if device.type != "cuda" or not span_.requests:
            return None
        return cls(device, span_, members)

    def _event(self):
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def stop(self) -> "DeviceTimer":
        self.end = self._event()
        return self

    def seconds(self) -> Optional[float]:
        """The pair's device seconds, written into the span as
        ``device_s``; the events are only queried, never waited on (None
        if the end has not been reached)."""
        if self.end is None or not self.end.query():
            return None
        s = self.start.elapsed_time(self.end) / 1e3
        if self.span.counts is None:
            self.span.counts = {}
        self.span.counts["device_s"] = s
        return s


def settle(request: int) -> Optional[float]:
    """The device seconds of ``request``'s dispatches (a shared timer's
    share), None if it had no timer. Call once, when the request is done:
    after a host read that waited for its work."""
    timers = _pending.pop(request, None)
    if not timers:
        return None
    total = 0.0
    for timer in timers:
        s = timer.seconds()
        if s is not None:
            total += s / timer.members
    return total
