"""Spans from the benchmark's own code around the calls into each layer.

In a traced sub-window the harness wraps the program's layer entries in
``torch.profiler.record_function`` ranges, so the device trace can say
what the host was doing in each idle gap. The wrappers go in for the
sub-window only and come out after it; the measured window runs the
program untouched.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Iterable, Tuple


def _wrap(fn, name):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    return inner


@contextlib.contextmanager
def spans(points: Iterable[Tuple[object, str, str]]):
    """``points``: (owner, attribute, span name). Each attribute is
    replaced by a wrapper for the duration and put back after."""
    saved = []
    try:
        for owner, attr, name in points:
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, _wrap(fn, name))
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)
