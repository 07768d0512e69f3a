"""Prometheus-style metrics registry (reference: pkg/metrics/{metrics,
constants,store}.go — namespace `karpenter`, duration buckets, Measure()).

Self-contained: metrics accumulate in-process and render in the Prometheus
text exposition format; an HTTP scrape endpoint is a thin wrapper away and
out of scope for the framework core."""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

NAMESPACE = "karpenter"

# pkg/metrics/constants.go DurationBuckets
DURATION_BUCKETS = [
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10,
    20, 30, 45, 60, 120, 180, 300, 450, 600,
]


def _labelkey(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self.values: Dict[tuple, float] = {}

    def inc(self, labels: Optional[Dict[str, str]] = None, by: float = 1.0):
        k = _labelkey(labels or {})
        self.values[k] = self.values.get(k, 0.0) + by

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self.values.get(_labelkey(labels or {}), 0.0)


class Gauge:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self.values: Dict[tuple, float] = {}

    def set(self, value: float, labels: Optional[Dict[str, str]] = None):
        self.values[_labelkey(labels or {})] = value

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        return self.values.get(_labelkey(labels or {}), 0.0)

    def reset(self):
        self.values = {}


class Histogram:
    def __init__(self, name: str, help_: str = "", buckets=None):
        self.name = name
        self.help = help_
        self.buckets = list(buckets or DURATION_BUCKETS)
        self.counts: Dict[tuple, List[int]] = {}
        self.sums: Dict[tuple, float] = {}
        self.totals: Dict[tuple, int] = {}

    def observe(self, value: float, labels: Optional[Dict[str, str]] = None):
        k = _labelkey(labels or {})
        counts = self.counts.setdefault(k, [0] * len(self.buckets))
        for i, b in enumerate(self.buckets):
            if value <= b:
                counts[i] += 1
        self.sums[k] = self.sums.get(k, 0.0) + value
        self.totals[k] = self.totals.get(k, 0) + 1

    def percentile(self, q: float, labels: Optional[Dict[str, str]] = None) -> float:
        """Approximate quantile from bucket counts."""
        k = _labelkey(labels or {})
        total = self.totals.get(k, 0)
        if not total:
            return 0.0
        target = q * total
        for i, b in enumerate(self.buckets):
            if self.counts[k][i] >= target:
                return b
        return float("inf")

    @contextmanager
    def time(self, labels: Optional[Dict[str, str]] = None):
        """metrics.Measure() (constants.go:58-63)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0, labels)


class Registry:
    def __init__(self):
        self.metrics: Dict[str, object] = {}

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_make(name, lambda: Counter(name, help_))

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_make(name, lambda: Gauge(name, help_))

    def histogram(self, name: str, help_: str = "", buckets=None) -> Histogram:
        return self._get_or_make(name, lambda: Histogram(name, help_, buckets))

    def _get_or_make(self, name, factory):
        m = self.metrics.get(name)
        if m is None:
            m = factory()
            self.metrics[name] = m
        return m

    def render(self) -> str:
        """Prometheus text exposition format. Iterates over list() snapshots
        so a scrape from the health server's handler thread survives the
        operator thread registering metrics/series mid-render (single torn
        values are acceptable scrape noise; a 'dict changed size' crash is
        not)."""
        lines = []
        for name, m in sorted(list(self.metrics.items())):
            full = f"{NAMESPACE}_{name}"
            if m.help:
                lines.append(f"# HELP {full} {m.help}")
            if isinstance(m, (Counter, Gauge)):
                kind = "counter" if isinstance(m, Counter) else "gauge"
                lines.append(f"# TYPE {full} {kind}")
                for k, v in sorted(list(m.values.items())):
                    lines.append(f"{full}{_fmt_labels(k)} {v:g}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {full} histogram")
                for k in sorted(list(m.totals)):
                    cum = 0
                    for i, b in enumerate(m.buckets):
                        cum = m.counts[k][i]
                        lines.append(
                            f"{full}_bucket{_fmt_labels(k, le=b)} {cum}"
                        )
                    lines.append(
                        f"{full}_bucket{_fmt_labels(k, le='+Inf')} {m.totals[k]}"
                    )
                    lines.append(f"{full}_sum{_fmt_labels(k)} {m.sums[k]:g}")
                    lines.append(f"{full}_count{_fmt_labels(k)} {m.totals[k]}")
        return "\n".join(lines) + "\n"


def _fmt_labels(key: tuple, le=None) -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if le is not None:
        parts.append(f'le="{le}"')
    return "{" + ",".join(parts) + "}" if parts else ""


REGISTRY = Registry()
