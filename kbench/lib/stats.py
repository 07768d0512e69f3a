"""Small statistics the per-layer readers share."""
from __future__ import annotations

import math
from typing import List, Optional


def p90(values: List[float]) -> Optional[float]:
    """Nearest-rank 90th percentile, None for no values."""
    if not values:
        return None
    xs = sorted(values)
    return xs[math.ceil(0.9 * len(xs)) - 1]


def tail_line(what: str, values: List[float]) -> str:
    n = len(values)
    beyond = n - math.ceil(0.9 * n)
    return f"{what}: p90 over {n} samples, {beyond} beyond it"
