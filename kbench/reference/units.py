"""Integer resource units and the catalog's figures, for the reference.

cpu counts in milli-cpu, memory in MiB, pods in pods, ephemeral storage in
GiB. A request rounds up to its unit and a capacity down, so a fit in
units is never looser than the fit in bytes.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

RESOURCES = ("cpu", "memory", "pods", "ephemeral-storage")
UNIT = {"cpu": 1e-3, "memory": 2.0**20, "pods": 1.0,
        "ephemeral-storage": 2.0**30}


def q_request(value: float, r: str) -> int:
    return int(math.ceil(value / UNIT[r] * (1.0 - 1e-12) - 1e-9))


def q_capacity(value: float, r: str) -> int:
    return int(math.floor(value / UNIT[r] * (1.0 + 1e-12) + 1e-9))


def request_vector(pod: Dict) -> np.ndarray:
    """One pod's requests in units; every pod takes one of ``pods``."""
    return np.array([q_request(pod.get("cpu", 0.0), "cpu"),
                     q_request(pod.get("memory", 0.0), "memory"), 1, 0],
                    dtype=np.int64)


def capacity_vector(res: Dict) -> np.ndarray:
    return np.array([q_capacity(res.get(r, 0.0), r) for r in RESOURCES],
                    dtype=np.int64)


def type_allocatable(catalog: List[Dict]) -> np.ndarray:
    """[T, R] allocatable of every type in units: capacity less overhead."""
    out = []
    for t in catalog:
        alloc = {r: t.get(r, 0.0) for r in RESOURCES}
        for r, v in t["overhead"].items():
            alloc[r] -= v
        out.append(capacity_vector(alloc))
    return np.stack(out)


def cheapest_price(catalog: List[Dict]) -> np.ndarray:
    """[T] the cheapest offering of each type (every offering available)."""
    return np.array([min(o["price"] for o in t["offerings"])
                     for t in catalog], dtype=np.float64)
