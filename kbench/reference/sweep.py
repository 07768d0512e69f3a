"""Plain reference of the consolidation sweep's verdicts.

For each prefix p of the candidate list (candidates 0..p removed), the
candidates' reschedulable pods are placed again by class-batched
first-fit-decreasing, the placement Karpenter's scheduler simulates for a
topology-free problem:

* pods group into classes of equal requests, taken largest cpu first,
  then largest memory, then first seen;
* a class fills the remaining existing nodes first-fit in node order
  (candidates by disruption cost, then the rest), each node taking as many
  pods as its free capacity holds;
* what is left spreads over the NodeClaims already opened, emptiest first
  (fewest pods; ties to the earlier claim), each claim taking no more than
  the roomiest instance type it may still launch holds;
* what is still left opens ceil(rest / k) new NodeClaims, k the most pods
  of the class any instance type holds, filled k at a time in order;
* a NodeClaim keeps as options only the types that still hold its pods.

A prefix is schedulable when every pod placed and no more NodeClaims
opened than the solver's slots allow; its price bound is the sum over its
new NodeClaims of the cheapest option's cheapest offering. Integer units
throughout (``units.py``), so fits are exact.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from kbench.reference import units

Verdict = Tuple[bool, int, float]


def _classes(candidate_pods: List[List[Dict]], broken: Optional[str]):
    """(requests [C, R] in units, class of each pod in candidate order)."""
    seen: Dict[tuple, int] = {}
    raw, cls_of = [], []
    for pods in candidate_pods:
        row = []
        for pod in pods:
            key = (pod["cpu"], pod["memory"])
            if key not in seen:
                seen[key] = len(raw)
                raw.append(key)
            row.append(seen[key])
        cls_of.append(row)
    order = sorted(range(len(raw)), key=lambda i: (-raw[i][0], -raw[i][1]))
    rank = {c: k for k, c in enumerate(order)}
    req = np.stack([units.request_vector({"cpu": raw[c][0],
                                          "memory": raw[c][1]})
                    for c in order])
    if broken == "memory":  # the control: memory taken as free
        req[:, 1] = 0
    return req, [[rank[c] for c in row] for row in cls_of]


def _fits(free: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Pods of requests ``r`` that each row of ``free`` [..., R] holds."""
    pos = r > 0
    k = np.min(free[..., pos] // r[pos], axis=-1)
    return np.maximum(k, 0)


def _waterfill(count: np.ndarray, cap: np.ndarray, m: int) -> np.ndarray:
    """``m`` pods over claims, emptiest first, each under its cap."""
    adm = cap > 0
    if m <= 0 or not adm.any():
        return np.zeros_like(count)

    def fill_at(level):
        return np.where(adm, np.minimum(np.maximum(level - count, 0), cap), 0)

    lo, hi = 0, int(count[adm].max()) + m
    while lo < hi:  # the highest level whose fill stays within m
        mid = (lo + hi + 1) // 2
        if fill_at(mid).sum() <= m:
            lo = mid
        else:
            hi = mid - 1
    fill = fill_at(lo)
    left = m - int(fill.sum())
    elig = adm & (fill < cap) & (count + fill == lo)
    first = np.cumsum(elig) - elig
    return fill + (elig & (first < left))


def verdicts(state: Dict, catalog: List[Dict], max_slots: int,
             broken: Optional[str] = None) -> List[Verdict]:
    """(schedulable, new NodeClaims, price bound) for every prefix."""
    alloc = units.type_allocatable(catalog)  # [T, R]
    price = units.cheapest_price(catalog)
    nodes = state["nodes"]
    E = len(nodes)
    ex_free0 = np.stack([units.capacity_vector(n["available"])
                         for n in nodes])
    req, cls_of = _classes(state["candidate_pods"], broken)
    C = len(req)
    kstar = np.array([int(_fits(alloc, req[c]).max()) for c in range(C)])
    out = []
    counts = np.zeros(C, dtype=np.int64)
    for p in range(len(cls_of)):
        for c in cls_of[p]:
            counts[c] += 1
        ex_free = ex_free0.copy()
        ex_free[: p + 1] = 0  # removed candidates hold nothing
        used = np.zeros((0, alloc.shape[1]), dtype=np.int64)
        itmask = np.zeros((0, alloc.shape[0]), dtype=bool)
        podcount = np.zeros(0, dtype=np.int64)
        slots = E
        unplaced = 0
        overflow = False
        for c in range(C):
            m = int(counts[c])
            if m == 0:
                continue
            r = req[c]
            k_ex = _fits(ex_free, r)
            before = np.cumsum(k_ex) - k_ex
            take = np.minimum(np.maximum(m - before, 0), k_ex)
            ex_free -= take[:, None] * r
            rem = m - int(take.sum())
            if len(podcount):
                k_raw = _fits(alloc[None, :, :] - used[:, None, :], r)
                cap = np.where(itmask, k_raw, -1).max(axis=1)
                cap = np.where(itmask.any(axis=1), np.maximum(cap, 0), 0)
                t_cl = _waterfill(podcount, cap, rem)
                took = t_cl > 0
                itmask[took] &= k_raw[took] >= t_cl[took, None]
                used += t_cl[:, None] * r
                podcount += t_cl
                rem -= int(t_cl.sum())
            if rem > 0 and kstar[c] >= 1:
                n_new = -(-rem // int(kstar[c]))
                overflow |= slots + n_new > max_slots
                n_open = max(0, min(n_new, max_slots - slots))
                t_new = np.minimum(rem - np.arange(n_open) * kstar[c],
                                   kstar[c])
                k_fresh = _fits(alloc, r)
                itmask = np.concatenate(
                    [itmask, k_fresh[None, :] >= t_new[:, None]])
                used = np.concatenate([used, t_new[:, None] * r])
                podcount = np.concatenate([podcount, t_new])
                rem -= int(t_new.sum())
                slots += n_new
            unplaced += rem
        bound = float(sum(price[row].min() if row.any() else np.inf
                          for row in itmask))
        out.append((unplaced == 0 and not overflow, slots - E, bound))
    return out
