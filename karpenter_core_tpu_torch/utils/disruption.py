"""Disruption cost model (reference: pkg/utils/disruption/disruption.go:37-79).

Also the single home of the PRIORITY TIER ordering: the gangsched kernel
(ops/gangsched.py) packs tiers high→low and treats only strictly-lower
tiers as evictable, the host tiered-greedy fallback (solver/gangs.py)
bands by the same value, and the verifier's preemption-legality check
(solver/verify.py) compares the same value — one function, three readers,
so the orderings can never drift apart.
"""
from __future__ import annotations

from typing import List

from karpenter_core_tpu_torch.api.objects import Pod

POD_DELETION_COST_ANNOTATION = "controller.kubernetes.io/pod-deletion-cost"

# int32 bounds: tiers ride device tensors (ops/gangsched ev_tier planes)
_TIER_MAX = 2**31 - 1
_TIER_MIN = -(2**31 - 1)


def priority_tier(priority) -> int:
    """The canonical scheduling tier of a PriorityClass value: the value
    itself, clamped to int32 (kube PriorityClass values are int32 anyway —
    system-cluster-critical is 2e9). Unset/garbage → tier 0, the k8s
    default priority."""
    try:
        p = int(priority or 0)
    except (TypeError, ValueError):
        return 0
    return max(_TIER_MIN, min(p, _TIER_MAX))


def lifetime_remaining(clock, nodepool, node_claim) -> float:
    """Fraction of node lifetime left in [0,1]; expiring-soon nodes are
    cheaper to disrupt (disruption.go:37-47)."""
    expire = node_claim.spec.expire_after.seconds
    if expire is None or expire <= 0:
        return 1.0
    age = clock.since(node_claim.metadata.creation_timestamp)
    return min(max((expire - age) / expire, 0.0), 1.0)


def eviction_cost(pod: Pod) -> float:
    """Base 1.0 + deletion-cost/2^27 + priority/2^25, clamped to [-10, 10]
    (disruption.go:49-70).

    EACH TERM clamps before the total clamp — deletion to ±1, priority to
    ±8 — so base + both extremes spans [-8, 10] and the total clamp is a
    backstop the interior never touches. The raw reference arithmetic let
    priority/2^25 saturate the documented [-10, 10] contract for any
    PriorityClass ≥ ~3.0e8 (system-cluster-critical is 2e9 → 59.6),
    erasing the deletion-cost ordering among all critical pods; a single
    ±9 priority clamp still parked critical pods at the 10.0 ceiling
    (1 + 9), erasing POSITIVE deletion costs. With per-term bounds both
    orderings stay live across each term's documented scale.
    Tier ORDERING (which pod may evict which) never rides this cost; that
    is priority_tier's job — this cost only ranks eviction victims within
    a legal (strictly-lower) tier."""
    cost = 1.0
    raw = pod.metadata.annotations.get(POD_DELETION_COST_ANNOTATION)
    if raw is not None:
        try:
            term = float(raw) / 2.0**27
            cost += min(max(term, -1.0), 1.0)
        except ValueError:
            pass
    if pod.priority:
        term = float(priority_tier(pod.priority)) / 2.0**25
        cost += min(max(term, -8.0), 8.0)
    return min(max(cost, -10.0), 10.0)


def rescheduling_cost(pods: List[Pod]) -> float:
    return sum(eviction_cost(p) for p in pods)
