"""Resource-list arithmetic (reference: pkg/utils/resources/resources.go).

ResourceLists are plain dict[str, float]; missing keys read as zero, matching
apimachinery Quantity map semantics.
"""
from __future__ import annotations

from typing import Iterable

from karpenter_core_tpu_torch.api.objects import RESOURCE_PODS, Pod


def merge(*lists: dict) -> dict:
    """Sum resource lists (resources.go:50-63)."""
    out: dict = {}
    for rl in lists:
        for name, qty in rl.items():
            out[name] = out.get(name, 0.0) + qty
    return out


def merge_into(dest: dict, src: dict) -> dict:
    """In-place sum (resources.go:68-79)."""
    for name, qty in src.items():
        dest[name] = dest.get(name, 0.0) + qty
    return dest


def subtract(lhs: dict, rhs: dict) -> dict:
    """lhs - rhs over lhs's keys (resources.go:81-93)."""
    out = dict(lhs)
    for name in lhs:
        out[name] = lhs[name] - rhs.get(name, 0.0)
    return out


def requests_for_pods(*pods: Pod) -> dict:
    """Total requests plus the implicit 'pods' count resource
    (resources.go:28-37)."""
    out = merge(*(p.resource_requests for p in pods))
    out[RESOURCE_PODS] = out.get(RESOURCE_PODS, 0.0) + float(len(pods))
    return out


def merge_repeated(dest: dict, src: dict, k: int) -> dict:
    """dest folded with src k times by repeated addition, NOT dest + k*src:
    group-add paths must land on the same float64 sums the sequential
    merge-per-pod path produces, or exact-boundary fits flake between the
    two."""
    out = dict(dest)
    for _ in range(int(k)):
        for name, qty in src.items():
            out[name] = out.get(name, 0.0) + qty
    return out


def fits(candidate: dict, total: dict) -> bool:
    """candidate <= total pointwise; any negative total never fits
    (resources.go:217-231)."""
    if any_negative(total):
        return False
    return all(qty <= total.get(name, 0.0) for name, qty in candidate.items())


def merge_limits_into_requests(container) -> dict:
    """A container's effective requests: explicit requests, with limits
    standing in for any resource that has a limit but no request
    (resources.go:185-197 MergeResourceLimitsIntoRequests)."""
    out = dict(container.resource_requests)
    for name, qty in container.resource_limits.items():
        if name not in container.resource_requests:
            out[name] = qty
    return out


def _pod_aggregate(pod, container_reqs) -> dict:
    """Shared shape of podRequests/podLimits (resources.go:96-162): sum the
    regular containers plus restartable (sidecar) init containers, then max
    against each non-restartable init container's needs stacked on the
    sidecars started before it."""
    from karpenter_core_tpu_torch.api.objects import CONTAINER_RESTART_ALWAYS

    total: dict = {}
    restartable: dict = {}
    max_init: dict = {}
    for c in pod.containers:
        merge_into(total, container_reqs(c))
    for c in pod.init_containers:
        reqs = container_reqs(c)
        if c.restart_policy == CONTAINER_RESTART_ALWAYS:
            merge_into(total, reqs)
            merge_into(restartable, reqs)
            max_init = cmp_max(max_init, restartable)
        else:
            max_init = cmp_max(max_init, merge(reqs, restartable))
    total = cmp_max(total, max_init)
    if pod.overhead:
        merge_into(total, pod.overhead)
    return total


def pod_requests(pod) -> dict:
    """Aggregate pod requests from container specs (resources.go:96-128)."""
    return _pod_aggregate(pod, merge_limits_into_requests)


def pod_limits(pod) -> dict:
    """Aggregate pod limits from container specs (resources.go:131-162).
    Limits do NOT fall back to requests — only explicit limits count."""
    return _pod_aggregate(pod, lambda c: dict(c.resource_limits))


def ceiling(pod) -> tuple:
    """(requests, limits) for the pod (resources.go:164-169 Ceiling)."""
    return pod_requests(pod), pod_limits(pod)


def limits_for_pods(*pods: Pod) -> dict:
    """Total limits plus the implicit 'pods' count resource
    (resources.go:39-47); pods built from container specs carry derived
    limits, flat-request pods count as zero-limit."""
    out = merge(*(p.resource_limits for p in pods))
    out[RESOURCE_PODS] = out.get(RESOURCE_PODS, 0.0) + float(len(pods))
    return out


def cmp_max(*lists: dict) -> dict:
    """Pointwise max (resources.go MaxResources)."""
    out: dict = {}
    for rl in lists:
        for name, qty in rl.items():
            if qty > out.get(name, float("-inf")):
                out[name] = qty
    return out


def any_negative(rl: dict) -> bool:
    return any(q < 0 for q in rl.values())


def is_zero(rl: dict) -> bool:
    return all(q == 0 for q in rl.values())


def to_string(rl: dict) -> str:
    if not rl:
        return "{}"
    return ", ".join(f"{k}={v:g}" for k, v in sorted(rl.items()))
