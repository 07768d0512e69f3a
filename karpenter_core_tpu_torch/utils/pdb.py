"""PodDisruptionBudget limits (reference: pkg/utils/pdb/pdb.go:33-118).

The reference reads ``pdb.Status.DisruptionsAllowed`` maintained by the
kube-controller-manager's disruption controller; this framework has no such
controller, so ``Limits`` computes the same quantity from live pods at
build time: allowed = healthy − desiredHealthy, with desiredHealthy from
minAvailable or maxUnavailable; percentages round up in both cases
(GetScaledValueFromIntOrPercent(..., roundUp=true) in the policy/v1
disruption controller).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from karpenter_core_tpu_torch.api.objects import (
    POD_FAILED,
    POD_RUNNING,
    POD_SUCCEEDED,
    Pod,
    PodDisruptionBudget,
)
from karpenter_core_tpu_torch.utils import pod as podutil


def _resolve(value, expected: int, round_up: bool) -> int:
    if isinstance(value, str) and value.endswith("%"):
        # exact integer arithmetic like intstr.GetScaledValueFromIntOrPercent
        # — float math is off by one for pairs like 14% of 50
        num = int(value[:-1])
        if round_up:
            return -(-num * expected // 100)
        return num * expected // 100
    return int(value)


@dataclass
class _PdbItem:
    key: str
    namespace: str
    selector: object
    disruptions_allowed: int
    can_always_evict_unhealthy: bool


class Limits:
    """Evaluate whether a pod list is evictable (pdb.go:54-89)."""

    def __init__(self, items: List[_PdbItem]):
        self.items = items

    @classmethod
    def from_kube(cls, kube) -> "Limits":
        pods = [
            p
            for p in kube.list_pods()
            if p.phase not in (POD_SUCCEEDED, POD_FAILED)
            and p.metadata.deletion_timestamp is None
        ]
        items = []
        for pdb in kube.list_pdbs():
            if pdb.selector is None:
                continue
            matching = [
                p
                for p in pods
                if p.metadata.namespace == pdb.metadata.namespace
                and pdb.selector.matches(p.metadata.labels)
            ]
            expected = len(matching)
            healthy = sum(1 for p in matching if p.phase == POD_RUNNING)
            if pdb.min_available is not None:
                desired = _resolve(pdb.min_available, expected, round_up=True)
            elif pdb.max_unavailable is not None:
                desired = expected - _resolve(
                    pdb.max_unavailable, expected, round_up=True
                )
            else:
                desired = expected
            items.append(
                _PdbItem(
                    key=pdb.key(),
                    namespace=pdb.metadata.namespace,
                    selector=pdb.selector,
                    disruptions_allowed=max(healthy - desired, 0),
                    can_always_evict_unhealthy=(
                        pdb.unhealthy_pod_eviction_policy == "AlwaysAllow"
                    ),
                )
            )
        return cls(items)

    def blocking_pdb(self, pod: Pod) -> Optional[str]:
        """PDB key that blocks evicting this single pod, if any."""
        if not podutil.is_evictable(pod):
            return None
        for item in self.items:
            if item.namespace != pod.metadata.namespace:
                continue
            if not item.selector.matches(pod.metadata.labels):
                continue
            if item.can_always_evict_unhealthy and pod.phase != POD_RUNNING:
                continue
            if item.disruptions_allowed == 0:
                return item.key
        return None

    def can_evict_pods(self, pods: List[Pod]) -> Optional[str]:
        """Error string naming the first fully-blocking PDB (pdb.go:56-89:
        every pod must be individually evictable; simultaneity is handled
        by the eviction queue's retries). Non-evictable pods (mirror,
        terminal) are skipped inside blocking_pdb, so a PDB matching only
        them does not block (pdb.go:58-62)."""
        for pod in pods:
            key = self.blocking_pdb(pod)
            if key is not None:
                return f"pdb {key} prevents pod evictions"
        return None
