"""Disruption helpers: the scheduling-simulation bridge into L4, candidate
collection, and budget math (reference: pkg/controllers/disruption/
helpers.go:49-245)."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.nodepool import REASON_ALL
from karpenter_core_tpu_torch.controllers.disruption.types import (
    Candidate,
    CandidateError,
    new_candidate,
)
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.scheduler import (
    Results,
)


def simulate_scheduling(
    provisioner,
    cluster,
    candidates: List[Candidate],
) -> Results:
    """Re-enter the full provisioning scheduler with the candidates' nodes
    removed and their pods queued (helpers.go:49-113). The scheduler
    assembly (solver strategy, volume state, topology exclusions) is the
    provisioner's own, so the simulation cannot drift from the real solve."""
    pods = provisioner.pending_pods() + provisioner.deleting_node_pods()
    for c in candidates:
        pods.extend(c.reschedulable_pods)
    pods, volume_errors = provisioner._prepare_volumes(pods)
    scheduler = provisioner.new_scheduler(
        pods, excluded_nodes={c.name for c in candidates}
    )
    results = scheduler.solve(pods)
    results.pod_errors.update(volume_errors)
    return results


def get_candidates(
    clock,
    cluster,
    kube,
    cloud_provider,
    should_disrupt: Callable[[Candidate], bool],
) -> List[Candidate]:
    """(helpers.go:144-161)"""
    from karpenter_core_tpu_torch.utils.pdb import Limits

    nodepools = {np.name: np for np in kube.list_nodepools()}
    instance_types = {
        name: cloud_provider.get_instance_types(np)
        for name, np in nodepools.items()
    }
    pdb_limits = Limits.from_kube(kube)
    out = []
    for sn in cluster.nodes():
        try:
            c = new_candidate(
                clock, cluster, sn, nodepools, instance_types,
                pdb_limits=pdb_limits,
            )
        except CandidateError:
            continue
        if should_disrupt(c):
            out.append(c)
    return out


class BudgetMapping:
    """Allowed disruptions per (nodepool, reason) minus nodes already
    disrupting (helpers.go:197-245)."""

    def __init__(self, allowed: Dict[str, Dict[str, int]]):
        self.allowed = allowed

    def remaining(self, nodepool_name: str, reason: str) -> int:
        pool = self.allowed.get(nodepool_name, {})
        if reason in pool:
            return pool[reason]
        return pool.get(REASON_ALL, 1 << 30)

    def consume(self, nodepool_name: str, reason: str, n: int = 1) -> None:
        pool = self.allowed.setdefault(nodepool_name, {})
        for r in (reason, REASON_ALL):
            if r in pool:
                pool[r] = max(pool[r] - n, 0)


def build_disruption_budget_mapping(clock, cluster, kube) -> BudgetMapping:
    allowed: Dict[str, Dict[str, int]] = {}
    now = clock.now()
    for np in kube.list_nodepools():
        totals = 0
        disrupting = 0
        for sn in cluster.nodes():
            if sn.nodepool_name != np.name:
                continue
            if not sn.initialized():
                continue
            totals += 1
            # draining nodes consume budget until they're gone
            # (helpers.go:197-245 counts MarkedForDeletion)
            if sn.marked_for_deletion or sn.deleting():
                disrupting += 1
        per_reason: Dict[str, int] = {}
        for budget in np.spec.disruption.budgets:
            budget_reasons = budget.reasons or [REASON_ALL]
            cap = budget.allowed_disruptions(totals, now)
            for r in budget_reasons:
                per_reason[r] = min(per_reason.get(r, 1 << 30), cap)
        for r in list(per_reason):
            per_reason[r] = max(per_reason[r] - disrupting, 0)
        allowed[np.name] = per_reason
    return BudgetMapping(allowed)
