"""Disruption candidates and commands (reference: pkg/controllers/disruption/
types.go:48-141)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.nodeclaim import COND_CONSOLIDATABLE, COND_DRIFTED
from karpenter_core_tpu_torch.api.objects import Pod
from karpenter_core_tpu_torch.cloudprovider.types import InstanceType, Offering
from karpenter_core_tpu_torch.scheduling import Requirements
from karpenter_core_tpu_torch.utils import disruption as disutil
from karpenter_core_tpu_torch.utils import pod as podutil


class CandidateError(Exception):
    """This node cannot be a disruption candidate (types.go:71-117 gates)."""


@dataclass
class Candidate:
    """A disruptable node with its pricing/cost features (types.go:60-117)."""

    state_node: object  # state.StateNode
    node_claim: object
    nodepool: object
    instance_type: Optional[InstanceType]
    zone: str
    capacity_type: str
    reschedulable_pods: List[Pod]
    disruption_cost: float

    @property
    def name(self) -> str:
        return self.state_node.name

    def price(self) -> float:
        """The candidate's current offering price (consolidation.go
        getCandidatePrices)."""
        if self.instance_type is None:
            return 0.0
        labels = Requirements.from_labels(self.state_node.labels)
        offs = self.instance_type.offerings.available().compatible(labels)
        cheapest: Optional[Offering] = offs.cheapest()
        return cheapest.price if cheapest is not None else 0.0


def new_candidate(
    clock,
    cluster,
    state_node,
    nodepools: dict,
    instance_types_by_pool: dict,
    pdb_limits=None,
) -> Candidate:
    """Construction gates (types.go:71-117): managed, initialized,
    non-deleting, non-nominated, known pool + instance type, disruptable
    pods. Raises CandidateError when any gate fails."""
    claim = state_node.node_claim
    if claim is None or state_node.node is None:
        raise CandidateError("not managed by a NodeClaim")
    if state_node.deleting() or state_node.marked_for_deletion:
        raise CandidateError("already deleting")
    if not state_node.initialized():
        raise CandidateError("not initialized")
    if state_node.nominated(clock.now()):
        raise CandidateError("nominated for pods")
    if (
        state_node.node.metadata.annotations.get(
            apilabels.DO_NOT_DISRUPT_ANNOTATION_KEY
        )
        == "true"
    ):
        raise CandidateError("node has do-not-disrupt annotation")
    pool = nodepools.get(state_node.nodepool_name)
    if pool is None:
        raise CandidateError(f"nodepool {state_node.nodepool_name!r} not found")
    pods = cluster.pods_on_node(state_node.name)
    for p in pods:
        if not podutil.is_disruptable(p):
            raise CandidateError(
                f"pod {p.name} has do-not-disrupt annotation"
            )
    if pdb_limits is not None:
        err = pdb_limits.can_evict_pods(pods)
        if err:
            raise CandidateError(err)
    it_name = state_node.labels.get(apilabels.LABEL_INSTANCE_TYPE, "")
    instance_type = next(
        (
            it
            for it in instance_types_by_pool.get(pool.name, [])
            if it.name == it_name
        ),
        None,
    )
    reschedulable = [p for p in pods if podutil.is_reschedulable(p)]
    cost = disutil.rescheduling_cost(reschedulable) * disutil.lifetime_remaining(
        clock, pool, claim
    )
    return Candidate(
        state_node=state_node,
        node_claim=claim,
        nodepool=pool,
        instance_type=instance_type,
        zone=state_node.labels.get(apilabels.LABEL_TOPOLOGY_ZONE, ""),
        capacity_type=state_node.labels.get(
            apilabels.CAPACITY_TYPE_LABEL_KEY, ""
        ),
        reschedulable_pods=reschedulable,
        disruption_cost=cost,
    )


def is_consolidatable(candidate: Candidate) -> bool:
    return candidate.node_claim.conditions.is_true(COND_CONSOLIDATABLE)


def is_drifted(candidate: Candidate) -> bool:
    return candidate.node_claim.conditions.is_true(COND_DRIFTED)


@dataclass
class Command:
    """candidates to delete + optional replacements (types.go:119-141)."""

    candidates: List[Candidate] = field(default_factory=list)
    replacements: list = field(default_factory=list)  # InFlightNodeClaim
    reason: str = ""

    @property
    def decision(self) -> str:
        if self.candidates and self.replacements:
            return "replace"
        if self.candidates:
            return "delete"
        return "no-op"
