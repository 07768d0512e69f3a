"""The greedy host scheduler — reference-semantics FFD loop
(reference: scheduling/scheduler.go:47-316).

This is both the fallback scheduling path (``--solver=greedy``) and the
parity oracle the TPU solver (models/provisioner.py) is differential-tested
against: identical inputs must produce node-count parity and zero constraint
violations.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_core_tpu_torch.api.nodepool import NodePool
from karpenter_core_tpu_torch.api.objects import Pod
from karpenter_core_tpu_torch.cloudprovider.types import InstanceType
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (
    ExistingNodeSim,
    IncompatibleError,
    InFlightNodeClaim,
    SimNode,
)
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.nodeclaimtemplate import (
    NodeClaimTemplate,
    filter_instance_types,
)
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.preferences import (
    Preferences,
)
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.queue import (
    Queue,
    by_cpu_and_memory_descending,
)
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (
    Topology,
    domain_universe,
)
from karpenter_core_tpu_torch.scheduling import Requirements, Taints
from karpenter_core_tpu_torch.scheduling.requirements import (
    ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
)
from karpenter_core_tpu_torch.utils import resources as resutil


@dataclass
class Results:
    """Solve output (scheduler.go:109-206)."""

    new_node_claims: List[InFlightNodeClaim]
    existing_nodes: List[ExistingNodeSim]
    pod_errors: Dict[str, str]  # pod uid -> error
    # eviction claims (gangsched, ISSUE 10): node name -> bound-pod uids a
    # preemptive solve selected as victims. The placements on that node
    # assume the freed capacity, so the operator drains these BEFORE
    # binding (drain-before-bind); empty for every non-preemptive solve,
    # which is also the byte-parity wire default
    evictions: Dict[str, List[str]] = field(default_factory=dict)

    def all_pods_scheduled(self) -> bool:
        return not self.pod_errors

    def node_count(self) -> int:
        return len(self.new_node_claims)

    def total_price(self) -> float:
        total = 0.0
        for claim in self.new_node_claims:
            cheapest = min(
                (
                    o.price
                    for it in claim.instance_type_options
                    for o in it.offerings.available().compatible(claim.requirements)
                ),
                default=0.0,
            )
            total += cheapest
        return total


class Scheduler:
    def __init__(
        self,
        nodepools: List[NodePool],
        instance_types: Dict[str, List[InstanceType]],
        existing_nodes: Optional[List[SimNode]] = None,
        daemonset_pods: Optional[List[Pod]] = None,
        topology: Optional[Topology] = None,
        unavailable_offerings: "frozenset | set" = frozenset(),
    ):
        # ICE'd offerings (the UnavailableOfferings snapshot) project onto
        # the catalog before anything consults availability: the per-
        # template prefilter, in-flight offering narrowing, and price
        # ordering all see the stockout and pack onto the next-cheapest
        # AVAILABLE offering (cloudprovider/types.py apply_unavailable)
        from karpenter_core_tpu_torch.cloudprovider.types import apply_unavailable

        instance_types = apply_unavailable(instance_types, unavailable_offerings)
        self.unavailable_offerings = frozenset(unavailable_offerings)
        # default topology over the discoverable domain universe
        # (provisioner.go:251-283); the provisioning controller passes a
        # Topology seeded with live cluster pods instead
        self.topology = topology or Topology(
            domains=domain_universe(nodepools, instance_types, existing_nodes or [])
        )
        daemonset_pods = daemonset_pods or []

        tolerate_prefer_no_schedule = any(
            t.effect == "PreferNoSchedule"
            for np in nodepools
            for t in np.spec.template.taints
        )
        self.preferences = Preferences(tolerate_prefer_no_schedule)

        # Pre-filter instance types per template (scheduler.go:63-72);
        # nodepools are iterated in weight order (provisioner.go:215-234).
        self.templates: List[NodeClaimTemplate] = []
        for np in sorted(nodepools, key=lambda n: (-n.spec.weight, n.name)):
            nct = NodeClaimTemplate.from_nodepool(np)
            nct.instance_type_options = filter_instance_types(
                instance_types.get(np.name, []), nct.requirements, {}
            ).remaining
            if nct.instance_type_options:
                self.templates.append(nct)

        # NodePool resource limits minus existing usage (scheduler.go:85-88)
        self.remaining_resources: Dict[str, dict] = {
            np.name: dict(np.spec.limits) for np in nodepools if np.spec.limits
        }

        # daemon overhead per template (scheduler.go:358-364)
        self.daemon_overhead = {
            id(nct): resutil.requests_for_pods(
                *[p for p in daemonset_pods if _daemon_compatible(nct, p)]
            )
            for nct in self.templates
        }

        self.new_node_claims: List[InFlightNodeClaim] = []
        self.existing_nodes: List[ExistingNodeSim] = []
        self.cached_pod_requests: Dict[str, dict] = {}
        self._build_existing(existing_nodes or [], daemonset_pods)

    def _build_existing(self, nodes: List[SimNode], daemonset_pods: List[Pod]):
        """(scheduler.go:318-354)"""
        for node in nodes:
            daemons = node_daemon_pods(node, daemonset_pods)
            self.existing_nodes.append(
                ExistingNodeSim(
                    node, self.topology, resutil.requests_for_pods(*daemons)
                )
            )
            if node.nodepool_name in self.remaining_resources:
                # recompute remaining against live capacity (scheduler.go:336-340)
                self.remaining_resources[node.nodepool_name] = resutil.subtract(
                    self.remaining_resources[node.nodepool_name],
                    node.capacity or node.available,
                )
        # initialized nodes first, then by name (scheduler.go:344-354)
        self.existing_nodes.sort(key=lambda n: (not n.node.initialized, n.name))

    def solve(self, pods: List[Pod]) -> Results:
        """The FFD loop (scheduler.go:208-266)."""
        errors: Dict[str, str] = {}
        self.topology.ensure_inverse_initialized()
        for p in pods:
            self.cached_pod_requests[p.uid] = resutil.requests_for_pods(p)
            # NewTopology registers every solve pod; constraint-free pods
            # build no groups so the call is skipped on the 50k path
            if p.topology_spread_constraints or p.affinity is not None:
                self.topology.update(p)
        q = Queue(pods, self.cached_pod_requests)
        pods_by_uid = {p.uid: p for p in pods}

        while True:
            pod, ok = q.pop()
            if not ok:
                break
            err = self._add(pod)
            if err is None:
                errors.pop(pod.uid, None)
                continue
            errors[pod.uid] = err
            relaxed = self.preferences.relax(pod)
            q.push(pod, relaxed)
            if relaxed:
                self.topology.update(pod)

        for claim in self.new_node_claims:
            claim.finalize_scheduling()
        return Results(
            new_node_claims=self.new_node_claims,
            existing_nodes=self.existing_nodes,
            pod_errors=errors,
        )

    def _add(self, pod: Pod) -> Optional[str]:
        return place_pod(
            pod,
            self.cached_pod_requests[pod.uid],
            self.existing_nodes,
            self.new_node_claims,
            self.templates,
            self.daemon_overhead,
            self.topology,
            self.remaining_resources,
        )


def place_pod(
    pod: Pod,
    pod_requests: dict,
    existing_nodes: List[ExistingNodeSim],
    claims: List[InFlightNodeClaim],
    templates: List[NodeClaimTemplate],
    daemon_overhead: Dict[int, dict],  # id(template) -> resources
    topology: Topology,
    remaining_resources: Dict[str, dict],  # nodepool -> remaining; mutated
) -> Optional[str]:
    """The single-pod placement policy (scheduler.go:268-316): existing real
    nodes, then in-flight claims emptiest first, then a fresh claim from the
    first workable template. Shared by the greedy loop and the device
    solver's host fallback so the order/limit policy cannot diverge."""
    for node in existing_nodes:
        try:
            node.add(pod, pod_requests)
            return None
        except IncompatibleError:
            continue

    claims.sort(key=lambda c: len(c.pods))
    for claim in claims:
        try:
            claim.add(pod, pod_requests)
            return None
        except IncompatibleError:
            continue

    errs = []
    for template in templates:
        instance_types = template.instance_type_options
        remaining = remaining_resources.get(template.nodepool_name)
        if remaining is not None:
            instance_types = _filter_by_remaining_resources(
                instance_types, remaining
            )
            if not instance_types:
                errs.append(
                    f"all available instance types exceed limits for "
                    f"nodepool {template.nodepool_name!r}"
                )
                continue
        claim = InFlightNodeClaim(
            template,
            topology,
            daemon_overhead.get(id(template), {}),
            instance_types,
        )
        try:
            claim.add(pod, pod_requests)
        except IncompatibleError as e:
            claim.destroy()
            errs.append(f"incompatible with nodepool {template.nodepool_name!r}: {e}")
            continue
        claims.append(claim)
        if remaining is not None:
            remaining_resources[template.nodepool_name] = _subtract_max(
                remaining, claim.instance_type_options
            )
        return None
    return "; ".join(errs) or "no nodepool matched pod"


def node_daemon_pods(node: SimNode, daemonset_pods: List[Pod]) -> List[Pod]:
    """Daemonset pods that would land on this node: tolerate its taints and
    match its labels (scheduler.go:320-332)."""
    daemons = []
    for p in daemonset_pods:
        if Taints(node.taints).tolerates(p):
            continue
        if Requirements.from_labels(node.labels).compatible(
            Requirements.from_pod(p)
        ):
            continue
        daemons.append(p)
    return daemons


def _daemon_compatible(template: NodeClaimTemplate, pod: Pod) -> bool:
    """(scheduler.go:366-386) — daemons tolerate PreferNoSchedule, relax
    required node-affinity terms one at a time."""
    import copy

    pod = copy.deepcopy(pod)
    prefs = Preferences()
    prefs._tolerate_prefer_no_schedule_taints(pod)
    if Taints(template.taints).tolerates(pod):
        return False
    while True:
        if template.requirements.is_compatible(
            Requirements.from_pod_strict(pod), ALLOW_UNDEFINED_WELL_KNOWN_LABELS
        ):
            return True
        if prefs._remove_required_node_affinity_term(pod) is None:
            return False


def _filter_by_remaining_resources(instance_types, remaining) -> list:
    """Drop instance types whose capacity would breach NodePool limits
    (scheduler.go:417-434)."""
    out = []
    for it in instance_types:
        if all(
            it.capacity.get(name, 0.0) <= qty for name, qty in remaining.items()
        ):
            out.append(it)
    return out


def _subtract_max(remaining: dict, instance_types) -> dict:
    """Pessimistically subtract the max capacity over the claim's viable
    instance types (scheduler.go:389-409)."""
    if not instance_types:
        return remaining
    max_caps = resutil.cmp_max(*(it.capacity for it in instance_types))
    return {
        name: qty - max_caps.get(name, 0.0) for name, qty in remaining.items()
    }
