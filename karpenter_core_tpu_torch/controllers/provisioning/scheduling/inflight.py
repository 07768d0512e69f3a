"""In-flight scheduling entities: the hypothesized new node (NodeClaim) and
the simulation wrapper for existing nodes
(reference: scheduling/nodeclaim.go:35-148, existingnode.go:31-128)."""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.objects import Pod, Taint
from karpenter_core_tpu_torch.cloudprovider.types import InstanceType
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.hostports import (
    HostPortUsage,
)
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.nodeclaimtemplate import (
    NodeClaimTemplate,
    filter_instance_types,
)
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (
    Topology,
    TopologyError,
)
from karpenter_core_tpu_torch.scheduling import Requirement, Requirements, Taints
from karpenter_core_tpu_torch.scheduling.requirements import (
    ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
    has_preferred_node_affinity,
)
from karpenter_core_tpu_torch.utils import resources as resutil

_hostname_counter = itertools.count(1)


class IncompatibleError(Exception):
    pass


_MAX_ALLOC_MEMO: dict = {}


def _max_allocatable(instance_types: List[InstanceType]) -> dict:
    """Elementwise max allocatable across options — the roomiest any single
    node from this set could be. Memoized on the option identity tuple;
    the memo value keeps a strong reference to the option objects so their
    ids can't be recycled while the entry lives (bounded, then cleared)."""
    key = tuple(id(it) for it in instance_types)
    hit = _MAX_ALLOC_MEMO.get(key)
    if hit is not None:
        return hit[1]
    out: dict = {}
    for it in instance_types:
        for name, qty in it.allocatable().items():
            if qty > out.get(name, 0.0):
                out[name] = qty
    if len(_MAX_ALLOC_MEMO) > 4096:
        _MAX_ALLOC_MEMO.clear()
    _MAX_ALLOC_MEMO[key] = (tuple(instance_types), out)
    return out


class InFlightNodeClaim:
    """A node being hypothesized during the solve (nodeclaim.go:35-64)."""

    def __init__(
        self,
        template: NodeClaimTemplate,
        topology: Topology,
        daemon_resources: dict,
        instance_types: List[InstanceType],
    ):
        self.template = template
        self.hostname = f"hostname-placeholder-{next(_hostname_counter):04d}"
        topology.register(apilabels.LABEL_HOSTNAME, self.hostname)
        self.requirements = template.requirements.copy()
        self.requirements.add(
            Requirement.new(apilabels.LABEL_HOSTNAME, "In", [self.hostname])
        )
        self.instance_type_options = list(instance_types)
        self.daemon_resources = dict(daemon_resources)
        self.requests = dict(daemon_resources)
        self.pods: List[Pod] = []
        self.topology = topology
        self.host_port_usage = HostPortUsage()
        self._max_alloc_cache: Optional[dict] = None

    def add(self, pod: Pod, pod_requests: dict) -> None:
        """Raises IncompatibleError when the pod cannot join (nodeclaim.go:67-122)."""
        errs = Taints(self.template.taints).tolerates(pod)
        if errs:
            raise IncompatibleError("; ".join(errs))

        conflict = self.host_port_usage.conflicts(pod, pod.host_ports)
        if conflict:
            raise IncompatibleError(conflict)

        # cheap reject before any requirement copying: if the cumulative
        # requests exceed even the roomiest remaining option, no instance
        # type can fit (dominates when a fallback pod scans many claims)
        requests = resutil.merge(self.requests, pod_requests)
        if not resutil.fits(requests, self._max_alloc()):
            raise IncompatibleError("no instance type has enough resources")

        claim_requirements = self.requirements.copy()
        pod_requirements = Requirements.from_pod(pod)
        errs = claim_requirements.compatible(
            pod_requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
        )
        if errs:
            raise IncompatibleError(f"incompatible requirements, {errs}")
        claim_requirements.add(*pod_requirements.values())

        strict = (
            Requirements.from_pod_strict(pod)
            if has_preferred_node_affinity(pod)
            else pod_requirements
        )
        try:
            topology_requirements = self.topology.add_requirements(
                strict, claim_requirements, pod, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
            )
        except TopologyError as e:
            raise IncompatibleError(str(e))
        errs = claim_requirements.compatible(
            topology_requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
        )
        if errs:
            raise IncompatibleError(f"incompatible topology, {errs}")
        claim_requirements.add(*topology_requirements.values())
        filtered = filter_instance_types(
            self.instance_type_options, claim_requirements, requests
        )
        if not filtered.remaining:
            total = resutil.merge(self.daemon_resources, pod_requests)
            raise IncompatibleError(
                f"no instance type satisfied resources {resutil.to_string(total)} "
                f"and requirements ({filtered.failure_reason()})"
            )

        self.pods.append(pod)
        if len(filtered.remaining) != len(self.instance_type_options):
            self._max_alloc_cache = None
        self.instance_type_options = filtered.remaining
        self.requests = requests
        self.requirements = claim_requirements
        self.topology.record(pod, claim_requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS)
        self.host_port_usage.add(pod, pod.host_ports)

    def _max_alloc(self) -> dict:
        if self._max_alloc_cache is None:
            self._max_alloc_cache = _max_allocatable(self.instance_type_options)
        return self._max_alloc_cache

    def add_group(self, pods: List[Pod], per_pod_requests: dict) -> None:
        """Batch-add k IDENTICAL pods in one pass of the host algebra.

        Equivalent to k sequential add() calls when (a) the pods share one
        spec (same requirements/tolerations/requests — a solver equivalence
        class), (b) no topology groups are active, and (c) no host ports:
        the requirement intersection is idempotent after the first add and
        resource narrowing is monotone, so one filter at the cumulative
        requests equals the k-th sequential filter. The decode path guards
        those preconditions and falls back to per-pod adds otherwise."""
        pod = pods[0]
        errs = Taints(self.template.taints).tolerates(pod)
        if errs:
            raise IncompatibleError("; ".join(errs))

        claim_requirements = self.requirements.copy()
        pod_requirements = Requirements.from_pod(pod)
        errs = claim_requirements.compatible(
            pod_requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
        )
        if errs:
            raise IncompatibleError(f"incompatible requirements, {errs}")
        claim_requirements.add(*pod_requirements.values())

        requests = resutil.merge_repeated(
            self.requests, per_pod_requests, len(pods)
        )
        if not resutil.fits(requests, self._max_alloc()):
            raise IncompatibleError("no instance type has enough resources")
        filtered = filter_instance_types(
            self.instance_type_options, claim_requirements, requests
        )
        if not filtered.remaining:
            total = resutil.merge(self.daemon_resources, per_pod_requests)
            raise IncompatibleError(
                f"no instance type satisfied resources {resutil.to_string(total)}"
                f" x{len(pods)} and requirements ({filtered.failure_reason()})"
            )

        self.pods.extend(pods)
        if len(filtered.remaining) != len(self.instance_type_options):
            self._max_alloc_cache = None
        self.instance_type_options = filtered.remaining
        self.requests = requests
        self.requirements = claim_requirements

    def destroy(self) -> None:
        self.topology.unregister(apilabels.LABEL_HOSTNAME, self.hostname)

    def finalize_scheduling(self) -> None:
        """Remove the placeholder hostname before launch (nodeclaim.go:139-148)."""
        self.requirements.pop(apilabels.LABEL_HOSTNAME, None)


@dataclass(frozen=True)
class EvictablePod:
    """One bound pod a preemptive solve may evict (gangsched, ISSUE 10).

    A capacity view, not an API object: uid names the victim for the
    eviction claim, requests is the capacity its eviction frees, priority
    feeds the tier-legality rule (only strictly-lower tiers are evictable,
    utils/disruption.priority_tier), and cost is the victim-selection
    ordering (utils/disruption.eviction_cost, computed by whoever builds
    the SimNode — the kernel and the host fallback both sort by it)."""

    uid: str
    priority: int
    requests: dict
    cost: float


@dataclass
class SimNode:
    """Minimal view of an existing/in-flight real node for simulation; the
    cluster-state layer constructs these from StateNodes."""

    name: str
    labels: dict
    taints: List[Taint]
    available: dict  # allocatable minus bound pods (statenode.go:329-366)
    capacity: dict = field(default_factory=dict)
    daemon_requests: dict = field(default_factory=dict)
    initialized: bool = True
    nodeclaim_name: str = ""
    nodepool_name: str = ""
    # CSI attach-limit state (volumeusage.go): filled by the provisioner
    # from the node's CSINode + bound pods; None = no volume tracking
    volume_usage: Optional[object] = None
    # bound pods a priority-preemptive solve may treat as evictable
    # capacity (ops/gangsched.preempt_pass); empty = nothing evictable,
    # which is also the pre-gangsched wire default
    evictable: tuple = ()


class ExistingNodeSim:
    """Existing-node wrapper with daemon overhead floored at zero
    (existingnode.go:42-128)."""

    def __init__(self, node: SimNode, topology: Topology, daemon_resources: dict):
        remaining = resutil.subtract(daemon_resources, node.daemon_requests)
        for k in list(remaining):
            if remaining[k] < 0:
                remaining[k] = 0.0
        self.node = node
        self.cached_available = dict(node.available)
        self.cached_taints = list(node.taints)
        self.pods: List[Pod] = []
        self.topology = topology
        self.requests = remaining
        self.requirements = Requirements.from_labels(node.labels)
        self.requirements.add(
            Requirement.new(apilabels.LABEL_HOSTNAME, "In", [node.name])
        )
        topology.register(apilabels.LABEL_HOSTNAME, node.name)
        self.host_port_usage = HostPortUsage()
        # per-sim copy: hypothesized placements must not leak into the
        # node's baseline usage across solves/relaxation rounds
        self.volume_usage = (
            node.volume_usage.copy() if node.volume_usage is not None else None
        )

    @property
    def name(self) -> str:
        return self.node.name

    def add(self, pod: Pod, pod_requests: dict) -> None:
        errs = Taints(self.cached_taints).tolerates(pod)
        if errs:
            raise IncompatibleError("; ".join(errs))

        conflict = self.host_port_usage.conflicts(pod, pod.host_ports)
        if conflict:
            raise IncompatibleError(conflict)

        err = self._volume_limit_error([pod])
        if err:
            raise IncompatibleError(err)

        requests = resutil.merge(self.requests, pod_requests)
        if not resutil.fits(requests, self.cached_available):
            raise IncompatibleError("exceeds node resources")

        node_requirements = self.requirements.copy()
        pod_requirements = Requirements.from_pod(pod)
        errs = node_requirements.compatible(pod_requirements)
        if errs:
            raise IncompatibleError(f"incompatible requirements, {errs}")
        node_requirements.add(*pod_requirements.values())

        strict = (
            Requirements.from_pod_strict(pod)
            if has_preferred_node_affinity(pod)
            else pod_requirements
        )
        try:
            topology_requirements = self.topology.add_requirements(
                strict, node_requirements, pod
            )
        except TopologyError as e:
            raise IncompatibleError(str(e))
        errs = node_requirements.compatible(topology_requirements)
        if errs:
            raise IncompatibleError(f"incompatible topology, {errs}")
        node_requirements.add(*topology_requirements.values())

        self.pods.append(pod)
        self.requests = requests
        self.requirements = node_requirements
        self.topology.record(pod, node_requirements)
        self.host_port_usage.add(pod, pod.host_ports)
        self._record_volumes([pod])

    def add_group(self, pods: List[Pod], per_pod_requests: dict) -> None:
        """Batch-add k identical pods; same preconditions as
        InFlightNodeClaim.add_group."""
        pod = pods[0]
        errs = Taints(self.cached_taints).tolerates(pod)
        if errs:
            raise IncompatibleError("; ".join(errs))

        err = self._volume_limit_error(pods)
        if err:
            raise IncompatibleError(err)

        requests = resutil.merge_repeated(
            self.requests, per_pod_requests, len(pods)
        )
        if not resutil.fits(requests, self.cached_available):
            raise IncompatibleError("exceeds node resources")

        node_requirements = self.requirements.copy()
        pod_requirements = Requirements.from_pod(pod)
        errs = node_requirements.compatible(pod_requirements)
        if errs:
            raise IncompatibleError(f"incompatible requirements, {errs}")
        node_requirements.add(*pod_requirements.values())

        self.pods.extend(pods)
        self.requests = requests
        self.requirements = node_requirements
        self._record_volumes(pods)

    # -- CSI attach limits (existingnode.go:84-90; new claims have no
    # CSINode yet so only existing nodes enforce them) --------------------

    def _pods_volumes(self, pods: List[Pod]) -> Optional[dict]:
        from karpenter_core_tpu_torch.scheduling import volumeusage as vu

        joined: dict = {}
        for p in pods:
            if p.resolved_volumes:
                joined = vu.union(joined, p.resolved_volumes)
        return joined or None

    def _volume_limit_error(self, pods: List[Pod]) -> Optional[str]:
        if self.volume_usage is None:
            return None
        vols = self._pods_volumes(pods)
        if vols is None:
            return None
        return self.volume_usage.exceeds_limits(vols)

    def _record_volumes(self, pods: List[Pod]) -> None:
        if self.volume_usage is None:
            return
        vols = self._pods_volumes(pods)
        if vols is not None:
            self.volume_usage.add(vols)
