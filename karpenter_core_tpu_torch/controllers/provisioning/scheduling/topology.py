"""Topology tracking: spread / pod-affinity / pod-anti-affinity domain counts.

Host-side twin of the reference's Topology machinery
(reference: pkg/controllers/provisioning/scheduling/topology.go:41-321,
topologygroup.go:56-342, topologynodefilter.go:30-80). Each constraint class
becomes a TopologyGroup — "SELECT COUNT(*) FROM pods GROUP BY(topology_key)"
restricted to a namespace set + label selector — and placement tightens a
pod's requirements to the next admissible domain:

* spread: domains where count (+1 if self-selecting) - min <= maxSkew;
* affinity: domains that already hold a selected pod (or any domain, to
  bootstrap a self-selecting group);
* anti-affinity: domains that hold none (tracked via emptyDomains);
* inverse anti-affinity: OTHER pods' anti-affinity terms, so a new pod whose
  labels match an existing term's selector avoids that pod's domains.

Device-side note: these groups lower to the kernel's count tensors
(ops/topoplan.py — zone count vectors, per-slot hostname counts, skew
rules in ops/ffd.py); the host algebra here is the parity oracle and the
fallback for shapes the planner rules device-ineligible.

Deliberate ordering deviation from the reference: ``register`` also inserts
the domain into the universe (`self.domains`), so groups created after an
in-flight claim or existing node registered its hostname still see it; the
reference achieves the same only through construction ordering.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.objects import (
    POD_FAILED,
    POD_SUCCEEDED,
    LabelSelector,
    Pod,
)
from karpenter_core_tpu_torch.scheduling import Requirements
from karpenter_core_tpu_torch.scheduling.requirement import (
    OP_DOES_NOT_EXIST,
    OP_EXISTS,
    OP_IN,
    Requirement,
)

MAX_SKEW_UNBOUNDED = 1 << 31  # affinity groups never constrain skew

TYPE_SPREAD = "topology spread"
TYPE_AFFINITY = "pod affinity"
TYPE_ANTI_AFFINITY = "pod anti-affinity"


class TopologyError(Exception):
    """A topology constraint admits no domain on this node
    (topology.go topologyError:88-99)."""


def ignored_for_topology(pod: Pod) -> bool:
    """Unscheduled / terminal / terminating pods don't count
    (topology.go IgnoredForTopology:418-420)."""
    return (
        not pod.node_name
        or pod.phase in (POD_SUCCEEDED, POD_FAILED)
        or pod.metadata.deletion_timestamp is not None
    )


def has_pod_anti_affinity(pod: Pod) -> bool:
    return bool(
        pod.affinity
        and pod.affinity.pod_anti_affinity
        and (
            pod.affinity.pod_anti_affinity.required
            or pod.affinity.pod_anti_affinity.preferred
        )
    )


def has_required_pod_anti_affinity(pod: Pod) -> bool:
    return bool(
        pod.affinity
        and pod.affinity.pod_anti_affinity
        and pod.affinity.pod_anti_affinity.required
    )


def has_topology_constraints(pod: Pod) -> bool:
    """Pods with any topology-coupled constraint take the host scheduling
    path; the device FFD batches the dominant constraint shapes and falls
    back here for the exotic rest (ops/topoplan.py eligibility)."""
    return bool(
        pod.topology_spread_constraints
        or (
            pod.affinity
            and (pod.affinity.pod_affinity or pod.affinity.pod_anti_affinity)
        )
    )


class TopologyNodeFilter:
    """OR-of-Requirements deciding which nodes count for a spread
    (topologynodefilter.go:30-80). Empty filter matches everything."""

    def __init__(self, alternatives: Optional[List[Requirements]] = None):
        self.alternatives = alternatives or []

    @classmethod
    def for_pod(cls, pod: Pod) -> "TopologyNodeFilter":
        selector_reqs = Requirements.from_labels(pod.node_selector)
        affinity = pod.affinity.node_affinity if pod.affinity else None
        if affinity is None or not affinity.required:
            return cls([selector_reqs])
        alternatives = []
        for term in affinity.required:
            reqs = Requirements()
            reqs.add(*selector_reqs.copy().values())
            reqs.add(
                *Requirements.from_node_selector_requirements(
                    term.match_expressions
                ).values()
            )
            alternatives.append(reqs)
        return cls(alternatives)

    def matches_labels(self, labels: dict) -> bool:
        return self.matches_requirements(Requirements.from_labels(labels))

    def matches_requirements(
        self, requirements: Requirements, allow_undefined: frozenset = frozenset()
    ) -> bool:
        if not self.alternatives:
            return True
        return any(
            requirements.is_compatible(alt, allow_undefined)
            for alt in self.alternatives
        )

    def signature(self) -> tuple:
        return tuple(
            tuple(sorted((k, hash(r)) for k, r in alt.items()))
            for alt in self.alternatives
        )


class TopologyGroup:
    """Domain counters for one constraint shape (topologygroup.go:56-99).
    Identical shapes across pods share one group keyed by signature()."""

    def __init__(
        self,
        group_type: str,
        key: str,
        pod: Optional[Pod],
        namespaces: Set[str],
        selector: Optional[LabelSelector],
        max_skew: int,
        min_domains: Optional[int],
        domains: Iterable[str],
    ):
        self.type = group_type
        self.key = key
        self.max_skew = max_skew
        self.min_domains = min_domains
        self.namespaces = frozenset(namespaces)
        self.selector = selector
        # only spread constraints filter which nodes participate
        self.node_filter = (
            TopologyNodeFilter.for_pod(pod)
            if group_type == TYPE_SPREAD and pod is not None
            else TopologyNodeFilter()
        )
        self.owners: Set[str] = set()
        self.domains: Dict[str, int] = {d: 0 for d in domains}
        self.empty_domains: Set[str] = set(self.domains)

    # -- identity ----------------------------------------------------------

    def signature(self) -> tuple:
        """Dedup key: one group tracks many owner pods with the same shape
        (topologygroup.go Hash:159-175; minDomains deliberately excluded,
        matching the reference)."""
        return (
            self.type,
            self.key,
            self.namespaces,
            self.selector,
            self.max_skew,
            self.node_filter.signature(),
        )

    # -- counting ----------------------------------------------------------

    def record(self, *domains: str) -> None:
        for d in domains:
            self.domains[d] = self.domains.get(d, 0) + 1
            self.empty_domains.discard(d)

    def register(self, *domains: str) -> None:
        for d in domains:
            if d not in self.domains:
                self.domains[d] = 0
                self.empty_domains.add(d)

    def unregister(self, *domains: str) -> None:
        for d in domains:
            self.domains.pop(d, None)
            self.empty_domains.discard(d)

    def selects(self, pod: Pod) -> bool:
        """Namespace + label-selector match; a None selector selects nothing
        (LabelSelectorAsSelector(nil) == Nothing)."""
        return (
            pod.metadata.namespace in self.namespaces
            and self.selector is not None
            and self.selector.matches(pod.metadata.labels)
        )

    def counts(
        self,
        pod: Pod,
        requirements: Requirements,
        allow_undefined: frozenset = frozenset(),
    ) -> bool:
        """Would this pod count for the group if it lands on a node with the
        given requirements (topologygroup.go:121-124)."""
        return self.selects(pod) and self.node_filter.matches_requirements(
            requirements, allow_undefined
        )

    # -- owners ------------------------------------------------------------

    def add_owner(self, uid: str) -> None:
        self.owners.add(uid)

    def remove_owner(self, uid: str) -> None:
        self.owners.discard(uid)

    def is_owned_by(self, uid: str) -> bool:
        return uid in self.owners

    # -- next-domain selection --------------------------------------------

    def get(
        self, pod: Pod, pod_domains: Requirement, node_domains: Requirement
    ) -> Requirement:
        if self.type == TYPE_SPREAD:
            return self._next_domain_spread(pod, pod_domains, node_domains)
        if self.type == TYPE_AFFINITY:
            return self._next_domain_affinity(pod, pod_domains, node_domains)
        return self._next_domain_anti_affinity(pod_domains, node_domains)

    def _candidate_domains(self, node_domains: Requirement) -> Iterable[str]:
        """Iterate the smaller side when the node pins explicit values
        (topologygroup.go:195-230)."""
        if node_domains.operator() == OP_IN:
            return [d for d in node_domains.sorted_values() if d in self.domains]
        return [d for d in sorted(self.domains) if node_domains.has(d)]

    def _next_domain_spread(
        self, pod: Pod, pod_domains: Requirement, node_domains: Requirement
    ) -> Requirement:
        """'existing matching num' + 'if self-match' - 'global min' <= maxSkew
        (topologygroup.go:181-227)."""
        min_count = self._domain_min_count(pod_domains)
        self_selecting = self.selects(pod)
        best_domain = None
        best_count = None
        for domain in self._candidate_domains(node_domains):
            count = self.domains[domain]
            if self_selecting:
                count += 1
            if count - min_count <= self.max_skew and (
                best_count is None or count < best_count
            ):
                best_domain = domain
                best_count = count
        if best_domain is None:
            return Requirement.new(pod_domains.key, OP_DOES_NOT_EXIST)
        return Requirement.new(pod_domains.key, OP_IN, [best_domain])

    def _domain_min_count(self, pod_domains: Requirement) -> int:
        """Min count across pod-admissible domains; hostname topologies float
        at zero since a new node is always creatable; minDomains forces zero
        while under-provisioned (topologygroup.go:229-249)."""
        if self.key == apilabels.LABEL_HOSTNAME:
            return 0
        min_count = None
        supported = 0
        for domain, count in self.domains.items():
            if pod_domains.has(domain):
                supported += 1
                if min_count is None or count < min_count:
                    min_count = count
        if self.min_domains is not None and supported < self.min_domains:
            return 0
        return min_count if min_count is not None else (1 << 31)

    def _next_domain_affinity(
        self, pod: Pod, pod_domains: Requirement, node_domains: Requirement
    ) -> Requirement:
        """(topologygroup.go:253-300)"""
        options = Requirement.new(pod_domains.key, OP_DOES_NOT_EXIST)
        for domain in self._candidate_domains(node_domains):
            if pod_domains.has(domain) and self.domains[domain] > 0:
                options.values.add(domain)
        if options.values:
            return options

        # Bootstrap: self-selecting pod and nothing placed yet (or placed
        # only in pod-incompatible domains) may pick a domain, preferring the
        # pod∩node intersection (keeps in-flight nodes' own domains).
        if self.selects(pod) and (
            len(self.domains) == len(self.empty_domains)
            or not self._any_compatible_pod_domain(pod_domains)
        ):
            intersected = pod_domains.intersection(node_domains)
            for domain in sorted(self.domains):
                if intersected.has(domain):
                    options.values.add(domain)
                    break
            for domain in sorted(self.domains):
                if pod_domains.has(domain):
                    options.values.add(domain)
                    break
        return options

    def _any_compatible_pod_domain(self, pod_domains: Requirement) -> bool:
        return any(
            pod_domains.has(domain) and count > 0
            for domain, count in self.domains.items()
        )

    def _next_domain_anti_affinity(
        self, pod_domains: Requirement, node_domains: Requirement
    ) -> Requirement:
        """Only empty domains admit the pod (topologygroup.go:316-342)."""
        options = Requirement.new(pod_domains.key, OP_DOES_NOT_EXIST)
        if node_domains.operator() == OP_IN and node_domains.length() < len(
            self.empty_domains
        ):
            for domain in node_domains.sorted_values():
                if domain in self.empty_domains and pod_domains.has(domain):
                    options.values.add(domain)
        else:
            for domain in sorted(self.empty_domains):
                if node_domains.has(domain) and pod_domains.has(domain):
                    options.values.add(domain)
        return options


class Topology:
    """Group registry + the AddRequirements/Record protocol the in-flight
    node entities drive (topology.go:41-58)."""

    def __init__(
        self,
        domains: Optional[Dict[str, Set[str]]] = None,
        existing_pods: Optional[List[Tuple[Pod, dict, str]]] = None,
        excluded_pod_uids: Iterable[str] = (),
    ):
        # universe of domains per topology key (provisioner.go:251-283)
        self.domains: Dict[str, Set[str]] = {
            k: set(v) for k, v in (domains or {}).items()
        }
        # (pod, node_labels, node_name) triples for domain counting; the
        # cluster-state layer supplies these (topology.go countDomains)
        self.existing_pods = list(existing_pods or [])
        self.excluded_pods: Set[str] = set(excluded_pod_uids)
        self.topologies: Dict[tuple, TopologyGroup] = {}
        self.inverse_topologies: Dict[tuple, TopologyGroup] = {}
        self._inverse_initialized = False
        # reverse owner index: pod uid -> the (deduped) groups it owns, in
        # the pod's constraint order. update() and _matching_topologies are
        # both O(all groups × pods) without it — a 3s host tax per 50k-pod
        # solve. The reference scans its group map per pod too, but Go map
        # iteration order is randomized, so constraint order here is just as
        # faithful.
        self._owned: Dict[str, List[TopologyGroup]] = {}

    # -- group construction ------------------------------------------------

    def ensure_inverse_initialized(self) -> None:
        """Build inverse anti-affinity groups from existing cluster pods.
        update() does this lazily; callers that skip update() for
        constraint-free pods must call it once per solve instead."""
        if not self._inverse_initialized:
            self._update_inverse_affinities()
            self._inverse_initialized = True

    def update(self, pod: Pod) -> None:
        """(Re)build the groups this pod owns; called for every pod entering
        a solve and again after each relaxation (topology.go:105-140)."""
        self.ensure_inverse_initialized()

        for group in self._owned.pop(pod.uid, ()):
            group.remove_owner(pod.uid)

        if has_required_pod_anti_affinity(pod):
            self._update_inverse_anti_affinity(pod, None)

        owned: Dict[int, TopologyGroup] = {}
        for group in self._new_for_topologies(pod) + self._new_for_affinities(pod):
            sig = group.signature()
            existing = self.topologies.get(sig)
            if existing is None:
                self._count_domains(group)
                self.topologies[sig] = group
                existing = group
            existing.add_owner(pod.uid)
            owned[id(existing)] = existing
        if owned:
            self._owned[pod.uid] = list(owned.values())

    def _new_for_topologies(self, pod: Pod) -> List[TopologyGroup]:
        return [
            TopologyGroup(
                TYPE_SPREAD,
                cs.topology_key,
                pod,
                {pod.metadata.namespace},
                cs.label_selector,
                cs.max_skew,
                cs.min_domains,
                self.domains.get(cs.topology_key, set()),
            )
            for cs in pod.topology_spread_constraints
        ]

    def _new_for_affinities(self, pod: Pod) -> List[TopologyGroup]:
        """Both hard and soft terms build groups; relaxation later strips the
        soft ones and re-calls update (topology.go:322-358)."""
        groups = []
        if pod.affinity is None:
            return groups
        for group_type, spec in (
            (TYPE_AFFINITY, pod.affinity.pod_affinity),
            (TYPE_ANTI_AFFINITY, pod.affinity.pod_anti_affinity),
        ):
            if spec is None:
                continue
            terms = list(spec.required) + [w.pod_affinity_term for w in spec.preferred]
            for term in terms:
                groups.append(
                    TopologyGroup(
                        group_type,
                        term.topology_key,
                        pod,
                        self._namespace_list(pod, term),
                        term.label_selector,
                        MAX_SKEW_UNBOUNDED,
                        None,
                        self.domains.get(term.topology_key, set()),
                    )
                )
        return groups

    def _namespace_list(self, pod: Pod, term) -> Set[str]:
        if not term.namespaces:
            return {pod.metadata.namespace}
        return set(term.namespaces)

    def _update_inverse_affinities(self) -> None:
        """Track existing pods' anti-affinity terms so newly scheduled pods
        avoid their domains (topology.go:224-240)."""
        for pod, node_labels, node_name in self.existing_pods:
            if pod.uid in self.excluded_pods or ignored_for_topology(pod):
                continue
            if has_required_pod_anti_affinity(pod):
                labels = dict(node_labels)
                labels.setdefault(apilabels.LABEL_HOSTNAME, node_name)
                self._update_inverse_anti_affinity(pod, labels)

    def _update_inverse_anti_affinity(
        self, pod: Pod, node_labels: Optional[dict]
    ) -> None:
        """Inverse groups track only REQUIRED terms — preferences of other
        pods are not enforced (topology.go:244-269)."""
        for term in pod.affinity.pod_anti_affinity.required:
            group = TopologyGroup(
                TYPE_ANTI_AFFINITY,
                term.topology_key,
                pod,
                self._namespace_list(pod, term),
                term.label_selector,
                MAX_SKEW_UNBOUNDED,
                None,
                self.domains.get(term.topology_key, set()),
            )
            sig = group.signature()
            existing = self.inverse_topologies.get(sig)
            if existing is None:
                self.inverse_topologies[sig] = group
                existing = group
            if node_labels is not None and group.key in node_labels:
                existing.record(node_labels[group.key])
            existing.add_owner(pod.uid)

    def _count_domains(self, group: TopologyGroup) -> None:
        """Seed counts from pods already in the cluster (topology.go:274-321)."""
        for pod, node_labels, node_name in self.existing_pods:
            if pod.uid in self.excluded_pods or ignored_for_topology(pod):
                continue
            if pod.metadata.namespace not in group.namespaces:
                continue
            if group.selector is None or not group.selector.matches(
                pod.metadata.labels
            ):
                continue
            domain = node_labels.get(group.key)
            if domain is None and group.key == apilabels.LABEL_HOSTNAME:
                domain = node_name
            if domain is None:
                continue
            labels = dict(node_labels)
            labels.setdefault(apilabels.LABEL_HOSTNAME, node_name)
            if not group.node_filter.matches_labels(labels):
                continue
            group.record(domain)

    # -- solve-time protocol ----------------------------------------------

    def add_requirements(
        self,
        strict_pod_requirements: Requirements,
        node_requirements: Requirements,
        pod: Pod,
        allow_undefined: frozenset = frozenset(),
    ) -> Requirements:
        """Tightening requirements from every group that owns or counts the
        pod; raises TopologyError when any group admits no domain
        (topology.go:160-190)."""
        out = Requirements()
        for group in self._matching_topologies(pod, node_requirements, allow_undefined):
            pod_domains = strict_pod_requirements.get(group.key)
            node_domains = node_requirements.get(group.key)
            domains = group.get(pod, pod_domains, node_domains)
            if domains.length() == 0:
                counts = dict(sorted(group.domains.items())[:8])
                raise TopologyError(
                    f"unsatisfiable topology constraint for {group.type}, "
                    f"key={group.key} (counts = {counts}, "
                    f"podDomains = {pod_domains!r}, nodeDomains = {node_domains!r})"
                )
            out.add(domains)
        return out

    def record(
        self,
        pod: Pod,
        requirements: Requirements,
        allow_undefined: frozenset = frozenset(),
    ) -> None:
        """Commit the placement into every group that cares
        (topology.go:143-158)."""
        for group in self.topologies.values():
            if group.counts(pod, requirements, allow_undefined):
                domains = requirements.get(group.key)
                if group.type == TYPE_ANTI_AFFINITY:
                    # block every domain the pod could land in
                    group.record(*domains.sorted_values())
                elif domains.length() == 1 and not domains.complement:
                    group.record(domains.sorted_values()[0])
        for group in self.inverse_topologies.values():
            if group.is_owned_by(pod.uid):
                group.record(*requirements.get(group.key).sorted_values())

    def register(self, key: str, domain: str) -> None:
        """New in-flight hostname / discovered domain (topology.go:193-205)."""
        self.domains.setdefault(key, set()).add(domain)
        for group in self.topologies.values():
            if group.key == key:
                group.register(domain)
        for group in self.inverse_topologies.values():
            if group.key == key:
                group.register(domain)

    def unregister(self, key: str, domain: str) -> None:
        self.domains.get(key, set()).discard(domain)
        for group in self.topologies.values():
            if group.key == key:
                group.unregister(domain)
        for group in self.inverse_topologies.values():
            if group.key == key:
                group.unregister(domain)

    def _matching_topologies(
        self, pod: Pod, requirements: Requirements, allow_undefined: frozenset
    ) -> List[TopologyGroup]:
        """Groups owning the pod + inverse groups whose selector the pod
        matches (topology.go:400-414)."""
        out = list(self._owned.get(pod.uid, ()))
        out.extend(
            g
            for g in self.inverse_topologies.values()
            if g.counts(pod, requirements, allow_undefined)
        )
        return out


def domain_universe(
    nodepools,
    instance_types: Dict[str, list],
    existing_nodes=(),
) -> Dict[str, Set[str]]:
    """The closed world of topology domains discoverable before a solve.

    Instance-type requirement values are INTERSECTED with the NodePool's
    requirements+labels first so e.g. zones an instance type offers but the
    pool forbids don't expand the universe (provisioner.go:251-283). Existing
    node domains enter via registration/record, not the universe, matching
    the reference (``existing_nodes`` kept for callers that need hostname
    seeding before any group exists)."""
    domains: Dict[str, Set[str]] = {}

    def observe(key: str, values) -> None:
        if values:
            domains.setdefault(key, set()).update(values)

    for pool in nodepools:
        pool_reqs = Requirements.from_node_selector_requirements_with_min_values(
            pool.spec.template.requirements
        )
        pool_reqs.add(
            *Requirements.from_labels(pool.spec.template.labels).values()
        )
        for it in instance_types.get(pool.name, []):
            reqs = pool_reqs.copy()
            reqs.add(*(r.copy() for r in it.requirements.values()))
            for key, req in reqs.items():
                if not req.complement:
                    observe(key, req.values)
        for key, req in pool_reqs.items():
            if req.operator() == OP_IN:
                observe(key, req.values)
    for node in existing_nodes:
        if apilabels.LABEL_HOSTNAME not in node.labels:
            observe(apilabels.LABEL_HOSTNAME, [node.name])
    return domains
