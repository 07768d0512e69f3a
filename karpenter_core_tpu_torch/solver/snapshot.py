"""Cluster-snapshot → device-tensor codec.

One ``Snapshot`` is the device-resident image of everything one solve needs:
pod equivalence classes, instance-type catalog, nodeclaim templates, and
existing nodes, all encoded over a single closed-world vocabulary
(solver/vocab.py). This is the host↔device boundary the reference never had
— its moral equivalent is the scheduler-input assembly in
provisioner.go:215-284 (NodePool listing, instance types, topology-domain
universe).

Pods collapse into equivalence classes first (identical requirements,
tolerations, and resource requests are exchangeable in the FFD loop — the
reference walks them one at a time, we batch them; scheduler.go:208-266).
50k pods from a handful of deployments typically collapse to a few hundred
classes, which is what makes the device scan short.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.objects import Pod, RESOURCE_PODS, Taint
from karpenter_core_tpu_torch.cloudprovider.types import InstanceType
from karpenter_core_tpu_torch.scheduling import Requirements
from karpenter_core_tpu_torch.solver.gangs import pod_gang_sig
from karpenter_core_tpu_torch.utils.disruption import priority_tier
from karpenter_core_tpu_torch.solver.vocab import (
    EntityMasks,
    FrozenVocab,
    Vocab,
    encode_requirements_batch,
)

# Default resource axis; extended resources append dynamically.
BASE_RESOURCES = ("cpu", "memory", "pods", "ephemeral-storage")


@dataclass
class PodClass:
    """An equivalence class of pending pods."""

    requirements: Requirements
    strict_requirements: Requirements
    tolerations: tuple
    requests: dict
    pods: List[Pod] = field(default_factory=list)
    # gangsched (ISSUE 10): the class's priority tier
    # (utils/disruption.priority_tier — 0 for the k8s default) and its
    # gang signature (solver/gangs.pod_gang_sig — None outside any gang).
    # Both are part of the spec signature below, so a class is always
    # tier- and gang-homogeneous; plain pods carry the defaults and their
    # signatures (hence every prepared-state cache key) are unchanged.
    tier: int = 0
    gang: Optional[tuple] = None
    # the raw-spec equivalence key this class was grouped under (see
    # _spec_signature). Everything the solver encodes per class — value
    # masks, strict masks, quantized request vectors, taint rows — is a
    # pure function of (signature, vocab, catalog), which is what lets the
    # prepared-state cache in models/provisioner reuse encoded rows across
    # solves and relaxation rounds instead of re-running the numpy encode
    # for every class every round.
    signature: tuple = ()

    @property
    def count(self) -> int:
        return len(self.pods)


def _spec_signature(pod: Pod, label_aware: bool) -> tuple:
    """Raw-spec equivalence key. Strictly finer than (or equal to) the
    requirement-level signature — two pods with identical selector/affinity/
    toleration/request/spread fields always produce identical Requirements —
    so grouping by it is sound and skips building Requirements per pod.

    When the solve carries topology groups (label_aware), the key also
    covers pod-(anti-)affinity terms and the pod's own labels: labels decide
    which groups COUNT the pod (TopologyGroup.selects), terms decide which
    groups CONSTRAIN it, so pods differing in either are not exchangeable.
    Topology-free solves skip both so deployment-distinct labels don't
    fragment the 50k-pod class collapse.

    Priority tiers and gang membership (ISSUE 10) append a trailing
    component ONLY when non-default: the kernel packs tiers in order and
    commits gangs atomically, so pods differing in either are not
    exchangeable — but a default-tier gang-free pod's signature is
    byte-identical to the pre-gang one (the off-by-default parity the
    prepared caches and wire fingerprints rest on). The suffixed tuples
    cannot collide with the unsuffixed ones (lengths 3/12 vs 2/11)."""
    tier = priority_tier(pod.priority)
    gang = pod_gang_sig(pod)
    suffix = () if tier == 0 and gang is None else ((tier, gang),)
    # fast path for the dominant 50k-batch shape: resource-only pods (no
    # affinity/tolerations/spread/ports/volumes). The short tuple can never
    # collide with the full 10-tuple below.
    if (
        pod.affinity is None
        and not pod.tolerations
        and not pod.topology_spread_constraints
        and not pod.host_ports
        and not pod.volumes
        and not pod.volume_requirements
        and not pod.node_selector
    ):
        return (
            tuple(sorted(pod.resource_requests.items())),
            tuple(sorted((pod.metadata.labels or {}).items()))
            if label_aware
            else (),
        ) + suffix
    affinity_sig = None
    pod_aff_sig = None
    pod_anti_sig = None
    if pod.affinity is not None:
        if pod.affinity.node_affinity is not None:
            na = pod.affinity.node_affinity
            affinity_sig = (
                tuple(na.required),
                tuple(na.preferred),
            )
        if pod.affinity.pod_affinity is not None:
            pa = pod.affinity.pod_affinity
            pod_aff_sig = (tuple(pa.required), tuple(pa.preferred))
        if pod.affinity.pod_anti_affinity is not None:
            pa = pod.affinity.pod_anti_affinity
            pod_anti_sig = (tuple(pa.required), tuple(pa.preferred))
    return (
        tuple(sorted(pod.node_selector.items())),
        affinity_sig,
        pod_aff_sig,
        pod_anti_sig,
        tuple(sorted((pod.metadata.labels or {}).items()))
        if label_aware
        else (),
        tuple(sorted((t.key, t.operator, t.value, t.effect) for t in pod.tolerations)),
        tuple(sorted(pod.resource_requests.items())),
        tuple(pod.topology_spread_constraints),
        # hostPort pods must form their own class so the decode path always
        # runs per-pod HostPortUsage conflict checks (nodeclaim.go add path);
        # sharing a class with port-free twins would skip them
        tuple(sorted(pod.host_ports)),
        # PVC-derived requirements and volume identities both affect
        # placement (zone pins; attach-limit accounting on existing nodes)
        tuple(pod.volume_requirements),
        tuple(pod.volumes),
    ) + suffix


def group_pods(pods: Sequence[Pod], label_aware: bool = True) -> List[PodClass]:
    """Dedupe pods into equivalence classes. Signature covers everything the
    resource+requirements+taints solve observes; pods with affinity/spread
    constraints get their own per-constraint signatures (handled by the
    topology-aware path). Requirements are built once per class, not per
    pod — the 50k-pod path spends its time here otherwise."""
    classes: Dict[tuple, PodClass] = {}
    for pod in pods:
        sig = _spec_signature(pod, label_aware)
        cls = classes.get(sig)
        if cls is None:
            cls = PodClass(
                requirements=Requirements.from_pod(pod),
                strict_requirements=Requirements.from_pod_strict(pod),
                tolerations=tuple(pod.tolerations),
                requests=dict(pod.resource_requests),
                signature=(label_aware, sig),
                tier=priority_tier(pod.priority),
                gang=pod_gang_sig(pod),
            )
            classes[sig] = cls
        cls.pods.append(pod)
    return list(classes.values())


@dataclass
class Snapshot:
    """Encoded solve inputs (numpy; jax device put happens in models/)."""

    vocab: FrozenVocab
    resource_names: List[str]
    well_known: np.ndarray  # [K] bool

    # pod classes
    classes: List[PodClass]
    class_masks: EntityMasks
    class_requests: np.ndarray  # [C, R]
    class_counts: np.ndarray  # [C] int32
    class_tolerates: np.ndarray  # [C, TA] bool

    # instance types
    instance_types: List[InstanceType]
    it_masks: EntityMasks
    it_allocatable: np.ndarray  # [T, R]
    it_min_price: np.ndarray  # [T] cheapest available offering price (inf if none)
    it_has_offering: np.ndarray  # [T] bool any available offering

    # taint vocabulary
    taints: List[Taint]

    @property
    def C(self) -> int:
        return len(self.classes)

    @property
    def T(self) -> int:
        return len(self.instance_types)

    @property
    def R(self) -> int:
        return len(self.resource_names)


def encode_snapshot(
    pods: Sequence[Pod],
    instance_types: Sequence[InstanceType],
    extra_requirements: Sequence[Requirements] = (),
    extra_taints: Sequence[Sequence[Taint]] = (),
) -> Tuple[Snapshot, Optional[EntityMasks], Optional[np.ndarray]]:
    """Encode pods + catalog, plus an optional extra entity group sharing the
    vocab — e.g. nodeclaim templates (one Requirements per template, one taint
    list per template) or existing nodes.

    Returns (snapshot, extra_masks [S,...], extra_taint_matrix [S, TA]).
    """
    classes = group_pods(pods)

    vocab = Vocab()
    for cls in classes:
        vocab.observe_requirements(cls.requirements)
    for it in instance_types:
        vocab.observe_requirements(it.requirements)
        for off in it.offerings:
            vocab.observe_requirements(off.requirements)
    for reqs in extra_requirements:
        vocab.observe_requirements(reqs)
    frozen = vocab.finalize()

    well_known = np.zeros((frozen.K,), dtype=bool)
    # graftlint: disable=GL201 -- writes land at vocab-assigned kid
    # indices, so iteration order cannot affect the plane
    for key, kid in frozen.keys.items():
        well_known[kid] = key in apilabels.WELL_KNOWN_LABELS
    frozen.well_known_mask = well_known

    # resource axis
    resource_names = list(BASE_RESOURCES)
    seen = set(resource_names)
    for coll in (
        [c.requests for c in classes],
        [it.allocatable() for it in instance_types],
    ):
        for rl in coll:
            for name in rl:
                if name not in seen:
                    seen.add(name)
                    resource_names.append(name)

    class_masks = encode_requirements_batch(frozen, [c.requirements for c in classes])
    it_masks = encode_requirements_batch(
        frozen, [it.requirements for it in instance_types]
    )

    C, R, T = len(classes), len(resource_names), len(instance_types)
    class_requests = np.zeros((C, R), dtype=np.float32)
    for i, cls in enumerate(classes):
        for j, name in enumerate(resource_names):
            class_requests[i, j] = cls.requests.get(name, 0.0)
        # every pod occupies one slot of the 'pods' resource
        class_requests[i, resource_names.index(RESOURCE_PODS)] += 1.0
    class_counts = np.array([c.count for c in classes], dtype=np.int32)

    it_allocatable = np.zeros((T, R), dtype=np.float32)
    it_min_price = np.full((T,), np.inf, dtype=np.float32)
    it_has_offering = np.zeros((T,), dtype=bool)
    for i, it in enumerate(instance_types):
        alloc = it.allocatable()
        for j, name in enumerate(resource_names):
            it_allocatable[i, j] = alloc.get(name, 0.0)
        available = it.offerings.available()
        if available:
            it_has_offering[i] = True
            it_min_price[i] = min(o.price for o in available)

    # taint vocabulary: union over extra taint groups (templates/nodes);
    # classes precompute toleration per taint host-side (exact semantics).
    taint_list: List[Taint] = []
    taint_ids: Dict[Taint, int] = {}
    for group in extra_taints:
        for t in group:
            if t not in taint_ids:
                taint_ids[t] = len(taint_list)
                taint_list.append(t)
    TA = max(len(taint_list), 1)
    class_tolerates = np.zeros((C, TA), dtype=bool)
    for i, cls in enumerate(classes):
        # graftlint: disable=GL201 -- writes land at tid indices assigned
        # above in extra_taints arrival order, so iteration order cannot
        # affect the matrix
        for t, tid in taint_ids.items():
            class_tolerates[i, tid] = any(
                tol.tolerates(t) for tol in cls.tolerations
            )

    snapshot = Snapshot(
        vocab=frozen,
        resource_names=resource_names,
        well_known=well_known,
        classes=classes,
        class_masks=class_masks,
        class_requests=class_requests,
        class_counts=class_counts,
        class_tolerates=class_tolerates,
        instance_types=list(instance_types),
        it_masks=it_masks,
        it_allocatable=it_allocatable,
        it_min_price=it_min_price,
        it_has_offering=it_has_offering,
        taints=taint_list,
    )

    extra_masks = (
        encode_requirements_batch(frozen, list(extra_requirements))
        if extra_requirements
        else None
    )
    extra_taint_matrix = None
    if extra_taints:
        extra_taint_matrix = np.zeros((len(extra_taints), TA), dtype=bool)
        for i, group in enumerate(extra_taints):
            for t in group:
                tid = taint_ids.get(t)
                if tid is not None:
                    extra_taint_matrix[i, tid] = True
    return snapshot, extra_masks, extra_taint_matrix
