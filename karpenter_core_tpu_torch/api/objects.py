"""Standalone kubernetes-shaped object model.

The framework is self-contained (no kube-apiserver in the loop for tests and
benchmarks — the in-memory ``kube`` store plays envtest's role, reference:
pkg/test/environment.go:60-80), so the core API machinery objects the
reference gets from client-go are defined here as plain dataclasses.

Resource quantities are float64 (cpu in cores, memory/storage in bytes).
The reference uses apimachinery's infinite-precision Quantity; every value the
scheduler actually compares is well inside float64's 2^53 integer range.
"""
from __future__ import annotations

import itertools
import re
from dataclasses import dataclass, field

from typing import Optional

# ---------------------------------------------------------------------------
# Quantities

_QUANTITY_RE = re.compile(r"^([+-]?[0-9.]+(?:[eE][+-]?[0-9]+)?)([A-Za-z]*)$")

_SUFFIX = {
    "": 1.0,
    "m": 1e-3,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
    "Ki": 2.0**10,
    "Mi": 2.0**20,
    "Gi": 2.0**30,
    "Ti": 2.0**40,
    "Pi": 2.0**50,
    "Ei": 2.0**60,
}


def parse_quantity(value: "str | int | float") -> float:
    """Parse a kubernetes quantity string ('100m', '1Gi', '2') to a float."""
    if isinstance(value, (int, float)):
        return float(value)
    m = _QUANTITY_RE.match(value.strip())
    if not m:
        raise ValueError(f"cannot parse quantity {value!r}")
    number, suffix = m.groups()
    if suffix not in _SUFFIX:
        raise ValueError(f"unknown quantity suffix {suffix!r} in {value!r}")
    return float(number) * _SUFFIX[suffix]


# Resource names (mirror corev1.ResourceName values)
RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_PODS = "pods"
RESOURCE_EPHEMERAL_STORAGE = "ephemeral-storage"

ResourceList = dict  # dict[str, float]


def resource_list(**kwargs) -> ResourceList:
    """Build a ResourceList from keyword args; 'memory'/'ephemeral_storage' keys normalized."""
    out = {}
    for k, v in kwargs.items():
        out[k.replace("_", "-")] = parse_quantity(v)
    return out


# ---------------------------------------------------------------------------
# Metadata

_uid_counter = itertools.count(1)


def new_uid() -> str:
    return f"uid-{next(_uid_counter):08d}"


@dataclass
class OwnerReference:
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = False


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=new_uid)
    labels: dict = field(default_factory=dict)
    annotations: dict = field(default_factory=dict)
    finalizers: list = field(default_factory=list)
    owner_references: list = field(default_factory=list)
    # 0.0 = unset; the kube store stamps it from ITS clock on create, so
    # multiple stores/operators with different clocks never cross-contaminate
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    resource_version: int = 0
    generation: int = 1


# ---------------------------------------------------------------------------
# Taints & tolerations

TAINT_EFFECT_NO_SCHEDULE = "NoSchedule"
TAINT_EFFECT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
TAINT_EFFECT_NO_EXECUTE = "NoExecute"

TOLERATION_OP_EXISTS = "Exists"
TOLERATION_OP_EQUAL = "Equal"


@dataclass(frozen=True)
class Taint:
    key: str
    effect: str
    value: str = ""

    def __str__(self) -> str:
        return f"{self.key}={self.value}:{self.effect}" if self.value else f"{self.key}:{self.effect}"


@dataclass(frozen=True)
class Toleration:
    """Mirror of corev1.Toleration.ToleratesTaint semantics."""

    key: str = ""
    operator: str = TOLERATION_OP_EQUAL
    value: str = ""
    effect: str = ""
    toleration_seconds: Optional[float] = None

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == TOLERATION_OP_EXISTS:
            return True
        if self.operator in ("", TOLERATION_OP_EQUAL):
            return self.value == taint.value
        return False  # unknown operators never tolerate (corev1 semantics)


# ---------------------------------------------------------------------------
# Node selector / affinity

@dataclass(frozen=True)
class NodeSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: tuple = ()
    min_values: Optional[int] = None  # NodePool flexibility extension


@dataclass(frozen=True)
class NodeSelectorTerm:
    match_expressions: tuple = ()  # tuple[NodeSelectorRequirement]


@dataclass(frozen=True)
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm


@dataclass
class NodeAffinity:
    required: list = field(default_factory=list)  # list[NodeSelectorTerm] (OR'd)
    preferred: list = field(default_factory=list)  # list[PreferredSchedulingTerm]


@dataclass(frozen=True)
class LabelSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist
    values: tuple = ()


@dataclass(frozen=True)
class LabelSelector:
    match_labels: tuple = ()  # tuple[(key, value)]
    match_expressions: tuple = ()  # tuple[LabelSelectorRequirement]

    def matches(self, labels: dict) -> bool:
        for k, v in self.match_labels:
            if labels.get(k) != v:
                return False
        for expr in self.match_expressions:
            has = expr.key in labels
            val = labels.get(expr.key)
            if expr.operator == "In":
                if not has or val not in expr.values:
                    return False
            elif expr.operator == "NotIn":
                if has and val in expr.values:
                    return False
            elif expr.operator == "Exists":
                if not has:
                    return False
            elif expr.operator == "DoesNotExist":
                if has:
                    return False
        return True


@dataclass(frozen=True)
class PodAffinityTerm:
    topology_key: str
    label_selector: Optional[LabelSelector] = None
    namespaces: tuple = ()


@dataclass(frozen=True)
class WeightedPodAffinityTerm:
    weight: int
    pod_affinity_term: PodAffinityTerm


@dataclass
class PodAffinity:
    required: list = field(default_factory=list)  # list[PodAffinityTerm]
    preferred: list = field(default_factory=list)  # list[WeightedPodAffinityTerm]


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAffinity] = None


@dataclass(frozen=True)
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str  # DoNotSchedule | ScheduleAnyway
    label_selector: Optional[LabelSelector] = None
    min_domains: Optional[int] = None


# ---------------------------------------------------------------------------
# Pod

POD_PENDING = "Pending"
POD_RUNNING = "Running"
POD_SUCCEEDED = "Succeeded"
POD_FAILED = "Failed"


@dataclass(frozen=True)
class PodVolume:
    """One pod volume spec entry. Only PVC-backed shapes matter to
    scheduling (emptyDir/hostPath etc. are represented by pvc_name=None and
    ignored, reference volumetopology.go:86-88)."""

    name: str
    pvc_name: Optional[str] = None  # persistentVolumeClaim.claimName
    ephemeral: bool = False  # generic ephemeral volume -> PVC "<pod>-<name>"


# Native-sidecar restart policy marker (k8s ContainerRestartPolicyAlways).
CONTAINER_RESTART_ALWAYS = "Always"


@dataclass
class Container:
    """One container spec entry — just the scheduling-relevant surface.

    ``restart_policy`` only matters on init containers: "Always" marks a
    native sidecar whose requests persist for the pod's lifetime
    (resources.go:96-128 podRequests)."""

    name: str = ""
    resource_requests: ResourceList = field(default_factory=dict)
    resource_limits: ResourceList = field(default_factory=dict)
    restart_policy: Optional[str] = None


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    # Aggregated resource requests. When ``containers``/``init_containers``
    # are present this is DERIVED at construction via the reference's
    # ceiling rule (max of container sum vs init-container peaks, plus
    # overhead — resources.go:96-128); providing it directly is the
    # flat-request convenience path for workloads without container specs.
    resource_requests: ResourceList = field(default_factory=dict)
    # Derived alongside requests when container specs are present
    # (resources.go podLimits; exported by the node metrics exporter via
    # utils/resources.limits_for_pods, statenode.go:429's consumer role).
    resource_limits: ResourceList = field(default_factory=dict)
    # Container-level spec (utils/resources.ceiling derives the aggregate).
    containers: list = field(default_factory=list)
    init_containers: list = field(default_factory=list)
    # RuntimeClass pod overhead, added on top of the container aggregate
    # (resources.go:124-126).
    overhead: ResourceList = field(default_factory=dict)
    node_selector: dict = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: list = field(default_factory=list)
    topology_spread_constraints: list = field(default_factory=list)
    host_ports: list = field(default_factory=list)  # list[(ip, port, protocol)]
    volumes: list = field(default_factory=list)  # list[PodVolume]
    # zone/etc requirements derived from this pod's PVCs, stamped by
    # VolumeTopology.inject pre-solve; AND'd into the pod's requirements by
    # Requirements.from_pod so relaxation can never strip them
    # (volumetopology.go:68-72's per-term injection, lifted out of the spec)
    volume_requirements: list = field(default_factory=list)
    # {csi driver -> set of pvc keys}, resolved pre-solve for attach-limit
    # accounting without a client in the scheduler (volumeusage.go GetVolumes)
    resolved_volumes: Optional[dict] = None
    priority: int = 0
    priority_class_name: str = ""
    # k8s defaults terminationGracePeriodSeconds to 30
    termination_grace_period_seconds: float = 30.0
    preemption_policy: str = "PreemptLowerPriority"
    scheduling_gates: list = field(default_factory=list)
    node_name: str = ""
    phase: str = POD_PENDING
    # conditions: list of (type, status, reason)
    conditions: list = field(default_factory=list)
    is_daemonset: bool = False
    is_mirror: bool = False

    def __post_init__(self):
        if self.containers or self.init_containers:
            from karpenter_core_tpu_torch.utils import resources as _res

            self.resource_requests = _res.pod_requests(self)
            self.resource_limits = _res.pod_limits(self)
        elif self.overhead:
            # flat-request pods with RuntimeClass overhead: overhead lands on
            # top of the provided requests (resources.go:124-126), it does
            # not replace them
            from karpenter_core_tpu_torch.utils import resources as _res

            self.resource_requests = _res.merge(
                self.resource_requests, self.overhead
            )
            if self.resource_limits:
                self.resource_limits = _res.merge(
                    self.resource_limits, self.overhead
                )

    @property
    def uid(self) -> str:
        return self.metadata.uid

    @property
    def name(self) -> str:
        return self.metadata.name

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


# ---------------------------------------------------------------------------
# DaemonSet (enough surface for daemon-overhead accounting,
# reference: pkg/controllers/provisioning/provisioner.go:409-434)

@dataclass
class DaemonSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    pod_template: Optional["Pod"] = None

    @property
    def name(self) -> str:
        return self.metadata.name


# ---------------------------------------------------------------------------
# Node

@dataclass
class NodeStatus:
    capacity: ResourceList = field(default_factory=dict)
    allocatable: ResourceList = field(default_factory=dict)
    conditions: list = field(default_factory=list)  # list[(type, status)]
    phase: str = ""


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provider_id: str = ""
    taints: list = field(default_factory=list)
    unschedulable: bool = False
    status: NodeStatus = field(default_factory=NodeStatus)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def labels(self) -> dict:
        return self.metadata.labels

    def ready(self) -> bool:
        return any(t == "Ready" and s == "True" for t, s, *_ in self.status.conditions)


# ---------------------------------------------------------------------------
# Storage (PVC/PV/StorageClass/CSINode/VolumeAttachment — the surface the
# volume-aware scheduling + termination paths consume; reference:
# volumetopology.go:45-150, volumeusage.go:82-150,
# node/termination/controller.go:190-201)

@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    storage_class_name: Optional[str] = None
    volume_name: str = ""  # bound PV name ("" = unbound)

    @property
    def name(self) -> str:
        return self.metadata.name

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    # required node-affinity terms (ORed; zone-pinning for zonal volumes)
    node_affinity_required: list = field(default_factory=list)  # [NodeSelectorTerm]
    csi_driver: str = ""  # spec.csi.driver ("" = non-CSI)
    local: bool = False  # spec.local / spec.hostPath: hostname affinity is
    host_path: bool = False  # dropped on reschedule (volumetopology.go:141-146)

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""
    # [(key, values)] from allowedTopologies[0].matchLabelExpressions
    allowed_topologies: list = field(default_factory=list)

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class CSINode:
    """Per-node CSI driver attach limits (name == node name)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    drivers: list = field(default_factory=list)  # [(driver name, allocatable)]

    @property
    def name(self) -> str:
        return self.metadata.name


@dataclass
class VolumeAttachment:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    attacher: str = ""
    node_name: str = ""
    pv_name: str = ""

    @property
    def name(self) -> str:
        return self.metadata.name


# ---------------------------------------------------------------------------
# PodDisruptionBudget (policy/v1; the surface pdb.NewLimits and the eviction
# API consume — reference pkg/utils/pdb/pdb.go:33-118)

@dataclass
class PodDisruptionBudget:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    # exactly one of these is set; int = absolute, str "N%" = percentage
    min_available: "int | str | None" = None
    max_unavailable: "int | str | None" = None
    unhealthy_pod_eviction_policy: str = "IfHealthyBudget"  # | AlwaysAllow

    @property
    def name(self) -> str:
        return self.metadata.name

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"
