"""NodeClaim — a requested machine (reference: pkg/apis/v1/nodeclaim.go:27-156,
nodeclaim_status.go:25-78). Spec is immutable after creation."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from karpenter_core_tpu_torch.api.duration import NillableDuration
from karpenter_core_tpu_torch.api.objects import ObjectMeta, ResourceList
from karpenter_core_tpu_torch.api.status import ConditionSet

# Condition types (reference: nodeclaim_status.go:25-34)
COND_LAUNCHED = "Launched"
COND_REGISTERED = "Registered"
COND_INITIALIZED = "Initialized"
COND_CONSOLIDATABLE = "Consolidatable"
COND_DRIFTED = "Drifted"
COND_INSTANCE_TERMINATING = "InstanceTerminating"
COND_CONSISTENT_STATE_FOUND = "ConsistentStateFound"
COND_DISRUPTION_REASON = "DisruptionReason"
COND_READY = "Ready"

LIFECYCLE_CONDITIONS = (COND_LAUNCHED, COND_REGISTERED, COND_INITIALIZED)


@dataclass
class NodeClassRef:
    group: str = ""
    kind: str = ""
    name: str = ""


@dataclass
class NodeClaimSpec:
    # scheduling requirements: list[api.objects.NodeSelectorRequirement]
    requirements: list = field(default_factory=list)
    resources_requests: ResourceList = field(default_factory=dict)
    node_class_ref: Optional[NodeClassRef] = None
    taints: list = field(default_factory=list)
    startup_taints: list = field(default_factory=list)
    expire_after: NillableDuration = field(default_factory=NillableDuration)
    termination_grace_period: Optional[float] = None  # seconds


@dataclass
class NodeClaimStatus:
    node_name: str = ""
    provider_id: str = ""
    image_id: str = ""
    capacity: ResourceList = field(default_factory=dict)
    allocatable: ResourceList = field(default_factory=dict)
    last_pod_event_time: Optional[float] = None


@dataclass
class NodeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeClaimSpec = field(default_factory=NodeClaimSpec)
    status: NodeClaimStatus = field(default_factory=NodeClaimStatus)
    conditions: ConditionSet = field(default_factory=ConditionSet)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def nodepool_name(self) -> str:
        from karpenter_core_tpu_torch.api import labels as apilabels

        return self.metadata.labels.get(apilabels.NODEPOOL_LABEL_KEY, "")

    def is_launched(self) -> bool:
        return self.conditions.is_true(COND_LAUNCHED)

    def is_registered(self) -> bool:
        return self.conditions.is_true(COND_REGISTERED)

    def is_initialized(self) -> bool:
        return self.conditions.is_true(COND_INITIALIZED)
