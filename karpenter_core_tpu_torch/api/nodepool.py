"""NodePool — the template of node possibilities plus disruption policy
(reference: pkg/apis/v1/nodepool.go:38-367)."""
from __future__ import annotations

import hashlib
import json
import math
import time
from dataclasses import dataclass, field
from typing import Optional

from karpenter_core_tpu_torch.api.duration import NillableDuration
from karpenter_core_tpu_torch.api.nodeclaim import NodeClassRef
from karpenter_core_tpu_torch.api.objects import ObjectMeta, ResourceList
from karpenter_core_tpu_torch.api.status import ConditionSet

CONSOLIDATION_POLICY_WHEN_EMPTY = "WhenEmpty"
CONSOLIDATION_POLICY_WHEN_EMPTY_OR_UNDERUTILIZED = "WhenEmptyOrUnderutilized"

# Disruption reasons (reference: nodepool.go DisruptionReason values)
REASON_UNDERUTILIZED = "Underutilized"
REASON_EMPTY = "Empty"
REASON_DRIFTED = "Drifted"
REASON_ALL = "All"  # budget wildcard

COND_NODEPOOL_VALIDATION_SUCCEEDED = "ValidationSucceeded"
COND_NODEPOOL_NODECLASS_READY = "NodeClassReady"


@dataclass
class Budget:
    """Disruption budget: max concurrently-disrupted nodes, optionally
    cron-windowed (reference: nodepool.go:320-367)."""

    nodes: str = "10%"  # absolute count or percentage
    schedule: Optional[str] = None  # cron expression; None = always active
    duration: Optional[float] = None  # seconds; required when schedule set
    reasons: list = field(default_factory=list)  # empty = all reasons

    def is_active(self, now: Optional[float] = None) -> bool:
        """Budget windows (nodepool.go:353-367). Cron schedules are matched by
        utils/cron.py; no schedule means always active."""
        if self.schedule is None:
            return True
        from karpenter_core_tpu_torch.utils.cron import last_fire_before

        now = time.time() if now is None else now
        fired = last_fire_before(self.schedule, now)
        if fired is None:
            return False
        return now - fired < (self.duration or 0.0)

    def allowed_disruptions(self, total_nodes: int, now: Optional[float] = None) -> int:
        """Nodes this budget allows disrupting (nodepool.go:305-351).
        Percentages round UP, matching GetScaledValueFromIntOrPercent(.., true)
        — 5% of 10 nodes allows 1 rather than blocking everything."""
        if not self.is_active(now):
            return 1 << 31  # inactive budgets don't constrain
        if self.nodes.endswith("%"):
            pct = float(self.nodes[:-1]) / 100.0
            return math.ceil(pct * total_nodes - 1e-9)
        return int(self.nodes)


@dataclass
class Disruption:
    consolidate_after: NillableDuration = field(default_factory=lambda: NillableDuration(0.0))
    consolidation_policy: str = CONSOLIDATION_POLICY_WHEN_EMPTY_OR_UNDERUTILIZED
    budgets: list = field(default_factory=lambda: [Budget(nodes="10%")])


@dataclass
class Limits(dict):
    """Resource ceilings for a NodePool (nodepool.go:142-154)."""

    def exceeded_by(self, usage: ResourceList) -> list:
        errs = []
        for name, limit in self.items():
            if usage.get(name, 0.0) > limit:
                errs.append(
                    f"{name} resource usage of {usage.get(name, 0.0):g} exceeds limit of {limit:g}"
                )
        return errs


@dataclass
class NodeClaimTemplateSpec:
    """The NodeClaim template embedded in a NodePool."""

    requirements: list = field(default_factory=list)  # NodeSelectorRequirement (with min_values)
    node_class_ref: Optional[NodeClassRef] = None
    taints: list = field(default_factory=list)
    startup_taints: list = field(default_factory=list)
    labels: dict = field(default_factory=dict)
    annotations: dict = field(default_factory=dict)
    expire_after: NillableDuration = field(default_factory=NillableDuration)
    termination_grace_period: Optional[float] = None


@dataclass
class NodePoolSpec:
    template: NodeClaimTemplateSpec = field(default_factory=NodeClaimTemplateSpec)
    disruption: Disruption = field(default_factory=Disruption)
    limits: Limits = field(default_factory=Limits)
    weight: int = 0  # higher = tried first


@dataclass
class NodePoolStatus:
    resources: ResourceList = field(default_factory=dict)  # in-use aggregation


@dataclass
class NodePool:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodePoolSpec = field(default_factory=NodePoolSpec)
    status: NodePoolStatus = field(default_factory=NodePoolStatus)
    conditions: ConditionSet = field(default_factory=ConditionSet)

    @property
    def name(self) -> str:
        return self.metadata.name

    def static_hash(self) -> str:
        """Drift hash over the static (non-requirement) template fields
        (reference: nodepool.go:277-283 Hash())."""
        payload = {
            "labels": self.spec.template.labels,
            "annotations": self.spec.template.annotations,
            "taints": [str(t) for t in self.spec.template.taints],
            "startup_taints": [str(t) for t in self.spec.template.startup_taints],
            "expire_after": str(self.spec.template.expire_after),
            "termination_grace_period": self.spec.template.termination_grace_period,
            "node_class_ref": (
                [self.spec.template.node_class_ref.group,
                 self.spec.template.node_class_ref.kind,
                 self.spec.template.node_class_ref.name]
                if self.spec.template.node_class_ref
                else None
            ),
        }
        return hashlib.sha256(
            json.dumps(payload, sort_keys=True).encode()
        ).hexdigest()[:16]

    def allowed_disruptions_by_reason(
        self, reason: str, total_nodes: int, now: Optional[float] = None
    ) -> int:
        """Min across budgets matching the reason (nodepool.go:305-318)."""
        allowed = total_nodes
        for budget in self.spec.disruption.budgets:
            if budget.reasons and reason not in budget.reasons and REASON_ALL not in budget.reasons:
                continue
            allowed = min(allowed, budget.allowed_disruptions(total_nodes, now))
        return max(allowed, 0)
