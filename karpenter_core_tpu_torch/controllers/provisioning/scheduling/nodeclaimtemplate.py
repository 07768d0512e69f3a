"""NodeClaimTemplate + instance-type filtering
(reference: scheduling/nodeclaimtemplate.go:33-96, nodeclaim.go:248-300)."""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.nodeclaim import NodeClaim, NodeClaimSpec
from karpenter_core_tpu_torch.api.nodepool import NodePool
from karpenter_core_tpu_torch.api.objects import NodeSelectorRequirement, ObjectMeta
from karpenter_core_tpu_torch.cloudprovider.types import (
    InstanceType,
    order_by_price,
    satisfies_min_values,
)
from karpenter_core_tpu_torch.scheduling import Requirement, Requirements
from karpenter_core_tpu_torch.scheduling.requirements import (
    ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
)
from karpenter_core_tpu_torch.utils import resources as resutil

# Launch-side truncation of the viable instance-type list
# (nodeclaimtemplate.go:33-35).
MAX_INSTANCE_TYPES = 60

_claim_counter = itertools.count(1)


@dataclass
class NodeClaimTemplate:
    nodepool_name: str
    nodepool_uid: str
    requirements: Requirements
    instance_type_options: List[InstanceType]
    taints: list
    startup_taints: list
    labels: dict
    annotations: dict
    spec: NodeClaimSpec

    @classmethod
    def from_nodepool(cls, nodepool: NodePool) -> "NodeClaimTemplate":
        tmpl = nodepool.spec.template
        labels = dict(tmpl.labels)
        labels[apilabels.NODEPOOL_LABEL_KEY] = nodepool.name
        annotations = dict(tmpl.annotations)
        annotations[apilabels.NODEPOOL_HASH_ANNOTATION_KEY] = nodepool.static_hash()
        # version travels with the hash so drift's annotation-vs-annotation
        # compare is gated on matching hash algorithms
        # (nodeclaimtemplate.go stamps both; hash/controller.go migrates)
        annotations[apilabels.NODEPOOL_HASH_VERSION_ANNOTATION_KEY] = (
            apilabels.HASH_VERSION
        )
        requirements = Requirements()
        requirements.add(
            *Requirements.from_node_selector_requirements_with_min_values(
                tmpl.requirements
            ).values()
        )
        requirements.add(*Requirements.from_labels(labels).values())
        return cls(
            nodepool_name=nodepool.name,
            nodepool_uid=nodepool.metadata.uid,
            requirements=requirements,
            instance_type_options=[],
            taints=list(tmpl.taints),
            startup_taints=list(tmpl.startup_taints),
            labels=labels,
            annotations=annotations,
            spec=NodeClaimSpec(
                node_class_ref=tmpl.node_class_ref,
                taints=list(tmpl.taints),
                startup_taints=list(tmpl.startup_taints),
                expire_after=tmpl.expire_after,
                termination_grace_period=tmpl.termination_grace_period,
            ),
        )

    def to_node_claim(self, requirements: Requirements,
                      instance_types: List[InstanceType],
                      requests: dict) -> NodeClaim:
        """Materialize a launchable NodeClaim, truncating the instance-type
        list to the MAX_INSTANCE_TYPES cheapest (nodeclaimtemplate.go:69-96)."""
        its = order_by_price(instance_types, requirements)[:MAX_INSTANCE_TYPES]
        final = requirements.copy()
        final.add(
            Requirement.new(
                apilabels.LABEL_INSTANCE_TYPE,
                "In",
                [it.name for it in its],
                min_values=requirements.get(apilabels.LABEL_INSTANCE_TYPE).min_values,
            )
        )
        nc = NodeClaim(
            metadata=ObjectMeta(
                name=f"{self.nodepool_name}-{next(_claim_counter):05d}",
                labels=dict(self.labels),
                annotations=dict(self.annotations),
            ),
            spec=NodeClaimSpec(
                requirements=[
                    _to_nsr(r) for r in final.values()
                ],
                resources_requests=dict(requests),
                node_class_ref=self.spec.node_class_ref,
                taints=list(self.taints),
                startup_taints=list(self.startup_taints),
                expire_after=self.spec.expire_after,
                termination_grace_period=self.spec.termination_grace_period,
            ),
        )
        nc.metadata.labels[apilabels.NODEPOOL_LABEL_KEY] = self.nodepool_name
        return nc


def _to_nsr(req) -> NodeSelectorRequirement:
    op = req.operator()
    values: tuple = ()
    if op in ("In", "NotIn"):
        values = tuple(req.sorted_values())
    elif req.greater_than is not None:
        op, values = "Gt", (str(req.greater_than),)
    elif req.less_than is not None:
        op, values = "Lt", (str(req.less_than),)
    return NodeSelectorRequirement(
        key=req.key, operator=op, values=values, min_values=req.min_values
    )


@dataclass
class FilterResults:
    """Pairwise failure-reason bookkeeping (nodeclaim.go:150-246)."""

    remaining: List[InstanceType] = field(default_factory=list)
    requirements_met: bool = False
    fits: bool = False
    has_offering: bool = False
    requirements_and_fits: bool = False
    requirements_and_offering: bool = False
    fits_and_offering: bool = False
    min_values_error: Optional[str] = None

    def failure_reason(self) -> str:
        if self.min_values_error:
            return self.min_values_error
        if not self.requirements_met:
            return "did not meet scheduling requirements"
        if not self.fits:
            return "no instance type has enough resources"
        if not self.has_offering:
            return "no instance type has a compatible available offering"
        if not self.requirements_and_fits:
            return "no instance type which met the scheduling requirements and had enough resources"
        if not self.requirements_and_offering:
            return "no instance type which met the scheduling requirements and had a compatible offering"
        if not self.fits_and_offering:
            return "no instance type which had enough resources and had a compatible offering"
        return "no instance type met the requirements/resources/offering tuple"


def filter_instance_types(
    instance_types: List[InstanceType],
    requirements: Requirements,
    requests: dict,
) -> FilterResults:
    """Keep instance types meeting requirements+fit+offering simultaneously,
    tracking which pairs of criteria were ever met for error reporting
    (nodeclaim.go:248-300)."""
    results = FilterResults()
    for it in instance_types:
        compat = not it.requirements.intersects(requirements)
        it_fits = resutil.fits(requests, it.allocatable())
        has_offering = it.offerings.available().has_compatible(requirements)

        results.requirements_met = results.requirements_met or compat
        results.fits = results.fits or it_fits
        results.has_offering = results.has_offering or has_offering
        results.requirements_and_fits = results.requirements_and_fits or (
            compat and it_fits and not has_offering
        )
        results.requirements_and_offering = results.requirements_and_offering or (
            compat and has_offering and not it_fits
        )
        results.fits_and_offering = results.fits_and_offering or (
            it_fits and has_offering and not compat
        )
        if compat and it_fits and has_offering:
            results.remaining.append(it)

    if requirements.has_min_values():
        _, err = satisfies_min_values(results.remaining, requirements)
        if err is not None:
            results.min_values_error = err
            results.remaining = []
    return results
