"""Unit-test cloud provider double (reference: pkg/cloudprovider/fake/cloudprovider.go:45-66,
fake/instancetype.go:180): records calls, injectable errors, settable
instance types per pool, and a synthetic n-type generator."""
from __future__ import annotations

import itertools
from typing import List, Optional

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.nodeclaim import COND_LAUNCHED, NodeClaim
from karpenter_core_tpu_torch.api.objects import (
    RESOURCE_CPU,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
)
from karpenter_core_tpu_torch.cloudprovider.types import (
    CloudProvider,
    InstanceType,
    InsufficientCapacityError,
    NodeClaimNotFoundError,
    Offering,
    Offerings,
)
from karpenter_core_tpu_torch.scheduling import Requirement, Requirements

GIB = 2.0**30


def fake_instance_types(n: int, zones: Optional[List[str]] = None) -> List[InstanceType]:
    """n synthetic types with exponentially-growing shapes
    (fake/instancetype.go:180)."""
    zones = zones or ["test-zone-1", "test-zone-2", "test-zone-3"]
    out = []
    for i in range(n):
        cpu = 2 ** (i % 8)
        mem = cpu * 4 * GIB
        name = f"fake-it-{i}-{cpu}cpu"
        price = 0.01 * cpu * (1 + 0.1 * (i % 3))
        offerings = Offerings(
            Offering(
                requirements=Requirements(
                    [
                        Requirement.new(apilabels.CAPACITY_TYPE_LABEL_KEY, "In", [ct]),
                        Requirement.new(apilabels.LABEL_TOPOLOGY_ZONE, "In", [z]),
                    ]
                ),
                price=price * (0.7 if ct == apilabels.CAPACITY_TYPE_SPOT else 1.0),
                available=True,
            )
            for z in zones
            for ct in (apilabels.CAPACITY_TYPE_SPOT, apilabels.CAPACITY_TYPE_ON_DEMAND)
        )
        out.append(
            InstanceType(
                name=name,
                requirements=Requirements(
                    [
                        Requirement.new(apilabels.LABEL_INSTANCE_TYPE, "In", [name]),
                        Requirement.new(
                            apilabels.LABEL_ARCH, "In", [apilabels.ARCHITECTURE_AMD64]
                        ),
                        Requirement.new(apilabels.LABEL_OS, "In", ["linux"]),
                        Requirement.new(apilabels.LABEL_TOPOLOGY_ZONE, "In", zones),
                        Requirement.new(
                            apilabels.CAPACITY_TYPE_LABEL_KEY,
                            "In",
                            [
                                apilabels.CAPACITY_TYPE_SPOT,
                                apilabels.CAPACITY_TYPE_ON_DEMAND,
                            ],
                        ),
                    ]
                ),
                offerings=offerings,
                capacity={
                    RESOURCE_CPU: float(cpu),
                    RESOURCE_MEMORY: mem,
                    RESOURCE_PODS: 110.0,
                },
            )
        )
    return out


class FakeCloudProvider(CloudProvider):
    def __init__(
        self,
        instance_types: Optional[List[InstanceType]] = None,
        unavailable_offerings=None,
        clock=None,
    ):
        from karpenter_core_tpu_torch.cloudprovider.unavailableofferings import (
            UnavailableOfferings,
        )

        self.instance_types = instance_types or fake_instance_types(5)
        self.instance_types_for_nodepool: dict = {}
        self.create_calls: list = []
        self.delete_calls: list = []
        self.next_create_error: Optional[Exception] = None
        self.allowed_create_calls: Optional[int] = None
        self.drifted: str = ""
        self._created: dict = {}
        self._counter = itertools.count(1)
        # same stockout/ICE-cache seam as the kwok provider (see kwok.py);
        # `is None` because an empty shared cache is falsy but still shared.
        # Pass the test's fake clock (this provider has no kube to derive
        # one from) or ICE TTLs expire on WALL time under a stepped clock.
        self.stockouts: set = set()
        self.unavailable_offerings = (
            unavailable_offerings
            if unavailable_offerings is not None
            else UnavailableOfferings(clock)
        )

    def get_instance_types(self, nodepool) -> List[InstanceType]:
        name = getattr(nodepool, "name", nodepool)
        return list(self.instance_types_for_nodepool.get(name, self.instance_types))

    def create(self, node_claim: NodeClaim) -> NodeClaim:
        if self.next_create_error is not None:
            err, self.next_create_error = self.next_create_error, None
            raise err
        if (
            self.allowed_create_calls is not None
            and len(self.create_calls) >= self.allowed_create_calls
        ):
            raise RuntimeError("create call limit exceeded")
        self.create_calls.append(node_claim)
        reqs = Requirements.from_node_selector_requirements_with_min_values(
            node_claim.spec.requirements
        )
        it = next(
            (
                t
                for t in self.get_instance_types(node_claim.nodepool_name)
                if not reqs.intersects(t.requirements)
            ),
            None,
        )
        if it is None:
            raise RuntimeError("no compatible instance type")
        candidates = it.offerings.available().compatible(reqs)
        offering = min(
            (
                o
                for o in candidates
                if not self.unavailable_offerings.is_unavailable(o.key(it.name))
            ),
            key=lambda o: o.price,
            default=None,
        )
        if offering is None and candidates:
            # every compatible offering is ICE-cached: the launch must fail
            # like kwok's (no context — they are already cached), not
            # silently succeed with empty zone/capacity-type labels
            raise InsufficientCapacityError(
                f"no available offering for {it.name}"
            )
        if offering is not None and offering.key(it.name) in self.stockouts:
            raise InsufficientCapacityError(
                f"insufficient capacity for {it.name}",
                offerings=[offering.key(it.name)],
            )
        node_claim.status.provider_id = f"fake://{next(self._counter)}"
        node_claim.status.capacity = dict(it.capacity)
        node_claim.status.allocatable = dict(it.allocatable())
        node_claim.metadata.labels.update(
            {
                apilabels.LABEL_INSTANCE_TYPE: it.name,
                apilabels.LABEL_TOPOLOGY_ZONE: offering.zone if offering else "",
                apilabels.CAPACITY_TYPE_LABEL_KEY: offering.capacity_type
                if offering
                else "",
            }
        )
        node_claim.conditions.set_true(COND_LAUNCHED, "Launched")
        self._created[node_claim.status.provider_id] = node_claim
        return node_claim

    def delete(self, node_claim: NodeClaim) -> None:
        self.delete_calls.append(node_claim)
        if node_claim.status.provider_id not in self._created:
            raise NodeClaimNotFoundError(node_claim.status.provider_id)
        del self._created[node_claim.status.provider_id]

    def get(self, provider_id: str) -> NodeClaim:
        if provider_id not in self._created:
            raise NodeClaimNotFoundError(provider_id)
        return self._created[provider_id]

    def list(self) -> List[NodeClaim]:
        return list(self._created.values())

    def is_drifted(self, node_claim: NodeClaim) -> str:
        return self.drifted
