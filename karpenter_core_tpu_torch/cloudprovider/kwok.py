"""KWOK-style fake cloud provider — the scale-bench harness.

Mirrors the reference's in-tree kwok provider: Create materializes a fake
Node object directly in the (in-memory) apiserver with the unregistered
taint, picking the cheapest compatible offering (reference:
kwok/cloudprovider/cloudprovider.go:53-64,143-191); the instance catalog is
generated as families {c,s,m} × cpu grid × os × arch with 4 zones ×
{spot, on-demand} offerings and price linear in cpu+mem, spot = 0.7×OD
(reference: kwok/tools/gen_instance_types.go:36-115).
"""
from __future__ import annotations

import itertools
from typing import List, Optional

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.nodeclaim import (
    COND_LAUNCHED,
    NodeClaim,
)
from karpenter_core_tpu_torch.api.objects import (
    Node,
    NodeStatus,
    ObjectMeta,
    RESOURCE_CPU,
    RESOURCE_EPHEMERAL_STORAGE,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
    Taint,
)
from karpenter_core_tpu_torch.cloudprovider.types import (
    CloudProvider,
    InsufficientCapacityError,
    InstanceType,
    NodeClaimNotFoundError,
    Offering,
    Offerings,
)
from karpenter_core_tpu_torch.scheduling import Requirement, Requirements
from karpenter_core_tpu_torch.scheduling.taints import UNREGISTERED_NO_EXECUTE_TAINT

KWOK_ZONES = ["zone-a", "zone-b", "zone-c", "zone-d"]
DEFAULT_CPU_GRID = [1, 2, 4, 8, 16, 32, 48, 64, 96, 128, 192, 256]
MEM_FACTORS = {2: "c", 4: "s", 8: "m"}  # GiB per cpu -> family

GIB = 2.0**30


def build_catalog(
    cpu_grid: Optional[List[int]] = None,
    mem_factors: Optional[List[int]] = None,
    oses: Optional[List[str]] = None,
    arches: Optional[List[str]] = None,
    zones: Optional[List[str]] = None,
) -> List[InstanceType]:
    """Generate the synthetic instance catalog. Defaults give the reference's
    144 types (12 cpu × 3 families × 2 os × 2 arch); widen the grids to reach
    the ~800-type bench catalog (BASELINE.md)."""
    cpu_grid = cpu_grid or DEFAULT_CPU_GRID
    mem_factors = mem_factors or list(MEM_FACTORS)
    oses = oses or ["linux", "windows"]
    arches = arches or [apilabels.ARCHITECTURE_AMD64, apilabels.ARCHITECTURE_ARM64]
    zones = zones or KWOK_ZONES

    out = []
    for cpu, mem_factor, os_name, arch in itertools.product(
        cpu_grid, mem_factors, oses, arches
    ):
        family = MEM_FACTORS.get(mem_factor, "e")
        name = f"{family}-{cpu}x-{arch}-{os_name}"
        mem_gib = cpu * mem_factor
        pods = min(cpu * 16, 1024)
        capacity = {
            RESOURCE_CPU: float(cpu),
            RESOURCE_MEMORY: mem_gib * GIB,
            RESOURCE_PODS: float(pods),
            RESOURCE_EPHEMERAL_STORAGE: 20 * GIB,
        }
        price = 0.025 * cpu + 0.001 * (mem_gib * GIB) / 1e9
        offerings = Offerings()
        for zone in zones:
            for ct in (apilabels.CAPACITY_TYPE_SPOT, apilabels.CAPACITY_TYPE_ON_DEMAND):
                offerings.append(
                    Offering(
                        requirements=Requirements(
                            [
                                Requirement.new(
                                    apilabels.CAPACITY_TYPE_LABEL_KEY, "In", [ct]
                                ),
                                Requirement.new(
                                    apilabels.LABEL_TOPOLOGY_ZONE, "In", [zone]
                                ),
                            ]
                        ),
                        price=price * 0.7 if ct == apilabels.CAPACITY_TYPE_SPOT else price,
                        available=True,
                    )
                )
        requirements = Requirements(
            [
                Requirement.new(apilabels.LABEL_INSTANCE_TYPE, "In", [name]),
                Requirement.new(apilabels.LABEL_ARCH, "In", [arch]),
                Requirement.new(apilabels.LABEL_OS, "In", [os_name]),
                Requirement.new(
                    apilabels.LABEL_TOPOLOGY_ZONE, "In", list(zones)
                ),
                Requirement.new(
                    apilabels.CAPACITY_TYPE_LABEL_KEY,
                    "In",
                    [apilabels.CAPACITY_TYPE_SPOT, apilabels.CAPACITY_TYPE_ON_DEMAND],
                ),
                Requirement.new("karpenter.kwok.sh/instance-size", "In", [f"{cpu}x"]),
                Requirement.new("karpenter.kwok.sh/instance-family", "In", [family]),
                Requirement.new(
                    "karpenter.kwok.sh/instance-cpu", "In", [str(cpu)]
                ),
                Requirement.new(
                    "karpenter.kwok.sh/instance-memory", "In", [str(mem_gib)]
                ),
            ]
        )
        out.append(
            InstanceType(
                name=name,
                requirements=requirements,
                offerings=offerings,
                capacity=capacity,
                overhead={RESOURCE_CPU: 0.1, RESOURCE_MEMORY: 0.2 * GIB},
            )
        )
    return out


def bench_catalog(n_target: int = 800) -> List[InstanceType]:
    """A widened catalog of ~n_target types for the 50k-pod benchmark
    (BASELINE.md: 'extensible to ~800')."""
    cpu_grid = sorted(set(list(range(1, 49)) + DEFAULT_CPU_GRID))
    mem_factors = [2, 4, 8, 16]
    catalog = build_catalog(cpu_grid=cpu_grid, mem_factors=mem_factors)
    return catalog[:n_target]


class KwokCloudProvider(CloudProvider):
    """Fake provider backed by the in-memory kube store."""

    def __init__(
        self,
        kube,
        instance_types: Optional[List[InstanceType]] = None,
        unavailable_offerings=None,
        rack_size: int = 0,
    ):
        from karpenter_core_tpu_torch.cloudprovider.unavailableofferings import (
            UnavailableOfferings,
        )
        from karpenter_core_tpu_torch.utils.clock import Clock

        self.kube = kube
        # KubeClient implementations other than the in-memory store carry no
        # clock; condition stamping falls back to wall time
        self.clock = getattr(kube, "clock", None) or Clock()
        self.instance_types = instance_types or build_catalog()
        self._by_name = {it.name: it for it in self.instance_types}
        self._counter = itertools.count(1)
        # rack topology stamping (topoaware, ISSUE 20), OFF by default so
        # existing catalogs stay rack-less and the topo layer disengaged:
        # rack_size >= 1 assigns each created node a deterministic rack
        # (racks of rack_size nodes per zone, filled in creation order)
        # and superpod (two racks per superpod) label — the synthetic
        # stand-in for a real provider's physical-placement attribution
        self.rack_size = rack_size
        self._zone_seq: dict = {}
        self.allow_insufficient_capacity = False
        # ground-truth capacity stockouts: OfferingKeys create cannot fill.
        # Tests / the chaos harness's ICE storms write this set; create
        # raises a typed ICE (with the offering context) when its pick is in
        # it — the seam the UnavailableOfferings cache learns from.
        self.stockouts: set = set()
        # shared ICE cache (the AWS provider consults the same cache in its
        # own CreateFleet path): create skips offerings already known
        # unavailable so a claim whose requirements still admit them cannot
        # livelock through the identical stockout inside the TTL.
        # `is None`, not truthiness — an EMPTY cache passed by the operator
        # is falsy (len 0) but must be adopted, or lifecycle marks a
        # different cache than this create path consults
        self.unavailable_offerings = (
            unavailable_offerings
            if unavailable_offerings is not None
            else UnavailableOfferings(self.clock)
        )

    def get_instance_types(self, nodepool) -> List[InstanceType]:
        return list(self.instance_types)

    def create(self, node_claim: NodeClaim) -> NodeClaim:
        reqs = Requirements.from_node_selector_requirements_with_min_values(
            node_claim.spec.requirements
        )
        # pick cheapest compatible instance type + offering
        # (kwok cloudprovider.go:143-191), skipping offerings the shared ICE
        # cache already knows are stocked out — the fleet-request analogue of
        # the AWS provider excluding cached-unavailable pools
        best = None
        for it in self.instance_types:
            if reqs.intersects(it.requirements):
                continue
            for offering in it.offerings.available().compatible(reqs):
                if self.unavailable_offerings.is_unavailable(
                    offering.key(it.name)
                ):
                    continue
                if best is None or offering.price < best[1].price:
                    best = (it, offering)
        if best is None:
            raise InsufficientCapacityError(
                f"no compatible instance type for {node_claim.name}"
            )
        it, offering = best
        key = offering.key(it.name)
        if key in self.stockouts:
            # actual capacity is out: fail the launch NAMING the offering,
            # so lifecycle can mark it unavailable and the re-solve lands on
            # the next-cheapest available one instead of repeating this pick
            raise InsufficientCapacityError(
                f"insufficient capacity for {key.instance_type} in "
                f"{key.zone} ({key.capacity_type})",
                offerings=[key],
            )
        seq = next(self._counter)
        provider_id = f"kwok://{node_claim.name}-{seq}"
        node_claim.status.provider_id = provider_id
        node_claim.status.capacity = dict(it.capacity)
        node_claim.status.allocatable = dict(it.allocatable())
        node_claim.status.image_id = "kwok-ami"
        labels = dict(node_claim.metadata.labels)
        # derived single-value requirement labels — including well-known keys
        # like region that only the provider may inject (reference kwok
        # addInstanceLabels, cloudprovider.go:200-205)
        for req in node_claim.spec.requirements:
            if req.operator == "In" and len(req.values) == 1:
                labels[req.key] = req.values[0]
        labels.update(
            {
                apilabels.LABEL_INSTANCE_TYPE: it.name,
                apilabels.LABEL_ARCH: it.requirements.get(apilabels.LABEL_ARCH).any_value(),
                apilabels.LABEL_OS: it.requirements.get(apilabels.LABEL_OS).any_value(),
                apilabels.LABEL_TOPOLOGY_ZONE: offering.zone,
                apilabels.CAPACITY_TYPE_LABEL_KEY: offering.capacity_type,
            }
        )
        if self.rack_size > 0:
            n = self._zone_seq.get(offering.zone, 0)
            self._zone_seq[offering.zone] = n + 1
            rack = n // self.rack_size
            labels[apilabels.LABEL_TOPOLOGY_RACK] = (
                f"{offering.zone}-r{rack}"
            )
            labels[apilabels.LABEL_TOPOLOGY_SUPERPOD] = (
                f"{offering.zone}-s{rack // 2}"
            )
        node_claim.metadata.labels = labels
        node_claim.conditions.set_true(
            COND_LAUNCHED, "Launched", now=self.clock.now()
        )

        # Materialize the fake Node with the unregistered taint; the
        # registration controller adopts it (kwok cloudprovider.go:53-64).
        node = Node(
            metadata=ObjectMeta(
                name=node_claim.name,
                labels=dict(labels),
            ),
            provider_id=provider_id,
            taints=[UNREGISTERED_NO_EXECUTE_TAINT],
            status=NodeStatus(
                capacity=dict(it.capacity),
                allocatable=dict(it.allocatable()),
                conditions=[("Ready", "True")],
            ),
        )
        self.kube.create(node)
        return node_claim

    def delete(self, node_claim: NodeClaim) -> None:
        node = self.kube.get_node_by_provider_id(node_claim.status.provider_id)
        if node is None:
            raise NodeClaimNotFoundError(node_claim.status.provider_id)
        self.kube.delete(node)

    def get(self, provider_id: str) -> NodeClaim:
        node = self.kube.get_node_by_provider_id(provider_id)
        if node is None:
            raise NodeClaimNotFoundError(provider_id)
        nc = NodeClaim()
        nc.metadata.name = node.name
        nc.metadata.labels = dict(node.labels)
        nc.status.provider_id = provider_id
        nc.status.capacity = dict(node.status.capacity)
        return nc

    def list(self) -> List[NodeClaim]:
        return [
            self.get(n.provider_id)
            for n in self.kube.list_nodes()
            if n.provider_id.startswith("kwok://")
        ]

    def is_drifted(self, node_claim: NodeClaim) -> str:
        return ""

    @property
    def name(self) -> str:
        return "kwok"
