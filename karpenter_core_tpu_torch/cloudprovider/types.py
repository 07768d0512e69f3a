"""Cloud-provider abstraction (reference: pkg/cloudprovider/types.go:56-399).

InstanceType is the unit the solver tensorizes: its Requirements become mask
rows over the solve vocabulary, Capacity/Overhead become the allocatable
matrix, and the Offering lattice becomes the price/availability tensors.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, NamedTuple, Optional

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.nodeclaim import NodeClaim
from karpenter_core_tpu_torch.api.objects import ResourceList
from karpenter_core_tpu_torch.scheduling import Requirements
from karpenter_core_tpu_torch.utils import resources as resutil


class OfferingKey(NamedTuple):
    """The identity of one purchase option: the instance-type × zone ×
    capacity-type triple a capacity stockout names. A plain tuple subclass,
    so wire-decoded ``(it, zone, ct)`` tuples compare equal."""

    instance_type: str
    zone: str
    capacity_type: str


@dataclass
class Offering:
    """A (zone, capacity-type) purchase option (types.go:244-252)."""

    requirements: Requirements
    price: float
    available: bool = True

    def key(self, instance_type: str) -> OfferingKey:
        return OfferingKey(instance_type, self.zone, self.capacity_type)

    @property
    def zone(self) -> str:
        req = self.requirements.get(apilabels.LABEL_TOPOLOGY_ZONE)
        values = req.sorted_values()
        return values[0] if values else ""

    @property
    def capacity_type(self) -> str:
        req = self.requirements.get(apilabels.CAPACITY_TYPE_LABEL_KEY)
        values = req.sorted_values()
        return values[0] if values else ""


class Offerings(list):
    """list[Offering] with the reference's filter/selector helpers
    (types.go:256-310)."""

    def available(self) -> "Offerings":
        return Offerings(o for o in self if o.available)

    def compatible(self, reqs: Requirements) -> "Offerings":
        return Offerings(
            o for o in self if not reqs.intersects(o.requirements)
        )

    def has_compatible(self, reqs: Requirements) -> bool:
        return any(not reqs.intersects(o.requirements) for o in self)

    def cheapest(self) -> Optional[Offering]:
        return min(self, key=lambda o: o.price, default=None)

    def most_expensive(self) -> Optional[Offering]:
        return max(self, key=lambda o: o.price, default=None)

    def worst_launch_price(self, reqs: Requirements) -> float:
        """Most expensive offering that could be launched under reqs — the
        price bound used by consolidation (types.go:294-310)."""
        compatible = self.compatible(reqs)
        o = compatible.most_expensive()
        return o.price if o else 0.0


@dataclass
class InstanceType:
    """types.go:86-115. allocatable = capacity - overhead, cached."""

    name: str
    requirements: Requirements
    offerings: Offerings
    capacity: ResourceList
    overhead: ResourceList = field(default_factory=dict)
    _allocatable: Optional[ResourceList] = field(default=None, repr=False)

    def allocatable(self) -> ResourceList:
        if self._allocatable is None:
            self._allocatable = resutil.subtract(self.capacity, self.overhead)
        return self._allocatable


def order_by_price(
    instance_types: Iterable[InstanceType], reqs: Requirements
) -> List[InstanceType]:
    """Sort by the cheapest compatible+available offering price
    (types.go:117-134)."""

    def price(it: InstanceType) -> float:
        o = it.offerings.available().compatible(reqs).cheapest()
        return o.price if o else float("inf")

    return sorted(instance_types, key=price)


def satisfies_min_values(
    instance_types: Iterable[InstanceType], reqs: Requirements
) -> "tuple[int, Optional[str]]":
    """Check every MinValues requirement is satisfiable across the instance
    types jointly; returns (max needed count, error) (types.go:178-212)."""
    needed = 0
    err = None
    for key, req in reqs.items():
        if req.min_values is None:
            continue
        distinct = set()
        for it in instance_types:
            it_req = it.requirements.get(key)
            if it_req.operator() == "In":
                distinct.update(
                    v for v in it_req.sorted_values() if req.has(v)
                )
        if len(distinct) < req.min_values:
            err = (
                f"minValues requirement is not met for label {key} "
                f"(found {len(distinct)}, need {req.min_values})"
            )
        needed = max(needed, req.min_values)
    return needed, err


def truncate_instance_types(
    instance_types: List[InstanceType], reqs: Requirements, max_items: int
) -> "tuple[List[InstanceType], Optional[str]]":
    """Truncate a price-ordered list while preserving minValues feasibility
    (types.go:216-240)."""
    truncated = instance_types[:max_items]
    if Requirements(reqs.values()).has_min_values():
        _, err = satisfies_min_values(truncated, reqs)
        if err:
            return instance_types, err
    return truncated, None


def apply_unavailable(
    instance_types: Dict[str, List[InstanceType]],
    unavailable: "frozenset[OfferingKey] | set",
) -> Dict[str, List[InstanceType]]:
    """Project an unavailable-offerings set onto per-pool catalogs: instance
    types with a hit get a shallow copy whose stocked-out offerings are
    marked ``available=False``; untouched types keep their identity, and
    objects shared across pools stay shared (the catalog-union dedupe and
    the wire codec's identity table both key on ``id``)."""
    if not unavailable:
        return instance_types
    memo: Dict[int, InstanceType] = {}

    def one(it: InstanceType) -> InstanceType:
        got = memo.get(id(it))
        if got is None:
            hit = any(
                o.available and o.key(it.name) in unavailable
                for o in it.offerings
            )
            if hit:
                got = InstanceType(
                    name=it.name,
                    requirements=it.requirements,
                    offerings=Offerings(
                        Offering(
                            requirements=o.requirements,
                            price=o.price,
                            available=o.available
                            and o.key(it.name) not in unavailable,
                        )
                        for o in it.offerings
                    ),
                    capacity=it.capacity,
                    overhead=it.overhead,
                )
            else:
                got = it
            memo[id(it)] = got
        return got

    return {pool: [one(it) for it in its] for pool, its in instance_types.items()}


# -- typed errors (types.go:312-399) ----------------------------------------

class CloudProviderError(Exception):
    pass


class NodeClaimNotFoundError(CloudProviderError):
    pass


class InsufficientCapacityError(CloudProviderError):
    """A launch failed because capacity was stocked out. ``offerings``
    carries the OfferingKeys the provider observed unavailable so the
    control plane can mark them in its UnavailableOfferings cache (the
    reference's AWS provider attaches the same context to its ICE cache,
    pkg/cache/unavailableofferings.go) instead of re-solving onto the
    identical stocked-out offering and livelocking."""

    def __init__(self, message: str, offerings: Iterable[OfferingKey] = ()):
        super().__init__(message)
        self.offerings = tuple(offerings)


class NodeClassNotReadyError(CloudProviderError):
    pass


class CreateError(CloudProviderError):
    def __init__(self, message: str, condition_reason: str = "", condition_message: str = ""):
        super().__init__(message)
        self.condition_reason = condition_reason
        self.condition_message = condition_message


@dataclass
class RepairPolicy:
    condition_type: str
    condition_status: str
    toleration_duration: float  # seconds


class CloudProvider(abc.ABC):
    """The provider interface (types.go:56-82)."""

    @abc.abstractmethod
    def create(self, node_claim: NodeClaim) -> NodeClaim:
        """Launch capacity; returns hydrated claim with provider_id, capacity,
        resolved instance-type labels."""

    @abc.abstractmethod
    def delete(self, node_claim: NodeClaim) -> None:
        ...

    @abc.abstractmethod
    def get(self, provider_id: str) -> NodeClaim:
        ...

    @abc.abstractmethod
    def list(self) -> List[NodeClaim]:
        ...

    @abc.abstractmethod
    def get_instance_types(self, nodepool) -> List[InstanceType]:
        ...

    @abc.abstractmethod
    def is_drifted(self, node_claim: NodeClaim) -> str:
        """Returns a drift reason or ''."""

    def repair_policies(self) -> List[RepairPolicy]:
        return []

    @property
    def name(self) -> str:
        return type(self).__name__.lower()
