"""UnavailableOfferings: the control plane's ICE cache.

The reference's AWS provider keeps a TTL'd cache of offerings that returned
InsufficientCapacityError so the next launch (and the next solve) skips
them (pkg/cache/unavailableofferings.go; the 3-minute TTL is its
UnavailableOfferingsTTL). Here the cache is a core object shared by three
consumers:

* the NodeClaim lifecycle controller MARKS offerings from the typed
  ``InsufficientCapacityError.offerings`` context when a launch fails;
* both solve paths CONSUME the snapshot — the greedy scheduler filters
  offering availability, the device solver masks its offerings tensor
  (and the solverd sidecar receives the same set over the wire);
* the cloud provider's create path SKIPS cached offerings when picking,
  so a claim whose requirement lattice still admits a stocked-out offering
  cannot re-pick it inside the TTL (the create→ICE→delete livelock).

Entries expire on read against the injected clock, so fake-clock tests can
elapse the TTL deterministically and watch the offering return to service.
"""
from __future__ import annotations

from typing import Dict, Optional

from karpenter_core_tpu_torch.cloudprovider.types import OfferingKey

# the reference AWS provider's UnavailableOfferingsTTL (3 minutes): long
# enough to ride out a stockout, short enough that capacity returning to a
# zone is picked back up without an operator restart
UNAVAILABLE_OFFERINGS_TTL = 180.0


class UnavailableOfferings:
    def __init__(self, clock=None, ttl: float = UNAVAILABLE_OFFERINGS_TTL):
        from karpenter_core_tpu_torch.utils.clock import Clock

        self.clock = clock or Clock()
        self.ttl = ttl
        self._expiry: Dict[OfferingKey, float] = {}

    # -- writes ------------------------------------------------------------

    def mark(self, key, ttl: Optional[float] = None) -> None:
        """Record one stocked-out offering; re-marking refreshes the TTL."""
        key = OfferingKey(*key)
        self._expiry[key] = self.clock.now() + (ttl if ttl is not None else self.ttl)
        self._export()

    # -- reads -------------------------------------------------------------

    def is_unavailable(self, key) -> bool:
        self._expire()
        return OfferingKey(*key) in self._expiry

    def snapshot(self) -> "frozenset[OfferingKey]":
        """The live (unexpired) unavailable set — what a solve consumes."""
        self._expire()
        return frozenset(self._expiry)

    def __len__(self) -> int:
        self._expire()
        return len(self._expiry)

    # -- internals ---------------------------------------------------------

    def _expire(self) -> None:
        now = self.clock.now()
        stale = [k for k, t in self._expiry.items() if t <= now]
        if stale:
            for k in stale:
                del self._expiry[k]
            self._export()

    def _export(self) -> None:
        from karpenter_core_tpu_torch.metrics import wiring as m

        m.UNAVAILABLE_OFFERINGS_COUNT.set(float(len(self._expiry)))
