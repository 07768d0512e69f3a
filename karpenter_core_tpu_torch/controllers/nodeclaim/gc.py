"""NodeClaim periphery: expiration, garbage collection, consistency
(reference: pkg/controllers/nodeclaim/{expiration,garbagecollection,
consistency}/controller.go).
"""
from __future__ import annotations

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.nodeclaim import (
    COND_CONSISTENT_STATE_FOUND,
    NodeClaim,
)
from karpenter_core_tpu_torch.api.objects import Node
from karpenter_core_tpu_torch.cloudprovider.types import NodeClaimNotFoundError
from karpenter_core_tpu_torch.events import Event
from karpenter_core_tpu_torch.utils import resources as resutil


class Expiration:
    """Forceful deletion of claims past expireAfter
    (expiration/controller.go:54-70)."""

    def __init__(self, kube, clock):
        self.kube = kube
        self.clock = clock

    def reconcile(self, claim: NodeClaim) -> None:
        if claim.metadata.deletion_timestamp is not None:
            return
        expire = claim.spec.expire_after.seconds
        if expire is None:
            return
        if self.clock.since(claim.metadata.creation_timestamp) >= expire:
            self.kube.delete(claim)


class GarbageCollection:
    """Reconcile cloud<->cluster drift in both directions: claims whose
    instance vanished are deleted; instances without a claim are terminated
    (garbagecollection/controller.go:59-116, 2-minute sweep)."""

    SWEEP_INTERVAL = 120.0

    def __init__(self, kube, cloud_provider, clock):
        self.kube = kube
        self.cloud_provider = cloud_provider
        self.clock = clock
        self._last_sweep: float = float("-inf")

    def reconcile(self) -> None:
        # interval-gated sweep, like the reference's 2-minute singleton
        if self.clock.now() - self._last_sweep < self.SWEEP_INTERVAL:
            return
        self._last_sweep = self.clock.now()
        claims = self.kube.list_nodeclaims()
        claimed_ids = {
            c.status.provider_id for c in claims if c.status.provider_id
        }
        cloud_claims = self.cloud_provider.list()
        live_ids = {
            cc.status.provider_id for cc in cloud_claims if cc.status.provider_id
        }
        # direction 1: claims pointing at vanished instances
        for claim in claims:
            if not claim.is_launched() or not claim.status.provider_id:
                continue
            if claim.metadata.deletion_timestamp is not None:
                continue
            if claim.status.provider_id not in live_ids:
                self.kube.delete(claim)
        # direction 2: cloud instances with no claim (leaked)
        for cloud_claim in cloud_claims:
            pid = cloud_claim.status.provider_id
            if pid and pid not in claimed_ids:
                try:
                    self.cloud_provider.delete(cloud_claim)
                except NodeClaimNotFoundError:
                    pass


class Consistency:
    """Scan for node<->claim invariant violations, e.g. a node whose
    registered capacity shrank below the claim's promise
    (consistency/controller.go:62-146, 10-minute scan)."""

    def __init__(self, kube, recorder, clock):
        self.kube = kube
        self.recorder = recorder
        self.clock = clock

    def reconcile(self, claim: NodeClaim) -> None:
        if not claim.is_registered() or not claim.status.node_name:
            return
        node = self.kube.get(Node, claim.status.node_name)
        if node is None:
            return
        failures = []
        # the node must expose at least the resources the claim promised
        for name, qty in claim.status.capacity.items():
            have = node.status.capacity.get(name, 0.0)
            if have < qty * (1.0 - 1e-9):
                failures.append(
                    f"expected {qty:g} of resource {name}, but found {have:g} "
                    f"({have / qty * 100.0:.1f}% of expected)"
                )
        if failures:
            for msg in failures:
                self.recorder.publish(
                    Event(
                        involved_object=f"NodeClaim/{claim.name}",
                        type="Warning",
                        reason="FailedConsistencyCheck",
                        message=msg,
                    )
                )
            claim.conditions.set_false(
                COND_CONSISTENT_STATE_FOUND,
                "ConsistencyCheckFailed",
                "; ".join(failures),
                now=self.clock.now(),
            )
        else:
            claim.conditions.set_true(
                COND_CONSISTENT_STATE_FOUND, "ConsistentStateFound",
                now=self.clock.now(),
            )
