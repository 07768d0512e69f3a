"""NodeClaim disruption conditions: Consolidatable and Drifted, plus the
pod-event timestamping that drives consolidateAfter
(reference: pkg/controllers/nodeclaim/disruption/{consolidation,drift}.go,
podevents/controller.go:41-99).
"""
from __future__ import annotations

from typing import Optional

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.nodeclaim import (
    COND_CONSOLIDATABLE,
    COND_DRIFTED,
    COND_INITIALIZED,
    NodeClaim,
)
from karpenter_core_tpu_torch.api.nodepool import NodePool
from karpenter_core_tpu_torch.scheduling import Requirements

POD_EVENT_DEDUPE = 5.0  # podevents/controller.go 5s dedupe
DRIFT_REASON_NODEPOOL_STATIC = "NodePoolDrifted"
DRIFT_REASON_REQUIREMENTS = "RequirementsDrifted"
DRIFT_REASON_IT_GONE = "InstanceTypeNotFound"


class NodeClaimDisruption:
    def __init__(self, kube, cloud_provider, clock):
        self.kube = kube
        self.cloud_provider = cloud_provider
        self.clock = clock

    def reconcile(self, claim: NodeClaim) -> None:
        if claim.metadata.deletion_timestamp is not None:
            return
        pool = self.kube.get(NodePool, claim.nodepool_name)
        if pool is None:
            return
        self._reconcile_consolidatable(pool, claim)
        self._reconcile_drifted(pool, claim)

    # -- Consolidatable (nodeclaim/disruption/consolidation.go:40-78) ------

    def _reconcile_consolidatable(self, pool: NodePool, claim: NodeClaim) -> None:
        consolidate_after = pool.spec.disruption.consolidate_after.seconds
        if consolidate_after is None:  # Never
            claim.conditions.clear(COND_CONSOLIDATABLE)
            return
        init = claim.conditions.get(COND_INITIALIZED)
        if init is None or not claim.is_initialized():
            claim.conditions.clear(COND_CONSOLIDATABLE)
            return
        t = claim.status.last_pod_event_time or init.last_transition_time
        if self.clock.since(t) < consolidate_after:
            claim.conditions.clear(COND_CONSOLIDATABLE)
            return
        claim.conditions.set_true(COND_CONSOLIDATABLE, "Consolidatable", now=self.clock.now())

    # -- Drifted (nodeclaim/disruption/drift.go:55-120) --------------------

    def _reconcile_drifted(self, pool: NodePool, claim: NodeClaim) -> None:
        if not claim.is_launched():
            return
        reason = self._drift_reason(pool, claim)
        if reason:
            claim.conditions.set_true(COND_DRIFTED, reason, now=self.clock.now())
        else:
            claim.conditions.clear(COND_DRIFTED)

    def _drift_reason(self, pool: NodePool, claim: NodeClaim) -> Optional[str]:
        # static hash drift (drift.go areStaticFieldsDrifted): annotation vs
        # annotation, gated — missing hash on either side or a hash-VERSION
        # mismatch is NOT drift (the hash controller migrates versions by
        # re-stamping claims, hash/controller.go:70-124)
        pool_hash = pool.metadata.annotations.get(
            apilabels.NODEPOOL_HASH_ANNOTATION_KEY
        )
        claim_hash = claim.metadata.annotations.get(
            apilabels.NODEPOOL_HASH_ANNOTATION_KEY
        )
        pool_ver = pool.metadata.annotations.get(
            apilabels.NODEPOOL_HASH_VERSION_ANNOTATION_KEY
        )
        claim_ver = claim.metadata.annotations.get(
            apilabels.NODEPOOL_HASH_VERSION_ANNOTATION_KEY
        )
        if (
            pool_hash is not None
            and claim_hash is not None
            and pool_ver == claim_ver
            and claim_hash != pool_hash
        ):
            return DRIFT_REASON_NODEPOOL_STATIC
        # requirements drift: the claim's committed labels must still satisfy
        # the pool's requirements (drift.go:144-154 uses Compatible, whose
        # undefined-key rule also drifts claims when the pool adds a
        # requirement on a key the claim's labels never defined)
        pool_reqs = Requirements.from_node_selector_requirements_with_min_values(
            pool.spec.template.requirements
        )
        claim_labels = Requirements.from_labels(claim.metadata.labels)
        if claim_labels.compatible(pool_reqs):
            return DRIFT_REASON_REQUIREMENTS
        # stale instance type: vanished from the catalog, or none of its
        # remaining offerings is available+compatible with the claim's
        # committed zone/capacity-type (drift.go instanceTypeNotFound family)
        it_name = claim.metadata.labels.get(apilabels.LABEL_INSTANCE_TYPE)
        if it_name is not None:
            it = next(
                (
                    i
                    for i in self.cloud_provider.get_instance_types(pool)
                    if i.name == it_name
                ),
                None,
            )
            if it is None:
                return DRIFT_REASON_IT_GONE
            if not it.offerings.available().has_compatible(claim_labels):
                return DRIFT_REASON_IT_GONE
        return self.cloud_provider.is_drifted(claim) or None


class PodEvents:
    """Stamps NodeClaim.status.last_pod_event_time on pod churn
    (podevents/controller.go:41-99)."""

    def __init__(self, kube, cluster, clock):
        self.kube = kube
        self.cluster = cluster
        self.clock = clock
        kube.watch(self._on_event)

    def _on_event(self, event: str, kind: str, obj) -> None:
        if kind != "Pod":
            return
        node_name = getattr(obj, "node_name", "")
        if not node_name:
            return
        for claim in self.kube.list_nodeclaims():
            if claim.status.node_name == node_name:
                now = self.clock.now()
                last = claim.status.last_pod_event_time
                if last is None or now - last >= POD_EVENT_DEDUPE:
                    claim.status.last_pod_event_time = now
                break
