"""NodePool periphery: counter, hash, readiness, validation
(reference: pkg/controllers/nodepool/{counter,hash,readiness,validation}/
controller.go).
"""
from __future__ import annotations

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.labels import HASH_VERSION
from karpenter_core_tpu_torch.api.nodepool import (
    COND_NODEPOOL_NODECLASS_READY,
    COND_NODEPOOL_VALIDATION_SUCCEEDED,
    NodePool,
)
from karpenter_core_tpu_torch.utils import resources as resutil



class Counter:
    """Aggregate in-use resources into NodePool.status.resources — feeds the
    Limits check (counter/controller.go:42-114)."""

    def __init__(self, kube, cluster):
        self.kube = kube
        self.cluster = cluster

    def reconcile(self, pool: NodePool) -> None:
        usage: dict = {"nodes": 0.0}
        for sn in self.cluster.nodes():
            if sn.nodepool_name != pool.name or sn.deleting():
                continue
            usage = resutil.merge(usage, sn.capacity())
            usage["nodes"] += 1.0
        pool.status.resources = usage


class Hash:
    """Maintain the drift hash annotation incl. hash-version migration
    (hash/controller.go:39-124)."""

    def __init__(self, kube):
        self.kube = kube

    def reconcile(self, pool: NodePool) -> None:
        current = pool.static_hash()
        ann = pool.metadata.annotations
        stale_version = (
            ann.get(apilabels.NODEPOOL_HASH_VERSION_ANNOTATION_KEY) != HASH_VERSION
        )
        if ann.get(apilabels.NODEPOOL_HASH_ANNOTATION_KEY) == current and not stale_version:
            return
        if stale_version:
            # hash-version migration: re-stamp claims so a mechanical hash
            # change isn't read as drift. Claims already marked Drifted
            # keep their STALE HASH — the condition reflects a real config
            # difference a re-stamp would erase — but still get the new
            # hash VERSION, or the version gate would mask that real drift
            # from then on (hash/controller.go:102-113 updates the version
            # annotation on drifted claims and skips only the hash)
            for claim in self.kube.list_nodeclaims():
                if claim.nodepool_name != pool.name:
                    continue
                if not claim.conditions.is_true("Drifted"):
                    claim.metadata.annotations[
                        apilabels.NODEPOOL_HASH_ANNOTATION_KEY
                    ] = current
                claim.metadata.annotations[
                    apilabels.NODEPOOL_HASH_VERSION_ANNOTATION_KEY
                ] = HASH_VERSION
        ann[apilabels.NODEPOOL_HASH_ANNOTATION_KEY] = current
        ann[apilabels.NODEPOOL_HASH_VERSION_ANNOTATION_KEY] = HASH_VERSION
        self.kube.update(pool)


class Readiness:
    """NodePool Ready from NodeClass readiness (readiness/controller.go:40-104).
    The kwok/fake providers have no NodeClass objects, so absence of a
    node_class_ref reads as ready."""

    def __init__(self, kube, cloud_provider, clock):
        self.kube = kube
        self.cloud_provider = cloud_provider
        self.clock = clock

    def reconcile(self, pool: NodePool) -> None:
        ref = pool.spec.template.node_class_ref
        supported = getattr(
            self.cloud_provider, "supported_node_classes", lambda: None
        )()
        if ref is None or supported is None:
            pool.conditions.set_true(
                COND_NODEPOOL_NODECLASS_READY, "NodeClassReady",
                now=self.clock.now(),
            )
            return
        if ref.kind in supported:
            pool.conditions.set_true(
                COND_NODEPOOL_NODECLASS_READY, "NodeClassReady",
                now=self.clock.now(),
            )
        else:
            pool.conditions.set_false(
                COND_NODEPOOL_NODECLASS_READY,
                "NodeClassNotSupported",
                f"node class {ref.kind!r} not supported by provider",
                now=self.clock.now(),
            )


class Validation:
    """Runtime validation -> Ready=false (validation/controller.go:37-77)."""

    def __init__(self, kube, clock):
        self.kube = kube
        self.clock = clock

    def reconcile(self, pool: NodePool) -> None:
        errs = []
        for taint in pool.spec.template.taints:
            if not taint.key:
                errs.append("taint with empty key")
        for r in pool.spec.template.requirements:
            if r.operator in ("In", "NotIn") and not r.values:
                errs.append(f"requirement {r.key} has operator {r.operator} with no values")
            if r.operator in ("Gt", "Lt"):
                try:
                    int(r.values[0])
                except (IndexError, ValueError):
                    errs.append(f"requirement {r.key} {r.operator} needs one integer value")
            if apilabels.is_restricted_label(r.key):
                errs.append(f"requirement on restricted label {r.key}")
        for key in pool.spec.template.labels:
            if apilabels.is_restricted_label(key):
                errs.append(f"restricted label {key}")
        for budget in pool.spec.disruption.budgets:
            if budget.schedule is not None and budget.duration is None:
                errs.append("budget schedule requires a duration")
        if errs:
            pool.conditions.set_false(
                COND_NODEPOOL_VALIDATION_SUCCEEDED,
                "ValidationFailed",
                "; ".join(errs),
                now=self.clock.now(),
            )
        else:
            pool.conditions.set_true(
                COND_NODEPOOL_VALIDATION_SUCCEEDED, "ValidationSucceeded",
                now=self.clock.now(),
            )

    def is_ready(self, pool: NodePool) -> bool:
        return not pool.conditions.is_false(COND_NODEPOOL_VALIDATION_SUCCEEDED)
