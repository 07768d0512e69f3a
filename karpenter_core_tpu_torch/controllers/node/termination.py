"""Node graceful teardown: taint → drain → instance terminated → finalizer
removed (reference: pkg/controllers/node/termination/controller.go:67-176,
terminator/terminator.go:55-165).
"""
from __future__ import annotations

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.objects import Node
from karpenter_core_tpu_torch.cloudprovider.types import NodeClaimNotFoundError
from karpenter_core_tpu_torch.kube.store import (
    ConflictError,
    NotFoundError,
    TooManyRequestsError,
)
from karpenter_core_tpu_torch.scheduling.taints import DISRUPTED_NO_SCHEDULE_TAINT
from karpenter_core_tpu_torch.utils import pod as podutil

_CRITICAL_PRIORITY_CLASSES = ("system-cluster-critical", "system-node-critical")

# per-pod eviction retry backoff, the eviction queue's
# ItemExponentialFailureRateLimiter curve (terminator/eviction.go:95,
# orchestration/queue.go:50-54): 1s doubling to a 10s ceiling
EVICT_BACKOFF_BASE = 1.0
EVICT_BACKOFF_CAP = 10.0


def _is_critical(pod) -> bool:
    return pod.priority_class_name in _CRITICAL_PRIORITY_CLASSES


class NodeTermination:
    def __init__(self, kube, cluster, cloud_provider, clock, recorder=None):
        self.kube = kube
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.recorder = recorder
        # pod key -> (not-before time, current delay); entries drop on
        # success so a repeatedly PDB-blocked (429) pod retries at 1, 2, 4,
        # 8, 10, 10... seconds instead of hammering the apiserver every pass
        self._evict_backoff: dict = {}

    def backoff_wait_remaining(self) -> float:
        """Seconds until the nearest eviction retry unblocks (0 when none);
        lets a fake-clock driver elapse the backoff instead of idling."""
        now = self.clock.now()
        waits = [nb - now for nb, _ in self._evict_backoff.values() if nb > now]
        return min(waits) if waits else 0.0

    def reconcile(self, node: Node) -> None:
        # a stale-resource_version conflict on any of the node/claim writes
        # below is an expected optimistic-lock race (another controller got
        # there first), not a crash: drop this pass and retry against the
        # fresh object next reconcile — the controller-runtime conflict
        # requeue, consistent with the operator's isolation wrapper (which
        # would otherwise count it as a reconcile error and back off)
        try:
            self._reconcile(node)
        except ConflictError:
            return

    def _reconcile(self, node: Node) -> None:
        if node.metadata.deletion_timestamp is None:
            return
        if apilabels.TERMINATION_FINALIZER not in node.metadata.finalizers:
            return
        # bound the backoff map: pods force-deleted mid-backoff (TGP) would
        # otherwise leave entries forever
        if len(self._evict_backoff) > 256:
            live = {p.key() for p in self.kube.list_pods()}
            self._evict_backoff = {
                k: v for k, v in self._evict_backoff.items() if k in live
            }

        # delete owning NodeClaims first (controller.go:178-188)
        claims = [
            c
            for c in self.kube.list_nodeclaims()
            if c.status.provider_id == node.provider_id
        ]
        for c in claims:
            if c.metadata.deletion_timestamp is None:
                self.kube.delete(c)

        # taint so nothing schedules during the drain (terminator.go:55)
        if not any(
            t.key == DISRUPTED_NO_SCHEDULE_TAINT.key for t in node.taints
        ):
            node.taints.append(DISRUPTED_NO_SCHEDULE_TAINT)
            self.kube.update(node)

        # TGP enforcement (terminator.go:140-165): a NodeClaim
        # terminationGracePeriod sets a hard node deadline; each pod is
        # force-deleted (bypassing PDBs) at deadline − podGracePeriod so it
        # still gets its full grace window before the node dies
        deadline = self._termination_deadline(node, claims)
        if deadline is not None:
            for p in list(self.cluster.pods_on_node(node.name)):
                if p.is_daemonset or p.is_mirror:
                    continue
                if self.clock.now() >= deadline - p.termination_grace_period_seconds:
                    try:
                        self.kube.delete(p)
                    except NotFoundError:
                        pass

        # drain in priority groups (graceful-node-shutdown order,
        # terminator.go:119-138): non-critical pods evict first; critical
        # pods only once the earlier group is gone. A PDB-blocked eviction
        # (429) leaves the pod for the next reconcile — the drain proceeds
        # at the budget's allowed rate (eviction.go:176)
        evictable = [
            p
            for p in self.cluster.pods_on_node(node.name)
            if podutil.is_evictable(p) and not p.is_daemonset
        ]
        groups = [
            [p for p in evictable if not _is_critical(p)],
            [p for p in evictable if _is_critical(p)],
        ]
        now = self.clock.now()
        for group in groups:
            if group:
                for p in group:
                    not_before, delay = self._evict_backoff.get(
                        p.key(), (0.0, 0.0)
                    )
                    if now < not_before:
                        continue  # still backing off from a prior 429
                    try:
                        self.kube.evict(p)
                        self._evict_backoff.pop(p.key(), None)
                    except TooManyRequestsError as e:
                        delay = (
                            EVICT_BACKOFF_BASE
                            if delay == 0.0
                            else min(delay * 2.0, EVICT_BACKOFF_CAP)
                        )
                        self._evict_backoff[p.key()] = (now + delay, delay)
                        if self.recorder is not None:
                            from karpenter_core_tpu_torch.events import Event

                            self.recorder.publish(Event(
                                involved_object=f"Pod/{p.key()}",
                                type="Warning",
                                reason="FailedDraining",
                                message=str(e),
                            ))
                        continue
                break  # later groups wait for this one to drain
        if any(
            not p.is_daemonset
            for p in self.cluster.pods_on_node(node.name)
        ):
            return  # wait for drain to finish

        # wait for drain-able pods' VolumeAttachments to detach before
        # terminating (controller.go:140-143,190-201); attachments held by
        # non-drain-able pods must not block forever (filterVolumeAttachments)
        if not self._volumes_detached(node):
            return

        # ensure the instance is gone (claims' finalizers handle provider
        # delete; cover unmanaged/orphan nodes too)
        for c in claims:
            try:
                self.cloud_provider.delete(c)
            except NodeClaimNotFoundError:
                pass

        if apilabels.TERMINATION_FINALIZER in node.metadata.finalizers:
            node.metadata.finalizers.remove(apilabels.TERMINATION_FINALIZER)
            try:
                self.kube.update(node)
            except NotFoundError:
                pass  # provider delete already removed the node object

    def _termination_deadline(self, node: Node, claims) -> "float | None":
        """deletionTimestamp + the owning claim's terminationGracePeriod,
        persisted as a node annotation on first computation so the deadline
        survives the claim object (the reference stamps the equivalent
        annotation on the NodeClaim, lifecycle/controller.go:254-269)."""
        stamped = node.metadata.annotations.get(
            apilabels.NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY
        )
        if stamped is not None:
            return float(stamped)
        start = node.metadata.deletion_timestamp
        for c in claims:
            tgp = c.spec.termination_grace_period
            if tgp is None:
                continue
            base = (
                c.metadata.deletion_timestamp
                if c.metadata.deletion_timestamp is not None
                else start
            )
            if base is None:
                continue
            deadline = base + tgp
            node.metadata.annotations[
                apilabels.NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY
            ] = str(deadline)
            self.kube.update(node)
            return deadline
        return None

    def _volumes_detached(self, node: Node) -> bool:
        """True when no blocking VolumeAttachment remains on the node. An
        attachment blocks only if no non-drain-able pod on the node still
        uses its PV (controller.go:203-237 filterVolumeAttachments)."""
        from karpenter_core_tpu_torch.api.objects import PersistentVolumeClaim
        from karpenter_core_tpu_torch.scheduling.volumeusage import pvc_name_for

        attachments = [
            va
            for va in self.kube.list_volume_attachments()
            if va.node_name == node.name
        ]
        if not attachments:
            return True
        shielded_pvs = set()
        for p in self.cluster.pods_on_node(node.name):
            if podutil.is_evictable(p) and not p.is_daemonset:
                continue  # drain-able: its attachments DO block
            for vol in p.volumes:
                claim_name = pvc_name_for(p, vol)
                if claim_name is None:
                    continue
                pvc = self.kube.get(
                    PersistentVolumeClaim, claim_name, p.metadata.namespace
                )
                if pvc is not None and pvc.volume_name:
                    shielded_pvs.add(pvc.volume_name)
        return all(va.pv_name in shielded_pvs for va in attachments)
