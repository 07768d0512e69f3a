"""In-memory kube-apiserver stand-in.

The reference runs against a real apiserver (envtest for unit suites,
pkg/test/environment.go:60-80; kind for e2e). This framework is
self-contained: the store plays the apiserver's role for the controller
stack, with the same contracts the controllers rely on —

* finalizer-gated deletion: delete() stamps deletion_timestamp and keeps
  the object until the last finalizer is removed;
* resource_version bumping on every write (stale-write detection);
* watch callbacks (the informer seam, reference pkg/controllers/state/informer/);
* pod eviction that returns the pod to Pending instead of deleting it —
  standing in for the ReplicaSet controller recreating an evicted replica,
  so drain/consolidation flows are closed-loop without a workload
  controller.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional

from karpenter_core_tpu_torch.api.nodeclaim import NodeClaim
from karpenter_core_tpu_torch.api.nodepool import NodePool
from karpenter_core_tpu_torch.api.objects import (
    POD_PENDING,
    POD_RUNNING,
    CSINode,
    DaemonSet,
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    PodDisruptionBudget,
    StorageClass,
    VolumeAttachment,
)

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"

_KINDS = {
    Pod: "Pod",
    Node: "Node",
    NodeClaim: "NodeClaim",
    NodePool: "NodePool",
    DaemonSet: "DaemonSet",
    PersistentVolumeClaim: "PersistentVolumeClaim",
    PersistentVolume: "PersistentVolume",
    StorageClass: "StorageClass",
    CSINode: "CSINode",
    VolumeAttachment: "VolumeAttachment",
    PodDisruptionBudget: "PodDisruptionBudget",
}

# namespaced kinds key by namespace/name
_NAMESPACED = {"Pod", "PersistentVolumeClaim", "PodDisruptionBudget"}


class ConflictError(Exception):
    """Stale resource_version on update (optimistic-lock conflict)."""


class NotFoundError(Exception):
    pass


class TooManyRequestsError(Exception):
    """Eviction blocked by a PodDisruptionBudget (the apiserver's 429)."""


def _kind_of(obj) -> str:
    for cls, kind in _KINDS.items():
        if isinstance(obj, cls):
            return kind
    raise TypeError(f"unknown object kind: {type(obj)}")


def _key_of(kind: str, obj) -> str:
    if kind in _NAMESPACED:
        return f"{obj.metadata.namespace}/{obj.metadata.name}"
    return obj.metadata.name


class KubeStore:
    def __init__(self, clock=None):
        from karpenter_core_tpu_torch.utils.clock import Clock

        self.clock = clock or Clock()
        self._objects: Dict[str, Dict[str, object]] = {k: {} for k in _KINDS.values()}
        self._nodes_by_pid: Dict[str, Node] = {}
        self._rv = itertools.count(1)
        self._watchers: List[Callable[[str, str, object], None]] = []
        self.mutations = 0  # cheap idle detection for reconcile loops

    # -- watch ------------------------------------------------------------

    def watch(self, fn: Callable[[str, str, object], None]) -> None:
        """fn(event, kind, obj); fired synchronously on every write."""
        self._watchers.append(fn)

    def _notify(self, event: str, kind: str, obj) -> None:
        if kind == "Node" and getattr(obj, "provider_id", ""):
            if event == DELETED:
                self._nodes_by_pid.pop(obj.provider_id, None)
            else:
                self._nodes_by_pid[obj.provider_id] = obj
        self.mutations += 1
        for fn in self._watchers:
            fn(event, kind, obj)

    # -- CRUD -------------------------------------------------------------

    def create(self, obj) -> object:
        kind = _kind_of(obj)
        key = _key_of(kind, obj)
        if key in self._objects[kind]:
            raise ConflictError(f"{kind} {key} already exists")
        obj.metadata.resource_version = next(self._rv)
        if not obj.metadata.creation_timestamp:
            obj.metadata.creation_timestamp = self.clock.now()
        self._objects[kind][key] = obj
        self._notify(ADDED, kind, obj)
        return obj

    def get(self, cls, name: str, namespace: str = "default"):
        kind = _KINDS[cls]
        key = f"{namespace}/{name}" if kind in _NAMESPACED else name
        return self._objects[kind].get(key)

    def update(self, obj) -> object:
        kind = _kind_of(obj)
        key = _key_of(kind, obj)
        stored = self._objects[kind].get(key)
        if stored is None:
            raise NotFoundError(f"{kind} {key}")
        if (
            stored is not obj
            and obj.metadata.resource_version != stored.metadata.resource_version
        ):
            raise ConflictError(
                f"{kind} {key}: stale resource_version "
                f"{obj.metadata.resource_version} != {stored.metadata.resource_version}"
            )
        obj.metadata.resource_version = next(self._rv)
        self._objects[kind][key] = obj
        self._notify(MODIFIED, kind, obj)
        # finalizer-gated removal completes on the update that clears the
        # last finalizer
        if obj.metadata.deletion_timestamp is not None and not obj.metadata.finalizers:
            self._remove(kind, key, obj)
        return obj

    def delete(self, obj) -> None:
        kind = _kind_of(obj)
        key = _key_of(kind, obj)
        existing = self._objects[kind].get(key)
        if existing is None:
            raise NotFoundError(f"{kind} {key}")
        if existing.metadata.finalizers:
            if existing.metadata.deletion_timestamp is None:
                existing.metadata.deletion_timestamp = self.clock.now()
                existing.metadata.resource_version = next(self._rv)
                self._notify(MODIFIED, kind, existing)
            return
        self._remove(kind, key, existing)

    def _remove(self, kind: str, key: str, obj) -> None:
        self._objects[kind].pop(key, None)
        self._notify(DELETED, kind, obj)
        # a deleted pod releases its volume attachments like the CSI driver
        # would (evict() handles the graceful path; this covers force
        # deletes, e.g. TGP-expired drains — without it the node's
        # detach-wait would block forever)
        if kind == "Pod" and obj.node_name:
            self._detach_unreferenced(obj, obj.node_name)

    # -- typed listings ---------------------------------------------------

    def list_pods(self) -> List[Pod]:
        return list(self._objects["Pod"].values())

    def list_nodes(self) -> List[Node]:
        return list(self._objects["Node"].values())

    def list_nodeclaims(self) -> List[NodeClaim]:
        return list(self._objects["NodeClaim"].values())

    def list_nodepools(self) -> List[NodePool]:
        return list(self._objects["NodePool"].values())

    def list_daemonsets(self) -> List[DaemonSet]:
        return list(self._objects["DaemonSet"].values())

    def get_node_by_provider_id(self, provider_id: str) -> Optional[Node]:
        return self._nodes_by_pid.get(provider_id)

    def list_volume_attachments(self) -> List[VolumeAttachment]:
        return list(self._objects["VolumeAttachment"].values())

    def list_pdbs(self) -> List[PodDisruptionBudget]:
        return list(self._objects["PodDisruptionBudget"].values())

    # -- pod verbs --------------------------------------------------------

    def bind(self, pod: Pod, node_name: str) -> None:
        """kube-scheduler Binding subresource stand-in. Bound PVs grow a
        VolumeAttachment (the attach-detach controller's role); detach on
        unbind is immediate unless a test injects slow-CSI attachments."""
        pod.node_name = node_name
        pod.phase = POD_RUNNING
        self.update(pod)
        for pv_name, driver in self._bound_pvs(pod):
            va_name = f"va-{node_name}-{pv_name}"
            if self.get(VolumeAttachment, va_name) is None:
                from karpenter_core_tpu_torch.api.objects import ObjectMeta

                self.create(
                    VolumeAttachment(
                        metadata=ObjectMeta(name=va_name),
                        attacher=driver,
                        node_name=node_name,
                        pv_name=pv_name,
                    )
                )

    def _bound_pvs(self, pod: Pod):
        from karpenter_core_tpu_torch.scheduling.volumeusage import pvc_name_for

        for vol in pod.volumes:
            claim_name = pvc_name_for(pod, vol)
            if claim_name is None:
                continue
            pvc = self.get(
                PersistentVolumeClaim, claim_name, pod.metadata.namespace
            )
            if pvc is None or not pvc.volume_name:
                continue
            pv = self.get(PersistentVolume, pvc.volume_name)
            yield pvc.volume_name, (pv.csi_driver if pv else "")

    def _detach_unreferenced(self, pod: Pod, node_name: str) -> None:
        """Remove VolumeAttachments for PVs no pod on the node still uses."""
        if not node_name or not pod.volumes:
            return
        still_used = set()
        for p in self._objects["Pod"].values():
            if p.node_name == node_name and p is not pod:
                still_used.update(name for name, _ in self._bound_pvs(p))
        for pv_name, _ in self._bound_pvs(pod):
            if pv_name in still_used:
                continue
            va = self.get(VolumeAttachment, f"va-{node_name}-{pv_name}")
            if va is not None:
                self.delete(va)

    def evict(self, pod: Pod) -> None:
        """Eviction API stand-in: PDB-gated like the apiserver (429 when a
        budget has no disruptions left). A replicated workload's pod returns
        to Pending (ReplicaSet recreation folded in); bare pods are
        deleted."""
        if pod.is_mirror or pod.is_daemonset:
            return
        key = _key_of("Pod", pod)
        if key not in self._objects["Pod"]:
            raise NotFoundError(f"Pod {key}")
        if self._objects["PodDisruptionBudget"]:
            from karpenter_core_tpu_torch.utils.pdb import Limits

            blocking = Limits.from_kube(self).blocking_pdb(pod)
            if blocking is not None:
                raise TooManyRequestsError(
                    f"eviction of {key} blocked by pdb {blocking}"
                )
        prior_node = pod.node_name
        if pod.metadata.owner_references:
            pod.node_name = ""
            pod.phase = POD_PENDING
            self.update(pod)
        else:
            self.delete(pod)
        self._detach_unreferenced(pod, prior_node)
