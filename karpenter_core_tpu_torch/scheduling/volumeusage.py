"""CSI attach-limit accounting per node
(reference: pkg/scheduling/volumeusage.go:44-229).

``Volumes`` maps csi-driver name → set of PVC keys (namespace/name); union
semantics dedupe shared (RWX) claims. ``VolumeUsage`` tracks one node's
mounted volumes against per-driver limits sourced from that node's CSINode.
``get_volumes`` resolves a pod's PVC-backed volumes to drivers the same way
the reference does: bound PV's csi driver first, else the storage class's
provisioner; unresolvable shapes are skipped, not errors
(volumeusage.go:82-150 GetVolumes/resolveDriver).
"""
from __future__ import annotations

from typing import Dict, Optional, Set

from karpenter_core_tpu_torch.api.objects import (
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    StorageClass,
)

Volumes = Dict[str, Set[str]]  # driver -> {pvc keys}


def union(a: Volumes, b: Volumes) -> Volumes:
    out: Volumes = {k: set(v) for k, v in a.items()}
    for k, v in b.items():
        out.setdefault(k, set()).update(v)
    return out


def pvc_name_for(pod: Pod, volume) -> Optional[str]:
    """Ephemeral volumes materialize a PVC named <pod>-<volume>
    (volumeutil.GetPersistentVolumeClaim)."""
    if volume.ephemeral:
        return f"{pod.metadata.name}-{volume.name}"
    return volume.pvc_name


def get_volumes(kube, pod: Pod) -> Volumes:
    """Resolve the pod's PVC-backed volumes to {driver -> {pvc key}}.

    Missing PVCs are skipped (manually deleted; tracking must not wedge,
    volumeusage.go:88-93); non-CSI or unresolvable drivers are skipped."""
    out: Volumes = {}
    for vol in pod.volumes:
        claim_name = pvc_name_for(pod, vol)
        if claim_name is None:
            continue  # emptyDir / hostPath etc.
        pvc = kube.get(
            PersistentVolumeClaim, claim_name, pod.metadata.namespace
        )
        if pvc is None:
            continue
        driver = _resolve_driver(kube, pvc)
        if driver:
            out.setdefault(driver, set()).add(pvc.key())
    return out


def _resolve_driver(kube, pvc: PersistentVolumeClaim) -> str:
    """Bound PV's CSI driver wins; else the storage class provisioner
    (volumeusage.go:113-150 resolveDriver)."""
    if pvc.volume_name:
        pv = kube.get(PersistentVolume, pvc.volume_name)
        if pv is not None and pv.csi_driver:
            return pv.csi_driver
        return ""  # bound to a non-CSI volume: not limit-tracked
    if not pvc.storage_class_name:
        return ""
    sc = kube.get(StorageClass, pvc.storage_class_name)
    if sc is None:
        return ""
    return sc.provisioner


class VolumeUsage:
    """One node's volume usage vs its CSINode limits
    (volumeusage.go:183-229)."""

    def __init__(self):
        self.volumes: Volumes = {}
        self.limits: Dict[str, int] = {}

    def add_limit(self, driver: str, value: int) -> None:
        self.limits[driver] = value

    def exceeds_limits(self, vols: Volumes) -> Optional[str]:
        joined = union(self.volumes, vols)
        for driver, pvcs in joined.items():
            limit = self.limits.get(driver)
            if limit is not None and len(pvcs) > limit:
                return (
                    f"would exceed volume limit for {driver}, "
                    f"{len(pvcs)} > {limit}"
                )
        return None

    def add(self, vols: Volumes) -> None:
        self.volumes = union(self.volumes, vols)

    def copy(self) -> "VolumeUsage":
        out = VolumeUsage()
        out.limits = dict(self.limits)
        out.volumes = {k: set(v) for k, v in self.volumes.items()}
        return out
