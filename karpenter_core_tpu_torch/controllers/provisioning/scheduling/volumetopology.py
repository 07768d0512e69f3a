"""Volume-derived node requirements, stamped onto pods pre-solve
(reference: pkg/controllers/provisioning/scheduling/volumetopology.go:42-166).

The reference ANDs each PVC's zone requirement into EVERY node-selector term
of the pod so relaxation can't strip it (volumetopology.go:68-72). Here the
same invariant holds structurally: ``inject`` stamps
``pod.volume_requirements`` (a flat AND list) and ``Requirements.from_pod``
folds them in unconditionally — preference relaxation only ever touches
``pod.affinity``, so the volume terms survive by construction.
"""
from __future__ import annotations

from typing import List, Optional

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.objects import (
    NodeSelectorRequirement,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    StorageClass,
)
from karpenter_core_tpu_torch.scheduling.volumeusage import pvc_name_for


class VolumeTopology:
    def __init__(self, kube):
        self.kube = kube

    def inject(self, pod: Pod) -> None:
        """Recompute pod.volume_requirements from the pod's PVCs. Idempotent:
        the list is replaced wholesale each call (the reference re-reads pods
        from the apiserver each solve; our store hands out live objects)."""
        requirements: List[NodeSelectorRequirement] = []
        for vol in pod.volumes:
            requirements.extend(self._requirements_for(pod, vol))
        pod.volume_requirements = requirements

    def _requirements_for(self, pod: Pod, vol) -> List[NodeSelectorRequirement]:
        claim_name = pvc_name_for(pod, vol)
        if claim_name is None:
            return []
        pvc = self.kube.get(
            PersistentVolumeClaim, claim_name, pod.metadata.namespace
        )
        if pvc is None:
            return []
        if pvc.volume_name:
            return self._pv_requirements(pvc.volume_name)
        if pvc.storage_class_name:
            return self._storage_class_requirements(pvc.storage_class_name)
        return []

    def _pv_requirements(self, pv_name: str) -> List[NodeSelectorRequirement]:
        """First required term's expressions; local/hostPath volumes drop the
        hostname pin (rescheduling means a different node,
        volumetopology.go:124-148)."""
        pv = self.kube.get(PersistentVolume, pv_name)
        if pv is None or not pv.node_affinity_required:
            return []
        exprs = list(pv.node_affinity_required[0].match_expressions)
        if pv.local or pv.host_path:
            exprs = [e for e in exprs if e.key != apilabels.LABEL_HOSTNAME]
        return exprs

    def _storage_class_requirements(
        self, name: str
    ) -> List[NodeSelectorRequirement]:
        """allowedTopologies[0] as In requirements (volumetopology.go:110-122)."""
        sc = self.kube.get(StorageClass, name)
        if sc is None or not sc.allowed_topologies:
            return []
        return [
            NodeSelectorRequirement(key, "In", tuple(values))
            for key, values in sc.allowed_topologies
        ]

    def validate_pvcs(self, pod: Pod) -> Optional[str]:
        """Error string when the pod references a missing PVC or a dangling
        unbound storage class — such pods are excluded from the solve with
        an event (volumetopology.go:152-196, provisioner.go:436-516)."""
        for vol in pod.volumes:
            claim_name = pvc_name_for(pod, vol)
            if claim_name is None:
                continue
            pvc = self.kube.get(
                PersistentVolumeClaim, claim_name, pod.metadata.namespace
            )
            if pvc is None:
                return f"unbound pvc {claim_name!r} not found"
            if pvc.volume_name:
                if self.kube.get(PersistentVolume, pvc.volume_name) is None:
                    return (
                        f"pvc {claim_name!r} references missing persistent "
                        f"volume {pvc.volume_name!r}"
                    )
            elif pvc.storage_class_name:
                if self.kube.get(StorageClass, pvc.storage_class_name) is None:
                    return (
                        f"pvc {claim_name!r} references missing storage "
                        f"class {pvc.storage_class_name!r}"
                    )
        return None
