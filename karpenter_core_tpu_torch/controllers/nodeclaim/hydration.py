"""Hydration: backfill labels newer versions expect onto pre-existing
objects (reference: pkg/controllers/nodeclaim/hydration/controller.go:41-78,
pkg/controllers/node/hydration/controller.go:40-75).

The nodeclass label key is derived from the claim's nodeClassRef group/kind
(v1.NodeClassLabelKey); both the NodeClaim and its Node get it stamped.
"""
from __future__ import annotations

from karpenter_core_tpu_torch.api.nodeclaim import NodeClaim


def node_class_label_key(group: str, kind: str) -> str:
    return f"{group}/{kind.lower()}" if group else kind.lower()


class Hydration:
    def __init__(self, kube):
        self.kube = kube

    def reconcile(self, claim: NodeClaim) -> None:
        ref = claim.spec.node_class_ref
        if ref is None or not ref.name:
            return
        key = node_class_label_key(ref.group, ref.kind)
        if claim.metadata.labels.get(key) != ref.name:
            claim.metadata.labels[key] = ref.name
            self.kube.update(claim)
        node = (
            self.kube.get_node_by_provider_id(claim.status.provider_id)
            if claim.status.provider_id
            else None
        )
        if node is not None and node.metadata.labels.get(key) != ref.name:
            node.metadata.labels[key] = ref.name
            self.kube.update(node)
