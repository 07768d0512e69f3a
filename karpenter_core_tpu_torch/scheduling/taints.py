"""Taint / toleration checking (reference: pkg/scheduling/taints.go:35-59)."""
from __future__ import annotations

from typing import Iterable, List

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.objects import (
    TAINT_EFFECT_NO_EXECUTE,
    TAINT_EFFECT_NO_SCHEDULE,
    Pod,
    Taint,
)

DISRUPTED_NO_SCHEDULE_TAINT = Taint(
    key=apilabels.DISRUPTED_TAINT_KEY, effect=TAINT_EFFECT_NO_SCHEDULE
)
UNREGISTERED_NO_EXECUTE_TAINT = Taint(
    key=apilabels.UNREGISTERED_TAINT_KEY, effect=TAINT_EFFECT_NO_EXECUTE
)

# Taints expected on a node while it is initializing; ignored on uninitialized
# managed nodes (reference: pkg/scheduling/taints.go:35-41).
KNOWN_EPHEMERAL_TAINTS = (
    Taint(key="node.kubernetes.io/not-ready", effect=TAINT_EFFECT_NO_SCHEDULE),
    Taint(key="node.kubernetes.io/unreachable", effect=TAINT_EFFECT_NO_SCHEDULE),
    Taint(
        key="node.cloudprovider.kubernetes.io/uninitialized",
        effect=TAINT_EFFECT_NO_SCHEDULE,
        value="true",
    ),
    UNREGISTERED_NO_EXECUTE_TAINT,
)


class Taints(list):
    """list[Taint] with toleration checking."""

    def tolerates(self, pod: Pod) -> List[str]:
        """Error strings for every taint the pod does not tolerate
        (taints.go:46-59)."""
        errs = []
        for taint in self:
            if not any(t.tolerates(taint) for t in pod.tolerations):
                errs.append(f"did not tolerate {taint}")
        return errs

    def merge(self, other: Iterable[Taint]) -> "Taints":
        out = Taints(self)
        for taint in other:
            if not any(
                t.key == taint.key and t.effect == taint.effect for t in out
            ):
                out.append(taint)
        return out
