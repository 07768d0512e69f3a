"""Preference relaxation — on scheduling failure, progressively drop soft
constraints (reference: pkg/controllers/provisioning/scheduling/preferences.go:32-146).

Order: required node-affinity term (pop OR alternative) → preferred
pod-affinity → preferred pod-anti-affinity → preferred node-affinity →
ScheduleAnyway topology spreads → tolerate PreferNoSchedule taints."""
from __future__ import annotations

from typing import Optional

from karpenter_core_tpu_torch.api.objects import (
    TAINT_EFFECT_PREFER_NO_SCHEDULE,
    TOLERATION_OP_EXISTS,
    Pod,
    Toleration,
)


class Preferences:
    def __init__(self, tolerate_prefer_no_schedule: bool = False):
        self.tolerate_prefer_no_schedule = tolerate_prefer_no_schedule

    def relax(self, pod: Pod) -> bool:
        relaxations = [
            self._remove_required_node_affinity_term,
            self._remove_preferred_pod_affinity_term,
            self._remove_preferred_pod_anti_affinity_term,
            self._remove_preferred_node_affinity_term,
            self._remove_topology_spread_schedule_anyway,
        ]
        if self.tolerate_prefer_no_schedule:
            relaxations.append(self._tolerate_prefer_no_schedule_taints)
        for fn in relaxations:
            reason = fn(pod)
            if reason is not None:
                return True
        return False

    def _remove_required_node_affinity_term(self, pod: Pod) -> Optional[str]:
        na = pod.affinity.node_affinity if pod.affinity else None
        if na is None or len(na.required) <= 1:
            # cannot drop the last required term (preferences.go:76-89)
            return None
        dropped = na.required.pop(0)
        return f"removed required node affinity term {dropped}"

    def _remove_preferred_node_affinity_term(self, pod: Pod) -> Optional[str]:
        na = pod.affinity.node_affinity if pod.affinity else None
        if na is None or not na.preferred:
            return None
        na.preferred.sort(key=lambda t: -t.weight)
        dropped = na.preferred.pop(0)
        return f"removed preferred node affinity term {dropped}"

    def _remove_preferred_pod_affinity_term(self, pod: Pod) -> Optional[str]:
        pa = pod.affinity.pod_affinity if pod.affinity else None
        if pa is None or not pa.preferred:
            return None
        pa.preferred.sort(key=lambda t: -t.weight)
        dropped = pa.preferred.pop(0)
        return f"removed preferred pod affinity term {dropped}"

    def _remove_preferred_pod_anti_affinity_term(self, pod: Pod) -> Optional[str]:
        pa = pod.affinity.pod_anti_affinity if pod.affinity else None
        if pa is None or not pa.preferred:
            return None
        pa.preferred.sort(key=lambda t: -t.weight)
        dropped = pa.preferred.pop(0)
        return f"removed preferred pod anti-affinity term {dropped}"

    def _remove_topology_spread_schedule_anyway(self, pod: Pod) -> Optional[str]:
        for i, tsc in enumerate(pod.topology_spread_constraints):
            if tsc.when_unsatisfiable == "ScheduleAnyway":
                pod.topology_spread_constraints.pop(i)
                return f"removed ScheduleAnyway topology spread {tsc}"
        return None

    def _tolerate_prefer_no_schedule_taints(self, pod: Pod) -> Optional[str]:
        marker = Toleration(
            operator=TOLERATION_OP_EXISTS, effect=TAINT_EFFECT_PREFER_NO_SCHEDULE
        )
        if any(
            t.operator == TOLERATION_OP_EXISTS
            and t.effect == TAINT_EFFECT_PREFER_NO_SCHEDULE
            and not t.key
            for t in pod.tolerations
        ):
            return None
        pod.tolerations.append(marker)
        return "added toleration for PreferNoSchedule taints"
