"""Condition-transition observability — the operatorpkg status controllers.

The reference registers a status controller per CRD kind
(pkg/controllers/controllers.go:103-105: status.NewController[*v1.NodeClaim],
[*v1.NodePool], and the generic Node variant); they are the fleet's primary
condition-debugging surface, emitting a metric + event on every condition
flip. The rebuild is one observer that diffs each object's ConditionSet
against its last-seen snapshot per reconcile pass — the synchronous
equivalent of the reference's watch-driven reconciler.
"""
from __future__ import annotations

from typing import Dict, Tuple

from karpenter_core_tpu_torch.events.recorder import Event
from karpenter_core_tpu_torch.metrics import wiring as m


class StatusController:
    def __init__(self, kube, recorder, clock):
        self.kube = kube
        self.recorder = recorder
        self.clock = clock
        # (kind, object name, condition type) -> (status, reason)
        self._seen: Dict[Tuple[str, str, str], Tuple[str, str]] = {}

    def reconcile(self) -> None:
        live = set()
        for kind, objs in (
            ("NodeClaim", self.kube.list_nodeclaims()),
            ("NodePool", self.kube.list_nodepools()),
        ):
            for obj in objs:
                for cond in obj.conditions.all():
                    key = (kind, obj.name, cond.type)
                    live.add(key)
                    prev = self._seen.get(key)
                    cur = (cond.status, cond.reason)
                    if prev == cur:
                        continue
                    self._seen[key] = cur
                    m.STATUS_CONDITION_TRANSITIONS.inc(
                        {
                            "kind": kind,
                            "type": cond.type,
                            "status": cond.status,
                        }
                    )
                    self.recorder.publish(
                        Event(
                            involved_object=f"{kind}/{obj.name}",
                            type="Normal",
                            reason=f"{cond.type}{cond.status}",
                            message=(
                                f"condition {cond.type} -> {cond.status}"
                                + (f" ({cond.reason})" if cond.reason else "")
                            ),
                        )
                    )
        # deleted objects stop contributing series (the reference's gauge
        # stores delete by object on DeletedFinalStateUnknown)
        for key in list(self._seen):
            if key not in live:
                del self._seen[key]
        m.STATUS_CONDITION_COUNT.reset()
        for (kind, _name, ctype), (status, _reason) in self._seen.items():
            labels = {"kind": kind, "type": ctype, "status": status}
            m.STATUS_CONDITION_COUNT.set(
                m.STATUS_CONDITION_COUNT.value(labels) + 1, labels
            )
