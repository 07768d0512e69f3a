"""Status conditions (the operatorpkg condition model the reference relies on)."""
from __future__ import annotations

from dataclasses import dataclass, field

from karpenter_core_tpu_torch.utils import timesource
from typing import Optional

CONDITION_TRUE = "True"
CONDITION_FALSE = "False"
CONDITION_UNKNOWN = "Unknown"


@dataclass
class Condition:
    type: str
    status: str = CONDITION_UNKNOWN
    reason: str = ""
    message: str = ""
    last_transition_time: float = field(default_factory=timesource.now)


class ConditionSet:
    """Mutable set of typed conditions with a root 'Ready' aggregation."""

    def __init__(self, *types: str):
        self._conditions: dict = {}
        self._types = list(types)

    def get(self, cond_type: str) -> Optional[Condition]:
        return self._conditions.get(cond_type)

    def set(
        self,
        cond_type: str,
        status: str,
        reason: str = "",
        message: str = "",
        now: Optional[float] = None,
    ) -> bool:
        """Returns True if the condition transitioned. Controllers pass
        ``now`` from their injected clock; the timesource default covers
        ad-hoc construction."""
        existing = self._conditions.get(cond_type)
        if existing is not None and existing.status == status:
            existing.reason = reason
            existing.message = message
            return False
        cond = Condition(
            type=cond_type, status=status, reason=reason, message=message
        )
        if now is not None:
            cond.last_transition_time = now
        self._conditions[cond_type] = cond
        return True

    def set_true(
        self, cond_type: str, reason: str = "", now: Optional[float] = None
    ) -> bool:
        return self.set(cond_type, CONDITION_TRUE, reason, now=now)

    def set_false(
        self,
        cond_type: str,
        reason: str = "",
        message: str = "",
        now: Optional[float] = None,
    ) -> bool:
        return self.set(cond_type, CONDITION_FALSE, reason, message, now=now)

    def clear(self, cond_type: str) -> bool:
        return self._conditions.pop(cond_type, None) is not None

    def is_true(self, cond_type: str) -> bool:
        c = self._conditions.get(cond_type)
        return c is not None and c.status == CONDITION_TRUE

    def is_false(self, cond_type: str) -> bool:
        c = self._conditions.get(cond_type)
        return c is not None and c.status == CONDITION_FALSE

    def root_is_true(self, root_types) -> bool:
        return all(self.is_true(t) for t in root_types)

    def all(self) -> list:
        return list(self._conditions.values())
