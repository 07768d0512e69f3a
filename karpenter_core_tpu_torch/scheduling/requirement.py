"""Compressed label-value set algebra.

Host-side twin of the reference's ``scheduling.Requirement``
(reference: pkg/scheduling/requirement.go:33-242): a set over label values
represented either explicitly (``In``) or as a complement set (``NotIn`` /
``Exists``) with optional integer Gt/Lt bounds and MinValues flexibility.

On device, each Requirement lowers to a boolean mask over the solve's
closed-world value vocabulary (solver/vocab.py); Intersection becomes AND,
complement becomes NOT. This class is the semantics oracle the device masks
are property-tested against.
"""
from __future__ import annotations

import sys
from typing import Iterable, Optional

from karpenter_core_tpu_torch.api import labels as apilabels

MAX_LEN = sys.maxsize  # stand-in for Go's math.MaxInt64 set cardinality

# Operators (mirror corev1.NodeSelectorOperator)
OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"
OP_GT = "Gt"
OP_LT = "Lt"

NEGATIVE_OPERATORS = frozenset({OP_NOT_IN, OP_DOES_NOT_EXIST})


def _within(value: str, greater_than: Optional[int], less_than: Optional[int]) -> bool:
    if greater_than is None and less_than is None:
        return True
    try:
        iv = int(value)
    except ValueError:
        return False
    if greater_than is not None and iv <= greater_than:
        return False
    if less_than is not None and iv >= less_than:
        return False
    return True


class Requirement:
    """A set of allowed values for one label key."""

    __slots__ = ("key", "complement", "values", "greater_than", "less_than", "min_values")

    def __init__(
        self,
        key: str,
        *,
        complement: bool = False,
        values: Iterable[str] = (),
        greater_than: Optional[int] = None,
        less_than: Optional[int] = None,
        min_values: Optional[int] = None,
    ):
        self.key = key
        self.complement = complement
        self.values = set(values)
        self.greater_than = greater_than
        self.less_than = less_than
        self.min_values = min_values

    # -- constructors ------------------------------------------------------

    @classmethod
    def new(
        cls,
        key: str,
        operator: str,
        values: Iterable[str] = (),
        min_values: Optional[int] = None,
    ) -> "Requirement":
        """Mirror of NewRequirementWithFlexibility (requirement.go:43-85)."""
        key = apilabels.NORMALIZED_LABELS.get(key, key)
        values = list(values)
        if operator == OP_IN:
            return cls(key, values=values, min_values=min_values)
        r = cls(key, complement=True, min_values=min_values)
        if operator == OP_DOES_NOT_EXIST:
            r.complement = False
        if operator == OP_NOT_IN:
            r.values.update(values)
        if operator == OP_GT:
            r.greater_than = int(values[0])
        if operator == OP_LT:
            r.less_than = int(values[0])
        return r

    # -- algebra -----------------------------------------------------------

    def intersection(self, other: "Requirement") -> "Requirement":
        """Mirror of Requirement.Intersection (requirement.go:155-188)."""
        complement = self.complement and other.complement
        greater_than = _max_opt(self.greater_than, other.greater_than)
        less_than = _min_opt(self.less_than, other.less_than)
        min_values = _max_opt(self.min_values, other.min_values)
        if (
            greater_than is not None
            and less_than is not None
            and greater_than >= less_than
        ):
            return Requirement.new(self.key, OP_DOES_NOT_EXIST, min_values=min_values)

        if self.complement and other.complement:
            values = self.values | other.values
        elif self.complement and not other.complement:
            values = other.values - self.values
        elif not self.complement and other.complement:
            values = self.values - other.values
        else:
            values = self.values & other.values
        values = {v for v in values if _within(v, greater_than, less_than)}
        if not complement:
            greater_than, less_than = None, None
        return Requirement(
            self.key,
            complement=complement,
            values=values,
            greater_than=greater_than,
            less_than=less_than,
            min_values=min_values,
        )

    def has(self, value: str) -> bool:
        """True if the requirement allows the value (requirement.go:209-214)."""
        if self.complement:
            return value not in self.values and _within(
                value, self.greater_than, self.less_than
            )
        return value in self.values and _within(
            value, self.greater_than, self.less_than
        )

    def operator(self) -> str:
        """Mirror of Requirement.Operator (requirement.go:224-235)."""
        if self.complement:
            return OP_NOT_IN if self.length() < MAX_LEN else OP_EXISTS
        return OP_IN if self.length() > 0 else OP_DOES_NOT_EXIST

    def length(self) -> int:
        """Set cardinality with complement sets counted from MAX_LEN (requirement.go:237-242)."""
        if self.complement:
            return MAX_LEN - len(self.values)
        return len(self.values)

    def any_value(self) -> str:
        """A representative allowed value (requirement.go:190-204)."""
        op = self.operator()
        if op == OP_IN:
            return next(iter(sorted(self.values)))
        if op in (OP_NOT_IN, OP_EXISTS):
            lo = (self.greater_than + 1) if self.greater_than is not None else 0
            hi = self.less_than if self.less_than is not None else lo + (1 << 20)
            for candidate in range(lo, hi):
                if str(candidate) not in self.values:
                    return str(candidate)
        return ""

    def sorted_values(self) -> list:
        return sorted(self.values)

    def copy(self) -> "Requirement":
        return Requirement(
            self.key,
            complement=self.complement,
            values=set(self.values),
            greater_than=self.greater_than,
            less_than=self.less_than,
            min_values=self.min_values,
        )

    # -- dunder ------------------------------------------------------------

    def __eq__(self, other) -> bool:
        if not isinstance(other, Requirement):
            return NotImplemented
        return (
            self.key == other.key
            and self.complement == other.complement
            and self.values == other.values
            and self.greater_than == other.greater_than
            and self.less_than == other.less_than
            and self.min_values == other.min_values
        )

    def __hash__(self):
        return hash(
            (
                self.key,
                self.complement,
                frozenset(self.values),
                self.greater_than,
                self.less_than,
                self.min_values,
            )
        )

    def __repr__(self) -> str:
        op = self.operator()
        if op in (OP_EXISTS, OP_DOES_NOT_EXIST):
            s = f"{self.key} {op}"
        else:
            vals = self.sorted_values()
            if len(vals) > 5:
                vals = vals[:5] + [f"and {len(vals) - 5} others"]
            s = f"{self.key} {op} {vals}"
        if self.greater_than is not None:
            s += f" >{self.greater_than}"
        if self.less_than is not None:
            s += f" <{self.less_than}"
        return s


def _max_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)


def _min_opt(a: Optional[int], b: Optional[int]) -> Optional[int]:
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)
