"""Keyed requirement sets and compatibility rules.

Host-side twin of the reference's ``scheduling.Requirements``
(reference: pkg/scheduling/requirements.go:36-304): a map from label key to
Requirement with intersect-on-add, plus the two compatibility relations the
scheduler is built on:

* ``compatible`` — custom (non-well-known) keys the incoming side constrains
  must be defined by the receiver (unless the incoming operator is negative),
  then ``intersects`` must hold (requirements.go:175-187).
* ``intersects`` — for every key both sides define, the intersection must be
  non-empty, except when both operators are negative (requirements.go:283-304).

On device this whole relation evaluates as per-key mask intersections
(ops/masks.py); these methods are the oracle for those kernels.
"""
from __future__ import annotations

from typing import Iterable, Optional

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.objects import Pod
from karpenter_core_tpu_torch.scheduling.requirement import (
    NEGATIVE_OPERATORS,
    OP_EXISTS,
    OP_IN,
    Requirement,
)


class Requirements(dict):
    """dict[str, Requirement] with reference Add/Compatible/Intersects semantics."""

    def __init__(self, reqs: Iterable[Requirement] = ()):
        super().__init__()
        self.add(*reqs)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_labels(cls, labels: dict) -> "Requirements":
        """NewLabelRequirements (requirements.go:53-59)."""
        return cls(
            Requirement.new(k, OP_IN, [v]) for k, v in labels.items()
        )

    @classmethod
    def from_node_selector_requirements(cls, reqs) -> "Requirements":
        """NewNodeSelectorRequirements: minValues deliberately dropped — only
        NodePools may introduce flexibility (requirements.go:38-44)."""
        return cls(Requirement.new(r.key, r.operator, r.values) for r in reqs)

    @classmethod
    def from_node_selector_requirements_with_min_values(cls, reqs) -> "Requirements":
        """NewNodeSelectorRequirementsWithMinValues — the NodePool path
        (requirements.go:46-52)."""
        return cls(
            Requirement.new(r.key, r.operator, r.values, min_values=r.min_values)
            for r in reqs
        )

    @classmethod
    def from_pod(cls, pod: Pod) -> "Requirements":
        """NewPodRequirements (requirements.go:62-110): node selector + first
        required node-affinity term, with the single heaviest preferred term
        folded in when no required terms exist."""
        return cls._pod_requirements(pod, include_preferred=True)

    @classmethod
    def from_pod_strict(cls, pod: Pod) -> "Requirements":
        """NewStrictPodRequirements: required terms only."""
        return cls._pod_requirements(pod, include_preferred=False)

    @classmethod
    def _pod_requirements(cls, pod: Pod, include_preferred: bool) -> "Requirements":
        requirements = cls.from_labels(pod.node_selector)
        # PVC-derived zone pins AND in unconditionally — relaxation only
        # mutates pod.affinity, so these survive by construction (the
        # reference ANDs them into every node-selector term instead,
        # volumetopology.go:68-72)
        if pod.volume_requirements:
            requirements.add(
                *cls.from_node_selector_requirements(
                    pod.volume_requirements
                ).values()
            )
        affinity = pod.affinity.node_affinity if pod.affinity else None
        if affinity is None:
            return requirements
        # The heaviest preferred term folds in unconditionally (the relaxation
        # loop unconstrains it later if unsatisfiable), then the first required
        # term intersects on top (requirements.go:90-110).
        if include_preferred and affinity.preferred:
            preferred = sorted(affinity.preferred, key=lambda t: -t.weight)
            requirements.add(
                *cls.from_node_selector_requirements(
                    preferred[0].preference.match_expressions
                ).values()
            )
        if affinity.required:
            requirements.add(
                *cls.from_node_selector_requirements(
                    affinity.required[0].match_expressions
                ).values()
            )
        return requirements

    # -- mutation ----------------------------------------------------------

    def add(self, *reqs: Requirement) -> None:
        """Intersect-on-collision (requirements.go:127-134)."""
        for req in reqs:
            existing = dict.get(self, req.key)
            if existing is not None:
                req = req.intersection(existing)
            self[req.key] = req

    # -- access ------------------------------------------------------------

    def get(self, key: str) -> Requirement:  # type: ignore[override]
        """Undefined keys read as Exists — allow-any (requirements.go:157-162)."""
        existing = dict.get(self, key)
        if existing is None:
            return Requirement.new(key, OP_EXISTS)
        return existing

    def keys_set(self) -> set:
        return set(self.keys())

    def has(self, key: str) -> bool:
        return key in self

    def has_min_values(self) -> bool:
        return any(r.min_values is not None for r in self.values())

    def copy(self) -> "Requirements":
        out = Requirements()
        for k, v in self.items():
            dict.__setitem__(out, k, v.copy())
        return out

    # -- relations ---------------------------------------------------------

    def compatible(
        self, incoming: "Requirements", allow_undefined: frozenset = frozenset()
    ) -> list:
        """Returns a list of error strings; empty means compatible
        (requirements.go:175-187)."""
        errs = []
        for key in incoming.keys_set() - allow_undefined:
            op = incoming.get(key).operator()
            if self.has(key) or op in NEGATIVE_OPERATORS:
                continue
            errs.append(f"label {key!r} does not have known values")
        errs.extend(self.intersects(incoming))
        return errs

    def is_compatible(
        self, incoming: "Requirements", allow_undefined: frozenset = frozenset()
    ) -> bool:
        return not self.compatible(incoming, allow_undefined)

    def intersects(self, incoming: "Requirements") -> list:
        """Overlap check on shared keys (requirements.go:283-304)."""
        errs = []
        for key in self.keys_set() & incoming.keys_set():
            existing = self.get(key)
            inc = incoming.get(key)
            if existing.intersection(inc).length() == 0:
                if (
                    inc.operator() in NEGATIVE_OPERATORS
                    and existing.operator() in NEGATIVE_OPERATORS
                ):
                    continue
                errs.append(f"key {key}, {inc!r} not in {existing!r}")
        return errs

    # -- output ------------------------------------------------------------

    def to_labels(self) -> dict:
        """Representative labels for keys the framework may inject itself —
        well-known labels are excluded because the cloud provider injects them
        (requirements.go Labels(), labels.go IsRestrictedNodeLabel:118-131)."""
        out = {}
        for key, req in self.items():
            if not apilabels.is_restricted_node_label(key):
                value = req.any_value()
                if value:
                    out[key] = value
        return out

    def __repr__(self) -> str:
        return ", ".join(repr(r) for _, r in sorted(self.items()))


ALLOW_UNDEFINED_WELL_KNOWN_LABELS = apilabels.WELL_KNOWN_LABELS


def has_preferred_node_affinity(pod: Optional[Pod]) -> bool:
    return bool(
        pod
        and pod.affinity
        and pod.affinity.node_affinity
        and pod.affinity.node_affinity.preferred
    )
