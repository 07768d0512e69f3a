"""The provisioning solve's verify pass: ``solver/verify.ResultVerifier``
with its spread, anti-affinity and foreign-option checks done in one walk.

``solver/verify.py`` is a verbatim copy of the JAX package's verifier and
stays one. Its spread check rescans every pod of every group once per hard
constraint, and its anti-affinity check scans the whole group once per
pod's term. :class:`VerifyPass` subclasses it and overrides three helpers:

* ``_verify_spread`` walks the groups once. What depends only on a pod's
  class (its hard ``(topology_key, label_selector)`` pairs, its allowed
  zones) is computed once a class, what depends only on a label set (which
  selectors match it) once a distinct label set, and the tallies per group
  and constraint are counts under int keys. The violations come out as the
  copy emits them: per constraint in first-seen order, groups in order,
  each zone's ``counts`` filled in group order and then from the topology
  context.
* ``_check_anti_affinity`` counts a selector's matches in a group once,
  however many of the group's pods carry a term with it, and looks up the
  class of no pod without affinity.
* ``_verify_claim`` tests a claim's options by name once per distinct
  option list: most claims of a solve keep one of a few lists.

Everything else, ``verify`` itself included, is the copy's code: the
conservation, capacity, taint, selector, offering, eviction and gang
checks, the class key and the fast exit of a result with no hard spread.
Like the copy, the pass reads only the result, its pods and the
constructor's inputs, never the solver's state.

The walk keeps no container a group alive until its end: objects that
outlive a collection of the youngest generation move the full
collections of a heap as large as a running scheduler's closer, and one
of those costs more than the whole check.

Pods of one class share their labels: the class key
(``solver/snapshot._spec_signature`` with labels) holds them. A pod with
no spread constraints is in a class that carries none, so the spread walk
takes its label set from its labels and does not look up its class.
"""
from __future__ import annotations

from typing import Dict, List

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.solver.verify import (
    ResultVerifier,
    Violation,
    _fits_with_tolerance,
    _hard_taints,
)
from karpenter_core_tpu_torch.utils import resources as resutil

_HOSTNAME = apilabels.LABEL_HOSTNAME
_ZONE = apilabels.LABEL_TOPOLOGY_ZONE
# the walk's int keys: a group's index above a class ordinal, a label set
# id or a pair index
_SHIFT = 32
_MASK = (1 << _SHIFT) - 1


class _Walk:
    """The memos of one ``verify`` call, told apart by the ``check_of``
    closure the copy makes anew for each call."""

    __slots__ = ("check_of", "label_ids", "_reps", "_selector_ids",
                 "_selectors", "_matched", "_bound", "clean_options",
                 "spread_constraints")

    def __init__(self, check_of):
        self.check_of = check_of
        self.label_ids: Dict[frozenset, int] = {}
        self._reps: List[dict] = []
        self._selector_ids: Dict[object, int] = {}
        self._selectors: list = []
        self._matched: Dict[tuple, bool] = {}
        self._bound = None
        self.clean_options: Dict[tuple, list] = {}
        self.spread_constraints = 0

    def intern(self, labels) -> int:
        """The id of a distinct label set."""
        labels = labels or {}
        key = frozenset(labels.items())
        got = self.label_ids.get(key)
        if got is None:
            got = self.label_ids[key] = len(self._reps)
            self._reps.append(labels)
        return got

    def selector(self, selector) -> int:
        got = self._selector_ids.get(selector)
        if got is None:
            got = self._selector_ids[selector] = len(self._selectors)
            self._selectors.append(selector)
        return got

    def matches(self, si: int, ls: int) -> bool:
        got = self._matched.get((si, ls))
        if got is None:
            got = self._matched[si, ls] = self._selectors[si].matches(
                self._reps[ls])
        return got

    def bound_pods(self, verifier) -> Dict[tuple, int]:
        """The topology context's counted pods by (label set, zone), in
        the order their first pod comes: the copy's per-constraint scan
        of ``existing_pods``, done once."""
        if self._bound is None:
            topo = verifier.topology
            self._bound = bound = {}
            for p, labels, name in topo.existing_pods:
                if p.uid in topo.excluded_pods:
                    continue
                z = labels.get(_ZONE)
                if z is None:
                    node = verifier.existing_by_name.get(name)
                    z = node.labels.get(_ZONE) if node is not None else None
                if z is None:
                    continue
                key = (self.intern(p.metadata.labels), z)
                bound[key] = bound.get(key, 0) + 1
        return self._bound


class VerifyPass(ResultVerifier):
    """The copy's verifier with the spread, anti-affinity and
    foreign-option checks walked once; the same violations, in the same
    order, for every result."""

    _walk_of = None

    def _walk(self, check_of) -> _Walk:
        w = self._walk_of
        if w is None or w.check_of is not check_of:
            w = self._walk_of = _Walk(check_of)
        return w

    def take_counts(self) -> Dict[str, int]:
        """How far the last ``verify`` call's memos engaged, once:
        ``spread_constraints``, the distinct hard constraints tallied, and
        ``label_sets``, the distinct label sets whose selector matches
        were computed (both 0 for a call that needed neither)."""
        w, self._walk_of = self._walk_of, None
        if w is None:
            return {"spread_constraints": 0, "label_sets": 0}
        return {"spread_constraints": w.spread_constraints,
                "label_sets": len(w.label_ids)}

    # -- per-group checks --------------------------------------------------

    def _verify_claim(self, label, claim, check_of) -> List[Violation]:
        out: List[Violation] = []
        pool = claim.template.nodepool_name
        catalog_names = self._pool_catalog_names.get(pool)
        if catalog_names is None:
            return [Violation(
                "structure", f"{label} targets unknown nodepool {pool!r}"
            )]
        # an option list equal to one this call found clean names the same
        # types (InstanceType equality compares names): the copy's name
        # test runs once per distinct list and length
        options = claim.instance_type_options
        clean = self._walk(check_of).clean_options
        if clean.get((pool, len(options))) != options:
            foreign = [
                it.name for it in options if it.name not in catalog_names
            ]
            if foreign:
                out.append(Violation(
                    "structure",
                    f"{label} offers instance types outside nodepool"
                    f" {pool!r}'s catalog: {foreign[:3]}",
                ))
            else:
                clean[pool, len(options)] = options
        if not claim.instance_type_options:
            out.append(Violation(
                "capacity", f"{label} retains no instance-type option"
            ))
            return out

        totals = dict(self._overhead(claim.template))
        hard_taints = _hard_taints(claim.template.taints)
        class_counts = self._bucket_group_pods(
            label, claim.pods, totals, hard_taints, check_of, out
        )
        for c, n in class_counts.values():
            for name, qty in c.requests.items():
                totals[name] = totals.get(name, 0.0) + qty * n
            out.extend(self._check_pod_on_claim(
                label, claim, c, hard_taints
            ))
        fits_one = any(
            _fits_with_tolerance(totals, it.allocatable())
            for it in claim.instance_type_options
        )
        if not fits_one:
            out.append(Violation(
                "capacity",
                f"{label} requests {resutil.to_string(totals)} exceed every"
                f" surviving option"
                f" ({[it.name for it in claim.instance_type_options][:3]})",
            ))
        out.extend(self._check_offerings(label, claim))
        if any(c.anti_terms for c, _n in class_counts.values()):
            out.extend(self._check_anti_affinity(
                label, claim.pods, check_of
            ))
        return out

    def _check_anti_affinity(self, label, group_pods, check_of):
        out: List[Violation] = []
        if len(group_pods) < 2:
            return out
        in_group: dict = {}  # selector -> matching pods of the group
        for p in group_pods:
            if p.affinity is None:  # no anti-affinity term
                continue
            for term in check_of(p).anti_terms:
                selector = term.label_selector
                matches = in_group.get(selector)
                if matches is None:
                    matches = in_group[selector] = sum(
                        1 for q in group_pods
                        if selector.matches(q.metadata.labels or {})
                    )
                # the pod itself may match its own selector (self-anti):
                # any OTHER match on the same host is the violation
                own = 1 if selector.matches(p.metadata.labels or {}) else 0
                if matches > own or (own and matches > 1):
                    out.append(Violation(
                        "anti_affinity",
                        f"{label}: pod {p.metadata.name!r} co-located with"
                        " a pod matching its required hostname"
                        " anti-affinity selector",
                    ))
                    break
        return out

    # -- topology spread ---------------------------------------------------

    def _verify_spread(self, results, check_of) -> List[Violation]:
        out: List[Violation] = []
        w = self._walk(check_of)
        intern = w.intern
        claims = results.new_node_claims
        sims = results.existing_nodes
        group_pods = [c.pods for c in claims] + [s.pods for s in sims]

        # the one walk over the pods: each group's pods counted by class (a
        # pod with spread constraints) or by label set (one without, whose
        # class carries none), under int keys (group << _SHIFT | ordinal),
        # so that the walk leaves the collector no object a group
        classes: list = []  # first-seen order, the copy's constraint order
        ordinal: Dict[int, int] = {}
        class_n: Dict[int, int] = {}
        set_n: Dict[int, int] = {}
        for gi, pods in enumerate(group_pods):
            base = gi << _SHIFT
            for p in pods:
                if p.topology_spread_constraints:
                    c = check_of(p)
                    o = ordinal.get(id(c))
                    if o is None:
                        o = ordinal[id(c)] = len(classes)
                        classes.append(c)
                    k = base | o
                    class_n[k] = class_n.get(k, 0) + 1
                else:
                    k = base | intern(p.metadata.labels)
                    set_n[k] = set_n.get(k, 0) + 1

        constraints: dict = {}
        for c in classes:
            for cons in c.spread_hard:
                constraints.setdefault(
                    (cons.topology_key, cons.label_selector, cons.max_skew),
                    cons,
                )
        w.spread_constraints = len(constraints)
        # the (topology key, selector) pairs the copy checks; a
        # constraint's max_skew is not part of what a pod carries
        pairs: Dict[tuple, int] = {}
        for key, selector, _skew in constraints:
            if selector is not None and key in (_HOSTNAME, _ZONE):
                pairs.setdefault((key, selector), len(pairs))
        if not pairs:
            return out
        sel_of = [w.selector(sel) for _key, sel in pairs]
        is_zone = [key == _ZONE for key, _sel in pairs]

        # per class, bit masks over the pairs: the hostname pairs it
        # carries and matches, the zone pairs it matches, and those it
        # matches without carrying; per zone pair, the eligible zones: the
        # allowed zones of the classes that carry and match it
        host_bits: List[int] = []
        zone_bits: List[int] = []
        loose_bits: List[int] = []
        eligible = [set() for _ in pairs]
        for c in classes:
            carries = {
                pairs.get((cons.topology_key, cons.label_selector))
                for cons in c.spread_hard
            }
            ls = intern(c.pod.metadata.labels)
            host = zone = loose = 0
            allowed = None
            for pi, si in enumerate(sel_of):
                if not w.matches(si, ls):
                    continue
                if not is_zone[pi]:
                    if pi in carries:
                        host |= 1 << pi
                    continue
                zone |= 1 << pi
                if pi in carries:
                    if allowed is None:
                        allowed = self._allowed_zones(c)
                    eligible[pi] |= allowed
                else:
                    loose |= 1 << pi
            host_bits.append(host)
            zone_bits.append(zone)
            loose_bits.append(loose)

        # per (pair << _SHIFT | group): the carrying matching pods of a
        # hostname pair, the matching pods of a zone pair, and whether a
        # match of the zone pair does not carry its constraint
        host_n: Dict[int, int] = {}
        zone_n: Dict[int, int] = {}
        loose_at: set = set()
        for k, n in class_n.items():
            gi, o = k >> _SHIFT, k & _MASK
            for pi in _bits(host_bits[o]):
                key = pi << _SHIFT | gi
                host_n[key] = host_n.get(key, 0) + n
            for pi in _bits(zone_bits[o]):
                key = pi << _SHIFT | gi
                zone_n[key] = zone_n.get(key, 0) + n
            for pi in _bits(loose_bits[o]):
                loose_at.add(pi << _SHIFT | gi)
        set_zone: Dict[int, int] = {}  # label set -> zone pairs it matches
        for k, n in set_n.items():
            gi, ls = k >> _SHIFT, k & _MASK
            bits = set_zone.get(ls)
            if bits is None:
                bits = set_zone[ls] = sum(
                    1 << pi for pi, si in enumerate(sel_of)
                    if is_zone[pi] and w.matches(si, ls))
            for pi in _bits(bits):
                key = pi << _SHIFT | gi
                zone_n[key] = zone_n.get(key, 0) + n
                loose_at.add(key)

        zones = []  # each group's single zone, or None
        for claim in claims:
            zone = None
            if claim.requirements.has(_ZONE):
                zvals = claim.requirements[_ZONE].sorted_values()
                if len(zvals) == 1:
                    zone = zvals[0]
            zones.append(zone)
        for sim in sims:
            node = self.existing_by_name.get(sim.name)
            zones.append(
                node.labels.get(_ZONE) if node is not None else None)

        def label(gi):
            if gi < len(claims):
                return f"claim[{gi}]"
            return f"node[{sims[gi - len(claims)].name}]"

        for key, selector, max_skew in constraints:
            pi = pairs.get((key, selector)) if selector is not None else None
            if pi is None:
                continue
            base = pi << _SHIFT
            if key == _HOSTNAME:
                for gi in range(len(group_pods)):
                    n = host_n.get(base | gi, 0)
                    if n > max_skew:
                        out.append(Violation(
                            "spread",
                            f"{label(gi)}: {n} pods matching hostname spread"
                            f" {selector} exceed maxSkew {max_skew}",
                        ))
                continue
            counts: Dict[str, int] = {}
            attributable = True
            for gi, zone in enumerate(zones):
                m = zone_n.get(base | gi)
                if m is None:
                    continue
                # a cohort with a matching pod that does not carry the
                # constraint, or a group of no single zone: the copy
                # skips the constraint (soundness over completeness)
                if zone is None or base | gi in loose_at:
                    attributable = False
                    break
                counts[zone] = counts.get(zone, 0) + m
            if not attributable or not counts:
                continue
            if self.topology is not None:
                si = sel_of[pi]
                for (ls, z), n in w.bound_pods(self).items():
                    if w.matches(si, ls):
                        counts[z] = counts.get(z, 0) + n
            domains = eligible[pi] & self._zone_universe or eligible[pi]
            if not domains:
                continue
            low = min(counts.get(z, 0) for z in domains)
            high = max(counts.get(z, 0) for z in domains)
            if high - low > max_skew:
                out.append(Violation(
                    "spread",
                    f"zone spread {selector}: domain counts {counts}"
                    f" skew {high - low} > maxSkew {max_skew}",
                ))
        return out


def _bits(mask: int):
    """The positions of a mask's set bits, lowest first."""
    while mask:
        low = mask & -mask
        yield low.bit_length() - 1
        mask ^= low
