"""Disruption methods: Emptiness, Drift, Single/Multi-node consolidation
(reference: pkg/controllers/disruption/{emptiness,drift,consolidation,
singlenodeconsolidation,multinodeconsolidation}.go).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.nodepool import (
    REASON_DRIFTED,
    REASON_EMPTY,
    REASON_UNDERUTILIZED,
)
from karpenter_core_tpu_torch.controllers.disruption.helpers import (
    BudgetMapping,
    simulate_scheduling,
)
from karpenter_core_tpu_torch.controllers.disruption.types import (
    Candidate,
    Command,
    is_consolidatable,
    is_drifted,
)
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.nodeclaimtemplate import (
    filter_instance_types,
)
from karpenter_core_tpu_torch.cloudprovider.types import order_by_price, satisfies_min_values
from karpenter_core_tpu_torch.scheduling import Requirement

MULTI_NODE_CONSOLIDATION_CANDIDATE_CAP = 100  # multinodeconsolidation.go:81
MIN_INSTANCE_TYPES_FOR_SPOT_TO_SPOT = 15  # consolidation.go:48-49


def filter_replacement_by_price(claim, max_price: float) -> None:
    """RemoveInstanceTypeOptionsByPriceAndMinValues (nodeclaim.go:136-145):
    keep instance types whose worst launch price under the claim's
    requirements is strictly cheaper than max_price; then re-check
    minValues. Mutates the in-flight claim's options."""
    kept = [
        it
        for it in claim.instance_type_options
        if 0.0
        < it.offerings.available().compatible(claim.requirements).worst_launch_price(
            claim.requirements
        )
        < max_price
    ]
    if claim.requirements.has_min_values():
        _, err = satisfies_min_values(kept, claim.requirements)
        if err is not None:
            kept = []
    claim.instance_type_options = kept


class Emptiness:
    """Zero reschedulable pods + Consolidatable: delete, no simulation
    (emptiness.go:44-122)."""

    reason = REASON_EMPTY
    consolidation_type = "empty"
    validation = "emptiness"  # TTL re-check: still empty (emptiness.go:94-122)

    def __init__(self, ctx):
        self.ctx = ctx

    def should_disrupt(self, c: Candidate) -> bool:
        if c.nodepool.spec.disruption.consolidate_after.is_never:
            return False
        return not c.reschedulable_pods and is_consolidatable(c)

    def compute_command(
        self, budgets: BudgetMapping, candidates: List[Candidate]
    ) -> Command:
        fits = []
        for c in sorted(candidates, key=lambda c: c.disruption_cost):
            if budgets.remaining(c.nodepool.name, self.reason) > 0:
                budgets.consume(c.nodepool.name, self.reason)
                fits.append(c)
        return Command(candidates=fits, reason=self.reason)


class Drift:
    """Drifted condition, oldest first; empties free, others must fully
    reschedule (drift.go:54-115)."""

    reason = REASON_DRIFTED
    consolidation_type = "drift"
    validation = None  # drift executes without a TTL window (drift.go)

    def __init__(self, ctx):
        self.ctx = ctx

    def should_disrupt(self, c: Candidate) -> bool:
        return is_drifted(c)

    def compute_command(
        self, budgets: BudgetMapping, candidates: List[Candidate]
    ) -> Command:
        def drift_time(c: Candidate) -> float:
            cond = c.node_claim.conditions.get("Drifted")
            return cond.last_transition_time if cond else 0.0

        candidates = sorted(candidates, key=drift_time)
        # empty drifted candidates batch together, consuming budget as the
        # batch builds (drift.go:66-80)
        empty = []
        for c in candidates:
            if c.reschedulable_pods:
                continue
            if budgets.remaining(c.nodepool.name, self.reason) > 0:
                budgets.consume(c.nodepool.name, self.reason)
                empty.append(c)
        if empty:
            return Command(candidates=empty, reason=self.reason)
        allowed = [
            c
            for c in candidates
            if budgets.remaining(c.nodepool.name, self.reason) > 0
        ]
        for c in allowed:
            results = simulate_scheduling(
                self.ctx.provisioner, self.ctx.cluster, [c]
            )
            if not results.all_pods_scheduled():
                continue
            budgets.consume(c.nodepool.name, self.reason)
            return Command(
                candidates=[c],
                replacements=results.new_node_claims,
                reason=self.reason,
            )
        return Command()


class _ConsolidationBase:
    """Shared simulate→price-filter pipeline (consolidation.go:133-304)."""

    reason = REASON_UNDERUTILIZED
    validation = "consolidation"  # 15s TTL re-simulation (validation.go)

    def __init__(self, ctx):
        self.ctx = ctx

    def should_disrupt(self, c: Candidate) -> bool:
        if c.instance_type is None:
            return False
        if apilabels.CAPACITY_TYPE_LABEL_KEY not in c.state_node.labels:
            return False
        if apilabels.LABEL_TOPOLOGY_ZONE not in c.state_node.labels:
            return False
        if c.nodepool.spec.disruption.consolidation_policy == "WhenEmpty":
            return not c.reschedulable_pods and is_consolidatable(c)
        return is_consolidatable(c)

    def compute_consolidation(
        self, candidates: List[Candidate]
    ) -> Tuple[Command, object]:
        """(consolidation.go:133-230)"""
        results = simulate_scheduling(
            self.ctx.provisioner, self.ctx.cluster, candidates
        )
        if not results.all_pods_scheduled():
            return Command(), results
        if len(results.new_node_claims) == 0:
            return Command(candidates=candidates, reason=self.reason), results
        if len(results.new_node_claims) != 1:
            return Command(), results

        replacement = results.new_node_claims[0]
        candidate_price = sum(c.price() for c in candidates)
        all_spot = all(
            c.capacity_type == apilabels.CAPACITY_TYPE_SPOT for c in candidates
        )
        replacement.instance_type_options = order_by_price(
            replacement.instance_type_options, replacement.requirements
        )

        ct_req = replacement.requirements.get(apilabels.CAPACITY_TYPE_LABEL_KEY)
        if all_spot and ct_req.has(apilabels.CAPACITY_TYPE_SPOT):
            return self._spot_to_spot(candidates, results, candidate_price)

        filter_replacement_by_price(replacement, candidate_price)
        if not replacement.instance_type_options:
            return Command(), results

        # OD -> [OD, spot]: force spot so insufficient spot capacity fails the
        # launch instead of replacing with pricier on-demand
        # (consolidation.go:211-218)
        if ct_req.has(apilabels.CAPACITY_TYPE_SPOT) and ct_req.has(
            apilabels.CAPACITY_TYPE_ON_DEMAND
        ):
            replacement.requirements.add(
                Requirement.new(
                    apilabels.CAPACITY_TYPE_LABEL_KEY,
                    "In",
                    [apilabels.CAPACITY_TYPE_SPOT],
                )
            )
        return (
            Command(
                candidates=candidates,
                replacements=[replacement],
                reason=self.reason,
            ),
            results,
        )

    def _spot_to_spot(
        self, candidates: List[Candidate], results, candidate_price: float
    ) -> Tuple[Command, object]:
        """(consolidation.go:226-304)"""
        if not self.ctx.feature_gates.get("SpotToSpotConsolidation", False):
            return Command(), results
        replacement = results.new_node_claims[0]
        replacement.requirements.add(
            Requirement.new(
                apilabels.CAPACITY_TYPE_LABEL_KEY,
                "In",
                [apilabels.CAPACITY_TYPE_SPOT],
            )
        )
        replacement.instance_type_options = filter_instance_types(
            replacement.instance_type_options, replacement.requirements, {}
        ).remaining
        filter_replacement_by_price(replacement, candidate_price)
        if not replacement.instance_type_options:
            return Command(), results
        if len(candidates) > 1:
            return (
                Command(
                    candidates=candidates,
                    replacements=[replacement],
                    reason=self.reason,
                ),
                results,
            )
        # single-node: require 15 cheaper options, truncate to 15 so the
        # launched type stays inside the set (no consolidation churn)
        if len(replacement.instance_type_options) < MIN_INSTANCE_TYPES_FOR_SPOT_TO_SPOT:
            return Command(), results
        cap = MIN_INSTANCE_TYPES_FOR_SPOT_TO_SPOT
        if replacement.requirements.has_min_values():
            n, _ = satisfies_min_values(
                replacement.instance_type_options, replacement.requirements
            )
            cap = max(cap, n or 0)
        replacement.instance_type_options = replacement.instance_type_options[:cap]
        return (
            Command(
                candidates=candidates,
                replacements=[replacement],
                reason=self.reason,
            ),
            results,
        )

    def _budget_filter(
        self, budgets: BudgetMapping, candidates: List[Candidate]
    ) -> List[Candidate]:
        out = []
        used: Dict[str, int] = {}
        for c in candidates:
            pool = c.nodepool.name
            if budgets.remaining(pool, self.reason) - used.get(pool, 0) > 0:
                used[pool] = used.get(pool, 0) + 1
                out.append(c)
        return out


# singlenodeconsolidation.go:30 — per-poll budget on host simulations
SINGLE_NODE_CONSOLIDATION_TIMEOUT = 3 * 60.0


class SingleNodeConsolidation(_ConsolidationBase):
    """One candidate at a time, bounded per poll
    (singlenodeconsolidation.go:29-101): a 3-minute wall-clock budget stops
    the sweep mid-list, and a persistent resume cursor rotates the starting
    candidate across polls so the tail of a large cluster is eventually
    evaluated instead of being starved behind the same cheap prefix.

    The cursor is a STABLE KEY — (candidate name, disruption cost) of the
    next candidate to evaluate — not an index: the candidate list is
    re-collected and re-sorted every poll, so under churn an index silently
    points at a different node and the tail can be starved forever. If the
    named candidate is gone by the next poll, the sweep resumes at the
    first candidate at or past the remembered cost (the list is
    cost-sorted), preserving round-robin progress through the tail."""

    consolidation_type = "single"

    def __init__(self, ctx):
        super().__init__(ctx)
        self._resume_key: Optional[Tuple[str, float]] = None

    def _resume_index(self, candidates: List[Candidate]) -> int:
        if self._resume_key is None:
            return 0
        name, cost = self._resume_key
        for i, c in enumerate(candidates):
            if c.name == name:
                return i
        for i, c in enumerate(candidates):
            if c.disruption_cost >= cost:
                return i
        return 0

    def compute_command(
        self, budgets: BudgetMapping, candidates: List[Candidate]
    ) -> Command:
        from karpenter_core_tpu_torch.metrics import wiring as m

        candidates = self._budget_filter(
            budgets, sorted(candidates, key=lambda c: c.disruption_cost)
        )
        if not candidates:
            return Command()
        start = self._resume_index(candidates)
        rotated = candidates[start:] + candidates[:start]
        deadline = self.ctx.clock.now() + SINGLE_NODE_CONSOLIDATION_TIMEOUT

        def remember(idx: int) -> None:
            nxt = rotated[idx % len(rotated)]
            self._resume_key = (nxt.name, nxt.disruption_cost)

        for i, c in enumerate(rotated):
            if self.ctx.clock.now() > deadline:
                m.CONSOLIDATION_TIMEOUTS.inc(
                    {"consolidation_type": self.consolidation_type}
                )
                # resume AT the first candidate NOT evaluated this poll
                remember(i)
                return Command()
            cmd, _ = self.compute_consolidation([c])
            if cmd.decision != "no-op":
                budgets.consume(c.nodepool.name, self.reason)
                remember(i + 1)
                return cmd
        self._resume_key = None  # full coverage; restart at the cheapest
        return Command()


class MultiNodeConsolidation(_ConsolidationBase):
    """Largest consolidatable prefix. With the tpu solver the whole prefix
    ladder is evaluated in ONE vmapped device call
    (models/consolidation.py); the reference's binary search of full
    scheduling simulations (multinodeconsolidation.go:110-162) is the
    host fallback."""

    consolidation_type = "multi"

    def compute_command(
        self, budgets: BudgetMapping, candidates: List[Candidate]
    ) -> Command:
        candidates = self._budget_filter(
            budgets, sorted(candidates, key=lambda c: c.disruption_cost)
        )[:MULTI_NODE_CONSOLIDATION_CANDIDATE_CAP]
        if len(candidates) < 2:
            return Command()
        best = Command()
        frontier_sizes = None
        if self.ctx.provisioner.solver == "tpu":
            frontier_sizes = self._device_frontier(candidates)
        if frontier_sizes:
            passing, dubious = frontier_sizes
            # host-exact validation (price filters, spot rules) walks the
            # device-viable ladder: the largest few outright, then a binary
            # search over the REMAINING viable sizes — never the full [2,n]
            # range the reference probes (host validity is monotone in
            # prefix size, the same assumption its binary search makes)
            head, tail = passing[:4], passing[4:]
            for size in head:
                ok, cmd = self._host_validate(candidates, size)
                if ok:
                    best = cmd
                    break
            if best.decision == "no-op" and tail:
                asc = tail[::-1]  # ascending sizes
                lo, hi = 0, len(asc) - 1
                while lo <= hi:
                    mid = (lo + hi) // 2
                    ok, cmd = self._host_validate(candidates, asc[mid])
                    if ok:
                        best = cmd
                        lo = mid + 1
                    else:
                        hi = mid - 1
            if best.decision == "no-op" and dubious:
                # the device price bound said these sizes can't beat the
                # candidates' price, but the bound is only sound when the
                # device packed the fresh node like the host would — probe
                # the largest once; if the bound was wrong, search them all
                ok, cmd = self._host_validate(candidates, dubious[0])
                if ok:
                    best = cmd
                elif len(dubious) > 1:
                    asc = dubious[::-1]
                    lo, hi = 0, len(asc) - 2  # largest already probed
                    while lo <= hi:
                        mid = (lo + hi) // 2
                        ok, cmd = self._host_validate(candidates, asc[mid])
                        if ok:
                            best = cmd
                            lo = mid + 1
                        else:
                            hi = mid - 1
        if best.decision == "no-op":
            if frontier_sizes == ([], []):
                # the device proved no prefix schedulable, but its FFD is
                # conservative (sub-unit ceil/floor quantization, first-fit
                # rather than emptiest-first), so probe the easiest host prefix
                # once; under the monotonicity the binary search itself
                # assumes (larger prefixes only harder), a failed size-2
                # probe means nothing larger passes — steady-state cycles
                # pay ONE sim, not log2(n)
                ok, cmd = self._host_validate(candidates, 2)
                if ok:
                    best = cmd
                    best = self._binary_search(candidates, 3, best)
            elif frontier_sizes is None:
                # no frontier available (topology-coupled pods): reference
                # binary search; lo=2 keeps the >=2-candidate invariant
                # (multinodeconsolidation.go:111-118 never probes below a
                # 2-candidate prefix — size 1 belongs to
                # SingleNodeConsolidation)
                best = self._binary_search(candidates, 2, best)
            # a non-empty frontier whose every size failed host (price)
            # validation deliberately ends the cycle no-op: sizes outside
            # the device-viable set face the same price filters, and
            # SingleNodeConsolidation sweeps up the small wins next poll
        if best.decision != "no-op":
            for c in best.candidates:
                budgets.consume(c.nodepool.name, self.reason)
        return best

    def _binary_search(
        self, candidates: List[Candidate], lo: int, best: Command
    ) -> Command:
        """Largest host-valid prefix in [lo, len(candidates)]
        (multinodeconsolidation.go:110-162)."""
        hi = len(candidates)
        while lo <= hi:
            mid = (lo + hi) // 2
            ok, cmd = self._host_validate(candidates, mid)
            if ok:
                best = cmd
                lo = mid + 1
            else:
                hi = mid - 1
        return best

    def _host_validate(
        self, candidates: List[Candidate], size: int
    ) -> Tuple[bool, Command]:
        prefix = candidates[:size]
        cmd, _ = self.compute_consolidation(prefix)
        ok = cmd.decision == "delete"
        if cmd.decision == "replace":
            self._filter_out_same_type(cmd.replacements[0], prefix)
            ok = bool(cmd.replacements[0].instance_type_options)
        return ok, cmd

    def _device_frontier(self, candidates: List[Candidate]):
        """(passing, dubious) prefix-size lists, each largest-first, from
        the one-call device evaluation; None -> fall back to binary search.
        `passing` sizes beat the device price lower bound; `dubious` sizes
        did not, but stay reachable because the bound is only sound when
        the device packed the fresh node the way the host would."""
        from karpenter_core_tpu_torch.models.consolidation import (
            schedulability_frontier,
        )

        frontier = schedulability_frontier(
            self.ctx.provisioner, self.ctx.cluster, candidates
        )
        if frontier is None:
            return None
        # viable prefixes: everything reschedules into at most one new node
        # AND the device price lower bound undercuts the prefix's summed
        # candidate price — a replacement at or above it would fail the
        # host's cheaper-than-candidates filter anyway, so those sizes never
        # reach a host simulation (SURVEY §7.7's device-side price filter)
        prefix_price = []
        acc = 0.0
        for c in candidates:
            acc += c.price()
            prefix_price.append(acc)
        passing, dubious = [], []
        for p, (ok, n_new, price_lb) in enumerate(frontier):
            if not ok or n_new > 1:
                continue
            if n_new == 0 or price_lb < prefix_price[p]:
                passing.append(p + 1)
            else:
                dubious.append(p + 1)
        passing.sort(reverse=True)
        dubious.sort(reverse=True)
        return passing, dubious

    @staticmethod
    def _filter_out_same_type(replacement, consolidate: List[Candidate]) -> None:
        """If the replacement's options include a type being removed, cap the
        price below the cheapest same-type candidate
        (multinodeconsolidation.go:164-217)."""
        existing = set()
        price_by_type: Dict[str, float] = {}
        for c in consolidate:
            if c.instance_type is None:
                continue
            existing.add(c.instance_type.name)
            p = c.price()
            if p > 0:
                price_by_type[c.instance_type.name] = min(
                    price_by_type.get(c.instance_type.name, math.inf), p
                )
        max_price = math.inf
        for it in replacement.instance_type_options:
            if it.name in existing and it.name in price_by_type:
                max_price = min(max_price, price_by_type[it.name])
        filter_replacement_by_price(replacement, max_price)
