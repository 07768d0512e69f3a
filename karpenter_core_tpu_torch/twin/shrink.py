"""Scenario fuzzing + failing-scenario shrinking.

The robustness payoff of the twin: ``fuzz`` sweeps seeds over a scenario
shape; when any run trips an invariant, ``shrink`` minimizes the scenario
while the SAME invariant keeps tripping — dropping the fleet tier, spare
clusters, fault events, storms, workload waves and rate keys, halving
wave sizes, truncating the schedule to just past the first violation —
and the minimal scenario serializes to a JSON repro (``save_repro``) that
``replay`` re-runs byte-deterministically. A solver regression found by a
fuzz soak becomes a committed fixture-driven test, not a flaky memory.

Shrinking is MONOTONE because every random stream is independently
seeded: chaos seams draw from per-seam child RNGs (chaos.ChaosSchedule),
workload waves from per-wave child RNGs (twin/workloads.py) — removing
one element never reshuffles the draws of the survivors.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Iterable, Iterator, List, Optional

from karpenter_core_tpu_torch.twin.harness import TWIN_EPOCH, TwinResult, run_scenario
from karpenter_core_tpu_torch.twin.scenario import (
    Scenario,
    encode_scenario,
    scenario_from_json,
    validate_scenario,
)


def fuzz(
    base: Scenario,
    seeds: Iterable[int],
    stop_after: int = 1,
    **run_kwargs,
) -> List[TwinResult]:
    """Run the scenario shape under each seed; returns the FAILING results
    (stops after ``stop_after`` failures — the shrinker wants one)."""
    failing: List[TwinResult] = []
    for seed in seeds:
        result = run_scenario(
            dataclasses.replace(base, seed=seed), **run_kwargs
        )
        if not result.ok:
            failing.append(result)
            if stop_after and len(failing) >= stop_after:
                break
    return failing


def _still_fails(scenario: Scenario, invariant: str, run_kwargs) -> bool:
    try:
        validate_scenario(scenario)
    except ValueError:
        return False
    result = run_scenario(scenario, **run_kwargs)
    return any(v.invariant == invariant for v in result.violations)


def _without_index(items: tuple, i: int) -> tuple:
    return items[:i] + items[i + 1:]


def _candidates(s: Scenario) -> Iterator[Scenario]:
    """Strictly-smaller variants, cheapest-win first. Every candidate is
    a COMPLETE scenario (the predicate re-runs it from scratch), so a
    rejected candidate costs one run and changes nothing."""
    # drop the whole fleet tier (and its faults): if the violation
    # survives on the in-proc greedy path, the repro needs no tier at all
    if s.fleet:
        yield dataclasses.replace(
            s, fleet=0, solver="greedy", fleet_faults=()
        )
    # drop the highest cluster when nothing references it anymore
    if s.clusters > 1:
        top = s.clusters - 1
        used = {w.cluster for w in s.waves} | {h.cluster for h in s.hooks}
        if top not in used:
            yield dataclasses.replace(
                s,
                clusters=top,
                storms=tuple(
                    st for st in s.storms if st.cluster != top
                ),
                fleet_faults=tuple(
                    f for f in s.fleet_faults if f.cluster != top
                ),
            )
    for i in range(len(s.fleet_faults)):
        yield dataclasses.replace(
            s, fleet_faults=_without_index(s.fleet_faults, i)
        )
    for i in range(len(s.storms)):
        yield dataclasses.replace(s, storms=_without_index(s.storms, i))
    if s.rates:
        yield dataclasses.replace(s, rates={})
        for key in sorted(s.rates):
            rest = {k: v for k, v in sorted(s.rates.items()) if k != key}
            yield dataclasses.replace(s, rates=rest)
    for i in range(len(s.waves)):
        yield dataclasses.replace(s, waves=_without_index(s.waves, i))
    for i, wave in enumerate(s.waves):
        if wave.kind == "training":
            # counts stay positive gang_size multiples (validate pins it)
            floor = wave.gang_size
            halved = (wave.count // 2 // wave.gang_size) * wave.gang_size
        else:
            floor = 1
            halved = wave.count // 2
        if wave.count > floor:
            smaller = dataclasses.replace(wave, count=max(halved, floor))
            yield dataclasses.replace(
                s, waves=s.waves[:i] + (smaller,) + s.waves[i + 1:]
            )
    if s.duration > s.tick:
        yield dataclasses.replace(
            s, duration=max(s.duration / 2, s.tick)
        )


def _truncated(s: Scenario, result: TwinResult, invariant: str) -> Scenario:
    """Cut the schedule just past the first violation of the invariant —
    the single biggest shrink, taken straight from the failing run."""
    firsts = [
        v.at - TWIN_EPOCH
        for v in result.violations
        if v.invariant == invariant
    ]
    if not firsts:
        return s
    cutoff = min(math.ceil(min(firsts) / s.tick) * s.tick, s.duration)
    if cutoff >= s.duration:
        return s
    return dataclasses.replace(s, duration=cutoff)


def shrink(
    scenario: Scenario,
    invariant: Optional[str] = None,
    max_runs: int = 120,
    **run_kwargs,
) -> Scenario:
    """Greedy fixpoint minimization: keep any strictly-smaller candidate
    that still trips the (first) violated invariant; stop when a full
    candidate sweep makes no progress or the run budget is spent."""
    result = run_scenario(scenario, **run_kwargs)
    if result.ok:
        raise ValueError(
            "scenario does not violate any invariant; nothing to shrink"
        )
    invariant = invariant or result.violations[0].invariant
    runs = 1
    current = scenario
    candidate = _truncated(current, result, invariant)
    if candidate is not current and runs < max_runs:
        runs += 1
        if _still_fails(candidate, invariant, run_kwargs):
            current = candidate
    progress = True
    while progress and runs < max_runs:
        progress = False
        for candidate in _candidates(current):
            if runs >= max_runs:
                break
            runs += 1
            if _still_fails(candidate, invariant, run_kwargs):
                current = candidate
                progress = True
                break
    return current


def save_repro(scenario: Scenario, path: str) -> None:
    """Write the scenario as the committed-fixture JSON form (stable key
    order; human-readable indent — the canonical compact form is what
    fingerprints, both decode identically)."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(encode_scenario(scenario), f, sort_keys=True, indent=1)
        f.write("\n")


def replay(path: str, **run_kwargs) -> TwinResult:
    """Re-run a committed repro fixture; byte-deterministic per the twin's
    identical-seed contract."""
    with open(path, "r", encoding="utf-8") as f:
        scenario = scenario_from_json(f.read())
    return run_scenario(scenario, **run_kwargs)
