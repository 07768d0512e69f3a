"""Consolidation command validation after the 15s TTL
(reference: pkg/controllers/disruption/validation.go:56-215,
consolidation.go:46, emptiness.go:44-122).

A computed command is held for CONSOLIDATION_TTL before execution; the
cluster may change in that window (pods arriving, nominations, budget
drain). Validation then re-derives candidates and re-simulates:

* every command candidate must still pass the global candidate gates and
  the method's own predicate, with budget headroom;
* the re-simulation must reproduce the command's shape — zero fresh nodes
  for a delete, exactly one for a replace with the command's instance-type
  options a SUBSET of the fresh simulation's (the sim does no price
  filtering, so broader is fine; narrower or different means a better or
  different decision exists — recompute);
* emptiness skips the simulation and re-checks candidates are still empty.
"""
from __future__ import annotations

from typing import List, Optional

from karpenter_core_tpu_torch.controllers.disruption.helpers import (
    build_disruption_budget_mapping,
    get_candidates,
    simulate_scheduling,
)
from karpenter_core_tpu_torch.controllers.disruption.types import Command

CONSOLIDATION_TTL = 15.0  # consolidation.go:46


def validate_command(ctx, method, command: Command) -> Optional[str]:
    """None when still valid; otherwise the reason it is not."""
    fresh = get_candidates(
        ctx.clock,
        ctx.cluster,
        ctx.kube,
        ctx.cloud_provider,
        method.should_disrupt,
    )
    fresh_by_name = {c.name: c for c in fresh}
    validated = []
    for c in command.candidates:
        fc = fresh_by_name.get(c.name)
        if fc is None:
            return f"candidate {c.name} is no longer valid"
        validated.append(fc)

    budgets = build_disruption_budget_mapping(ctx.clock, ctx.cluster, ctx.kube)
    used: dict = {}
    for c in validated:
        pool = c.nodepool.name
        used[pool] = used.get(pool, 0) + 1
        if budgets.remaining(pool, method.reason) < used[pool]:
            return f"disruption budget exhausted for nodepool {pool!r}"

    if getattr(method, "validation", None) == "emptiness":
        # still-empty re-check only (emptiness.go:94-122)
        for c in validated:
            if c.reschedulable_pods:
                return f"candidate {c.name} is no longer empty"
        return None

    results = simulate_scheduling(ctx.provisioner, ctx.cluster, validated)
    candidate_pod_uids = {
        p.uid for c in validated for p in c.reschedulable_pods
    }
    for uid, msg in results.pod_errors.items():
        if uid in candidate_pod_uids:
            return f"candidate pods no longer schedule: {msg}"

    new_claims = [c for c in results.new_node_claims if c.pods]
    if len(new_claims) == 0:
        if not command.replacements:
            return None
        return "scheduling simulation produced new results"
    if len(new_claims) > 1 or not command.replacements:
        return "scheduling simulation produced new results"
    # replacement ITs must be a subset of the fresh simulation's options
    # (the sim does no price filtering, validation.go:195-214)
    fresh_names = {it.name for it in new_claims[0].instance_type_options}
    ours = {it.name for it in command.replacements[0].instance_type_options}
    if not ours <= fresh_names:
        return "scheduling simulation produced new results"
    return None
