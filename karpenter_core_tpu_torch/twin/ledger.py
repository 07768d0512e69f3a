"""The twin's judge: $-cost, SLO, preemption burn and tier utilization
accumulated over VIRTUAL time.

Every per-solve microbench so far reports p50s; the ledger reports what
the paper's closed loop actually buys — the integral of fleet node cost
over time, time-to-bind percentiles per workload class, how much
preemption budget the run burned, and how the solver tier's work spread
across members. Everything here is derived from virtual timestamps and
deterministic counts, NEVER wall time or process-global metric absolutes
(metric deltas are taken by the harness against run-start baselines), so
``to_json`` is byte-identical across two runs of one scenario — the
determinism contract the twin's tests pin alongside the event trace.

GL201/GL202 cover this module's encode path: unordered iteration in the
serialization would silently break that contract.
"""
from __future__ import annotations

import json
from typing import Dict, List

from karpenter_core_tpu_torch.api import labels as apilabels

SECONDS_PER_HOUR = 3600.0


def price_index(catalog) -> Dict[tuple, float]:
    """(instance_type, zone, capacity_type) -> $/hour over one catalog."""
    prices: Dict[tuple, float] = {}
    for it in catalog:
        for offering in it.offerings:
            prices[tuple(offering.key(it.name))] = offering.price
    return prices


def node_price(node, prices: Dict[tuple, float]) -> float:
    key = (
        node.labels.get(apilabels.LABEL_INSTANCE_TYPE, ""),
        node.labels.get(apilabels.LABEL_TOPOLOGY_ZONE, ""),
        node.labels.get(apilabels.CAPACITY_TYPE_LABEL_KEY, ""),
    )
    return prices.get(key, 0.0)


def _percentile(sorted_values: List[float], q: float) -> float:
    """Deterministic nearest-rank percentile over an already-sorted list."""
    if not sorted_values:
        return 0.0
    rank = max(int(q * len(sorted_values) + 0.5) - 1, 0)
    return sorted_values[min(rank, len(sorted_values) - 1)]


class Ledger:
    def __init__(self):
        # cluster -> accumulated $·hours (price integral over virtual time)
        self.cost_dollar_hours: Dict[int, float] = {}
        # cluster -> peak concurrent nodes seen at any tick
        self.peak_nodes: Dict[int, int] = {}
        # cluster -> accumulated node·seconds (node-count integral over
        # virtual time): the node-quality surface the incremental
        # re-solve drift judge compares against a fresh-solve twin run
        # (incsolve, ISSUE 16 — mean_nodes = node_seconds / duration)
        self.node_seconds: Dict[int, float] = {}
        # workload class -> list of time-to-bind seconds (virtual)
        self.bind_latencies: Dict[str, List[float]] = {}
        self.ticks = 0
        self.virtual_seconds = 0.0
        # elastic solver tier (fleetscale, ISSUE 17): member-count
        # integral over virtual time — the tier-$ half of the drift
        # judge's node-$ + tier-$ score against a fixed-size control
        # (mean_members = member_seconds / duration)
        self.member_seconds = 0.0
        self.peak_members = 0
        # gang network spread (topoaware, ISSUE 20): per-cluster PEAK
        # intra-gang hop distance over rack-attributable bound members,
        # and gang·ticks spent straggler-exposed (a gang spanning >= 2
        # hops — beyond one superpod — at a stable tick). Recorded per
        # run; stragglers-AVOIDED is the delta against a distance-blind
        # control run of the same scenario (bench cfg18 / twin tests).
        # Rack-less runs record {} / 0 — nothing to attribute.
        self.gang_max_hops: Dict[int, int] = {}
        self.straggler_gang_ticks = 0
        # filled by the harness at finish() from metric deltas/tier state
        self.preemption_evictions = 0
        self.slo_misses = 0
        self.utilization: Dict[str, object] = {}

    # -- accumulation ------------------------------------------------------

    def sample(
        self, dt: float, operators, price_indices, tier_members: int = 0
    ) -> None:
        """One tick's cost integral: each cluster's live nodes priced from
        ITS catalog, charged for dt virtual seconds; the solver tier's
        live member count charged the same way (member·seconds)."""
        self.ticks += 1
        self.virtual_seconds += dt
        self.member_seconds += tier_members * dt
        self.peak_members = max(self.peak_members, tier_members)
        for cluster, op in enumerate(operators):
            prices = price_indices[cluster]
            nodes = op.kube.list_nodes()
            rate = sum(node_price(n, prices) for n in nodes)
            self.cost_dollar_hours[cluster] = (
                self.cost_dollar_hours.get(cluster, 0.0)
                + rate * dt / SECONDS_PER_HOUR
            )
            self.peak_nodes[cluster] = max(
                self.peak_nodes.get(cluster, 0), len(nodes)
            )
            self.node_seconds[cluster] = (
                self.node_seconds.get(cluster, 0.0) + len(nodes) * dt
            )
            self._sample_gang_hops(cluster, op, nodes)

    def _sample_gang_hops(self, cluster: int, op, nodes) -> None:
        """One tick's gang network spread: max pairwise hop distance per
        bound gang, measured over members on rack-labeled nodes only (on
        a rack-less catalog there is nothing to attribute, so legacy
        runs' ledgers gain only constant keys)."""
        from karpenter_core_tpu_torch.solver import gangs as gangmod
        from karpenter_core_tpu_torch.twin import workloads

        by_name = {n.name: n for n in nodes}
        placements: Dict[str, List[dict]] = {}
        for pod in op.kube.list_pods():
            if not pod.node_name:
                continue
            gang = workloads.gang_of(pod)
            node = by_name.get(pod.node_name)
            if not gang or node is None:
                continue
            labels = dict(node.labels or {})
            if labels.get(apilabels.LABEL_TOPOLOGY_RACK):
                placements.setdefault(gang, []).append(labels)
        for gang in sorted(placements):
            placed = placements[gang]
            if len(placed) < 2:
                continue
            worst = max(
                gangmod.hop_distance(a, b)
                for i, a in enumerate(placed)
                for b in placed[i + 1:]
            )
            self.gang_max_hops[cluster] = max(
                self.gang_max_hops.get(cluster, 0), worst
            )
            if worst >= 2:
                self.straggler_gang_ticks += 1

    def record_bind(self, workload_class: str, latency_s: float) -> None:
        self.bind_latencies.setdefault(workload_class, []).append(latency_s)

    # -- reporting ---------------------------------------------------------

    def slo(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for cls in sorted(self.bind_latencies):
            values = sorted(self.bind_latencies[cls])
            out[cls] = {
                "n": len(values),
                "p50_s": round(_percentile(values, 0.50), 6),
                "p95_s": round(_percentile(values, 0.95), 6),
                "max_s": round(values[-1], 6) if values else 0.0,
            }
        return out

    def encode(self) -> dict:
        """Canonical ledger dict (stable keys, sorted iteration, rounded
        floats): the byte-determinism surface."""
        return {
            "cost_dollar_hours": {
                str(cluster): round(self.cost_dollar_hours[cluster], 6)
                for cluster in sorted(self.cost_dollar_hours)
            },
            "peak_nodes": {
                str(cluster): self.peak_nodes[cluster]
                for cluster in sorted(self.peak_nodes)
            },
            "node_seconds": {
                str(cluster): round(self.node_seconds[cluster], 6)
                for cluster in sorted(self.node_seconds)
            },
            "gang_max_hops": {
                str(cluster): self.gang_max_hops[cluster]
                for cluster in sorted(self.gang_max_hops)
            },
            "straggler_gang_ticks": self.straggler_gang_ticks,
            "slo": self.slo(),
            "slo_misses": self.slo_misses,
            "preemption_evictions": self.preemption_evictions,
            "utilization": self.utilization,
            "ticks": self.ticks,
            "virtual_seconds": round(self.virtual_seconds, 6),
            "member_seconds": round(self.member_seconds, 6),
            "peak_members": self.peak_members,
        }

    def to_json(self) -> str:
        return json.dumps(
            self.encode(), sort_keys=True, separators=(",", ":")
        )
