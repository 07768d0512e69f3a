"""Continuous invariant monitors: what must hold at EVERY stable virtual
tick, no matter which faults fired.

The twin calls ``check`` after each tick's reconcile settles
(run_until_idle), so transient mid-reconcile states never false-positive;
what it asserts is the operator's convergence contract under chaos:

* **pod conservation** — every pod the workload generator created (and
  has not deleted) still exists, is bound to a REAL node, and no expected
  pod starves past the scenario's max_pending SLO bound;
* **capacity** — per-node bound requests within allocatable (cpu+memory);
* **gang atomicity** — a pod group is bound all-or-nothing: at a stable
  tick its bound count is 0 or >= its min size, never a strand;
* **gang distance** — a pod group declaring a hard network-hop bound
  (``pod-group-max-hops``, topoaware ISSUE 20) is never left bound
  PROVABLY wider than it: the monitor re-derives the placement's hop
  bound purely from annotations + node topology labels (the verifier's
  sound lower bound, so a missing rack label can never false-positive);
* **eviction-budget compliance** — no PodDisruptionBudget's healthy count
  sits below its desired-healthy floor once its pods are past the
  settling grace (preemption and consolidation must route around PDBs,
  and an evicted replica must re-bind);
* **verifier rejections** — solver_result_rejected_total must not move:
  a rejection means the device tier produced an untrustworthy packing,
  which is a bug even though the ladder caught it.

A violation is data (virtual timestamp, cluster, invariant, detail), not
an exception: the fuzzer's shrinker needs the run to FINISH and report so
it can minimize the scenario that produced it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from karpenter_core_tpu_torch.api.objects import POD_RUNNING, Pod
from karpenter_core_tpu_torch.solver import gangs as gangmod
from karpenter_core_tpu_torch.twin import workloads
from karpenter_core_tpu_torch.utils.pdb import _resolve

_CPU_EPS = 1e-9
_MEM_EPS = 1.0


@dataclass(frozen=True)
class Violation:
    at: float
    cluster: int
    invariant: str  # pod_conservation | capacity | gang_atomicity
    #              | gang_distance | eviction_budget | verifier_rejection
    detail: str

    def encode(self) -> dict:
        return {
            "at": self.at,
            "cluster": self.cluster,
            "invariant": self.invariant,
            "detail": self.detail,
        }


def _rejected_total() -> float:
    from karpenter_core_tpu_torch.metrics import wiring as m

    return sum(m.SOLVER_RESULT_REJECTED.values.values())


class InvariantMonitor:
    def __init__(self, max_pending: float = 600.0, settle_grace: float = 60.0):
        self.max_pending = max_pending
        self.settle_grace = settle_grace
        self.violations: List[Violation] = []
        # metrics are process-global; the monitor judges DELTAS since its
        # own construction so back-to-back twin runs stay independent
        self._rejected_seen = _rejected_total()

    def check(
        self,
        t: float,
        operators: List,
        expected: Dict[int, Dict[str, Pod]],
    ) -> List[Violation]:
        """Run every invariant over every cluster at stable virtual time
        ``t``; returns (and accumulates) the NEW violations."""
        fresh: List[Violation] = []
        for cluster, op in enumerate(operators):
            live = expected.get(cluster, {})
            fresh.extend(self._check_cluster(t, cluster, op, live))
        rejected = _rejected_total()
        if rejected > self._rejected_seen:
            fresh.append(Violation(
                at=t, cluster=-1, invariant="verifier_rejection",
                detail=(
                    f"solver_result_rejected_total moved by"
                    f" {rejected - self._rejected_seen:g}"
                ),
            ))
            self._rejected_seen = rejected
        self.violations.extend(fresh)
        return fresh

    # -- per-cluster checks ------------------------------------------------

    def _check_cluster(
        self, t: float, cluster: int, op, live: Dict[str, Pod]
    ) -> List[Violation]:
        out: List[Violation] = []

        def flag(invariant: str, detail: str) -> None:
            out.append(Violation(
                at=t, cluster=cluster, invariant=invariant, detail=detail
            ))

        nodes = {n.name: n for n in op.kube.list_nodes()}
        pods = {p.name: p for p in op.kube.list_pods()}

        # pod conservation + starvation
        for name in sorted(live):
            pod = pods.get(name)
            if pod is None:
                flag(
                    "pod_conservation",
                    f"expected pod {name} vanished from the store",
                )
                continue
            if pod.node_name and pod.node_name not in nodes:
                flag(
                    "pod_conservation",
                    f"pod {name} bound to ghost node {pod.node_name}",
                )
            elif not pod.node_name:
                age = t - pod.metadata.creation_timestamp
                if age > self.max_pending:
                    flag(
                        "pod_conservation",
                        f"pod {name} pending {age:.0f}s"
                        f" > max_pending {self.max_pending:.0f}s",
                    )

        # per-node capacity (cpu + memory)
        used: Dict[str, Dict[str, float]] = {}
        for name in sorted(pods):
            pod = pods[name]
            if not pod.node_name:
                continue
            acc = used.setdefault(pod.node_name, {"cpu": 0.0, "memory": 0.0})
            acc["cpu"] += pod.resource_requests.get("cpu", 0.0)
            acc["memory"] += pod.resource_requests.get("memory", 0.0)
        for node_name in sorted(used):
            node = nodes.get(node_name)
            if node is None:
                continue  # already flagged as a ghost bind above
            alloc = node.status.allocatable
            if used[node_name]["cpu"] > alloc.get("cpu", 0.0) + _CPU_EPS:
                flag(
                    "capacity",
                    f"node {node_name} cpu {used[node_name]['cpu']:.3f}"
                    f" > allocatable {alloc.get('cpu', 0.0):.3f}",
                )
            if used[node_name]["memory"] > alloc.get("memory", 0.0) + _MEM_EPS:
                flag(
                    "capacity",
                    f"node {node_name} memory over allocatable",
                )

        # gang atomicity over the expected-live gang members
        gangs: Dict[str, List[Pod]] = {}
        for name in sorted(live):
            pod = pods.get(name)
            if pod is None:
                continue
            gang = workloads.gang_of(pod)
            if gang:
                gangs.setdefault(gang, []).append(pod)
        for gang in sorted(gangs):
            members = gangs[gang]
            bound = sum(1 for p in members if p.node_name)
            min_size = max(
                (workloads.gang_min_size(p) for p in members), default=0
            )
            if 0 < bound < min_size:
                flag(
                    "gang_atomicity",
                    f"gang {gang} stranded at {bound}/{len(members)}"
                    f" bound (min {min_size})",
                )
            # gang distance (topoaware): a declared hard hop bound must
            # hold over the bound members' ACTUAL node topology labels —
            # the same sound lower bound the verifier rejects on, so the
            # two layers cannot drift and a missing rack label skips the
            # member instead of manufacturing a violation
            max_hops = gangmod.gang_max_hops_for(members)
            if (
                max_hops is not None
                and max_hops < gangmod.MAX_HOP_DISTANCE
            ):
                placed = [
                    dict(nodes[p.node_name].labels or {})
                    for p in members
                    if p.node_name and p.node_name in nodes
                ]
                worst = gangmod.placement_hop_bound(placed)
                if worst > max_hops:
                    flag(
                        "gang_distance",
                        f"gang {gang} bound across {worst} network hops,"
                        f" above its declared max-hops bound {max_hops}",
                    )

        # eviction-budget compliance: PDB healthy floor at stable ticks
        for pdb in sorted(op.kube.list_pdbs(), key=lambda b: b.name):
            if pdb.selector is None or pdb.min_available is None:
                continue
            matching = [
                pods[name]
                for name in sorted(live)
                if name in pods
                and pdb.selector.matches(pods[name].metadata.labels)
            ]
            if not matching:
                continue
            youngest = max(
                p.metadata.creation_timestamp for p in matching
            )
            if t - youngest < self.settle_grace:
                continue  # the wave is still settling; starvation covers it
            healthy = sum(1 for p in matching if p.phase == POD_RUNNING)
            desired = min(
                _resolve(pdb.min_available, len(matching), round_up=True),
                len(matching),
            )
            if healthy < desired:
                flag(
                    "eviction_budget",
                    f"pdb {pdb.name} healthy {healthy} <"
                    f" desired {desired} of {len(matching)}",
                )
        return out
