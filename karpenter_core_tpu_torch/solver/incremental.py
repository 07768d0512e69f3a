"""incsolve: churn-proportional incremental re-solve (ISSUE 16).

The delta wire (PR 13) made steady-state requests cheap to *ship*; this
module makes them cheap to *solve*. A :class:`PackingLedger` retains the
previous solve's accepted packing keyed by the manifest's (mode-suffixed)
problem fingerprint. When the next request names its predecessor
(``prev_fingerprint`` on the wire), the :class:`IncrementalEngine` diffs
the decoded problem against the remembered one at three granularities —
the problem CORE (nodepools / catalog / daemonsets / ICE / slot ceiling),
the per-node digests (codec's canonical SimNode encoding), and the pod
equivalence classes (solver/snapshot.group_pods) — and replays every
placement the diff proves untouched:

* **warm**   — nothing changed: the recorded packing replays verbatim
  (recorded pod uids re-bound to the current pod objects by uid, then by
  class-interchangeability), no scheduler is ever constructed.
* **partial** — some classes are dirty (new signature, count change, a
  prior error, or a prior placement on a node whose digest moved): clean
  classes stay pinned to their recorded claims/nodes as CLOSED occupancy,
  and only the dirty pods re-enter a host-greedy sub-solve against the
  nodes' reduced availability.
* **full**   — ledger miss (amnesia), core change, topology/gang/eviction
  structure, or a dirty set past the proportionality bound: the inner
  DeviceScheduler solves fresh (lazily constructed — warm replays never
  pay for one). When a prior entry exists and the backend is relax, the
  recorded per-class nodepool seeds the kernel's fractional warm start
  (``DeviceScheduler._relax_warm`` → ops/relax warm_template).
* **drift_reset** — the drift controller forced the full solve: either
  the configured interval since the last full elapsed, or a replayed
  packing regressed past the node-count bound vs the last full baseline
  (incremental packings must not ratchet into bad node sets).
* **rejected** — a replayed packing failed the UNMODIFIED ResultVerifier
  (solver/verify.py, the same trust anchor fresh results face): the
  replay is discarded and a fresh solve serves. Deliberately *not*
  routed through ``verify.reject`` — ``solver_result_rejected_total`` is
  the wire/device-corruption signal and the acceptance battery pins it
  at zero; an engine self-check firing is a degradation, not a client-
  facing rejection.

Every outcome lands on ``solver_incremental_total{outcome=...}`` and the
final result (replayed or fresh) is remembered under the CURRENT
fingerprint, so steady-state churn pays one diff + one sub-solve per
round regardless of cluster size. The ledger is bounded (entries and
approximate bytes, LRU) and lives with the digest-affinity-routed fleet
member (solver/remote.FleetRouter pins a snapshot's manifests to one
member, so its ledger keeps hitting); a respawned member's empty ledger
is indistinguishable from a miss — amnesia degrades to a full solve,
never to a wrong bind.
"""
from __future__ import annotations

import copy
import math
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

DEFAULT_MAX_ENTRIES = 128
DEFAULT_MAX_BYTES = 64 * 1024 * 1024
# drift controller: force a full solve every N solves even when every
# round replays clean (interval), and whenever a replayed packing needs
# more than baseline*(1+slack) fresh nodes (regression trigger)
DEFAULT_FULL_INTERVAL = 16
DEFAULT_REGRESSION_SLACK = 0.02
# proportionality bound: past this the diff bookkeeping stops paying for
# itself and the full path's vmapped kernel wins anyway
DEFAULT_MAX_DIRTY_FRACTION = 0.25
DEFAULT_MAX_DIRTY_PODS = 512


@dataclass
class LedgerEntry:
    """One remembered packing: everything replay needs, nothing heavier.

    Placements are recorded as uid/name references (the result-wire
    shape, solver/codec.encode_solve_results) plus the per-class uid
    partition — live Pod/claim objects are NOT retained, so an entry's
    footprint scales with the uid count, not the object graph."""

    key: str
    core_digest: str
    topo_digest: str
    node_digests: Dict[str, str]
    label_aware: bool
    # class signature -> {"count", "uids", "exist_nodes", "pool",
    # "errored", "gangy"}
    classes: Dict[tuple, dict]
    # recorded result, wire-shaped: claims keep the live Requirements
    # object (read-only from here on) + instance-type NAMES
    claims: List[dict]
    existing: List[Tuple[str, List[str]]]
    errors: Dict[str, str]
    evictions: Dict[str, List[str]]
    node_count: int
    baseline_nodes: int
    solves_since_full: int = 0
    nbytes: int = 0


class PackingLedger:
    """Bounded LRU store of LedgerEntry by mode-suffixed fingerprint
    (the SegmentStore/BoundedSchedulerCache idiom one tier up)."""

    def __init__(
        self,
        max_entries: int = DEFAULT_MAX_ENTRIES,
        max_bytes: int = DEFAULT_MAX_BYTES,
    ):
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._entries: "OrderedDict[str, LedgerEntry]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.evictions: Dict[str, int] = {}

    def get(self, key: str) -> Optional[LedgerEntry]:
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
            return e

    def remember(self, entry: LedgerEntry) -> None:
        with self._lock:
            old = self._entries.pop(entry.key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[entry.key] = entry
            self._bytes += entry.nbytes
            while len(self._entries) > self.max_entries:
                self._drop_oldest_locked("entries")
            while self._bytes > self.max_bytes and len(self._entries) > 1:
                self._drop_oldest_locked("bytes")
        self._export()

    def _drop_oldest_locked(self, reason: str) -> None:
        _, dropped = self._entries.popitem(last=False)
        self._bytes -= dropped.nbytes
        self.evictions[reason] = self.evictions.get(reason, 0) + 1

    def _export(self) -> None:
        from karpenter_core_tpu_torch.metrics import wiring as m

        with self._lock:
            m.SOLVER_LEDGER_ENTRIES.set(float(len(self._entries)))
            m.SOLVER_LEDGER_BYTES.set(float(self._bytes))

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_entries": self.max_entries,
                "max_bytes": self.max_bytes,
                "evictions": dict(self.evictions),
            }


# -- problem digests -------------------------------------------------------


def _digest(obj) -> str:
    from karpenter_core_tpu_torch.solver import segments

    return segments.digest_of(segments.canonical_bytes(obj))


def _core_digest(problem: dict) -> str:
    """The problem half that invalidates EVERY placement when it moves:
    nodepools, instance-type catalog, daemonset overhead, ICE snapshot,
    slot ceiling. Canonical codec encodings, so object identity and
    relist order never churn it."""
    from karpenter_core_tpu_torch.kube import serial
    from karpenter_core_tpu_torch.solver import codec

    table, pools = codec._encode_it_table(problem["instance_types"])
    return _digest({
        "nodepools": [
            serial.encode(np_)
            for np_ in sorted(
                problem["nodepools"], key=lambda n: n.metadata.name
            )
        ],
        "it_table": table,
        "it_pools": pools,
        "daemonset_pods": [
            serial.encode(p)
            for p in sorted(
                problem["daemonset_pods"], key=codec._pod_sort_key
            )
        ],
        "unavailable_offerings": sorted(
            list(k) for k in problem["unavailable_offerings"]
        ),
        "max_slots": problem["max_slots"],
    })


def _topo_digest(problem: dict) -> str:
    from karpenter_core_tpu_torch.solver import codec

    return _digest(codec._encode_topology(problem.get("topology")))


def _node_digests(existing_nodes) -> Dict[str, str]:
    from karpenter_core_tpu_torch.solver import codec

    return {
        n.name: _digest(codec._encode_sim_node(n)) for n in existing_nodes
    }


# -- the engine ------------------------------------------------------------


class IncrementalScheduler:
    """The lazy wrapper solver/service swaps onto a solve_batch entry
    when the request names a predecessor. Duck-types the scheduler
    surface the batch leader touches (``solver_mode``, ``relax_budget_s``
    assignment, ``.solve(pods)`` via solve_batch's compat generator); the
    inner DeviceScheduler is only constructed if the engine decides it
    needs one, so a warm replay never pays device/prepare cost."""

    def __init__(
        self,
        engine: "IncrementalEngine",
        problem: dict,
        make_inner: Callable[[], object],
    ):
        self._engine = engine
        self._problem = problem
        self._make_inner = make_inner
        self.solver_mode = problem.get("solver_mode") or "ffd"
        self.relax_budget_s: Optional[float] = None

    def solve(self, pods: List) -> object:
        return self._engine.solve(
            self._problem, pods, self._make_inner,
            relax_budget_s=self.relax_budget_s,
        )


class IncrementalEngine:
    """The decision tree + replay machinery over one PackingLedger."""

    def __init__(
        self,
        ledger: Optional[PackingLedger] = None,
        full_interval: int = DEFAULT_FULL_INTERVAL,
        max_dirty_fraction: float = DEFAULT_MAX_DIRTY_FRACTION,
        max_dirty_pods: int = DEFAULT_MAX_DIRTY_PODS,
        regression_slack: float = DEFAULT_REGRESSION_SLACK,
    ):
        self.ledger = ledger if ledger is not None else PackingLedger()
        self.full_interval = full_interval
        self.max_dirty_fraction = max_dirty_fraction
        self.max_dirty_pods = max_dirty_pods
        self.regression_slack = regression_slack
        # last-solve debug surface for tests/healthz: outcome, reason,
        # dirty/pinned accounting, verifier violations (strings)
        self.last: dict = {}

    def wrap(
        self, problem: dict, make_inner: Callable[[], object]
    ) -> IncrementalScheduler:
        return IncrementalScheduler(self, problem, make_inner)

    def stats(self) -> dict:
        return {
            "enabled": True,
            "full_interval": self.full_interval,
            "max_dirty_fraction": self.max_dirty_fraction,
            "max_dirty_pods": self.max_dirty_pods,
            "regression_slack": self.regression_slack,
            "ledger": self.ledger.stats(),
            "last": {
                k: v
                for k, v in self.last.items()
                if k in ("outcome", "reason", "dirty_classes",
                         "dirty_pods", "pinned_pods")
            },
        }

    # -- solve -------------------------------------------------------------

    def solve(
        self,
        problem: dict,
        pods: List,
        make_inner: Callable[[], object],
        relax_budget_s: Optional[float] = None,
    ):
        from karpenter_core_tpu_torch.metrics import wiring as m
        from karpenter_core_tpu_torch.solver.snapshot import group_pods

        mode = problem.get("solver_mode") or "ffd"
        cur_key = problem["fingerprint"]
        prev_fp = problem.get("prev_fingerprint") or ""
        entry = (
            self.ledger.get(f"{prev_fp}+m{mode}") if prev_fp else None
        )

        label_aware = problem.get("topology") is not None
        classes = group_pods(pods, label_aware)
        core = _core_digest(problem)
        topo = _topo_digest(problem)
        nodes = _node_digests(problem["existing_nodes"])

        outcome, reason, results = self._attempt(
            problem, pods, classes, entry, core, topo, nodes,
        )
        if results is None:
            # every non-replay path lands here: build (or cache-hit) the
            # real scheduler and solve fresh — seeding the relax warm
            # start from the prior packing when one is remembered
            results = self._full_solve(
                entry, pods, make_inner, relax_budget_s
            )
        self.last.update({"outcome": outcome, "reason": reason})
        m.SOLVER_INCREMENTAL.inc({"outcome": outcome})
        baseline = (
            entry.baseline_nodes
            if entry is not None and outcome in ("warm", "partial")
            else len(results.new_node_claims)
        )
        since_full = (
            entry.solves_since_full + 1
            if entry is not None and outcome in ("warm", "partial")
            else 0
        )
        self.ledger.remember(self._record(
            cur_key, classes, results, core, topo, nodes, label_aware,
            baseline, since_full,
        ))
        return results

    def _attempt(self, problem, pods, classes, entry, core, topo, nodes):
        """Decide warm/partial/full and build the replayed Results for
        the replay outcomes (None = caller runs the full solve)."""
        if entry is None:
            self.last = {"dirty_classes": 0, "dirty_pods": 0,
                         "pinned_pods": 0, "violations": []}
            return "full", "miss", None
        if entry.solves_since_full + 1 >= self.full_interval:
            self.last = {"dirty_classes": 0, "dirty_pods": 0,
                         "pinned_pods": 0, "violations": []}
            return "drift_reset", "interval", None
        if entry.core_digest != core:
            self.last = {"dirty_classes": 0, "dirty_pods": 0,
                         "pinned_pods": 0, "violations": []}
            return "full", "core_changed", None

        cur = {c.signature: c for c in classes}
        dirty = {
            sig
            for sig, c in cur.items()
            if (rec := entry.classes.get(sig)) is None
            or rec["count"] != len(c.pods)
        }
        removed = set(entry.classes) - set(cur)
        nodes_changed = entry.node_digests != nodes
        topo_changed = entry.topo_digest != topo

        if not dirty and not removed and not nodes_changed \
                and not topo_changed:
            results = self._replay_warm(problem, cur, entry)
            if results is not None:
                ok, label = self._self_verify(problem, pods, results)
                if ok:
                    self.last.update({
                        "dirty_classes": 0, "dirty_pods": 0,
                        "pinned_pods": len(pods),
                    })
                    return "warm", "", results
                return "rejected", label, None
            return "full", "replay_failed", None

        # structural bail-outs: pinning interacts with cross-class state
        # (skew domains, gang atomicity, eviction credit) the cheap diff
        # cannot attribute — those problems always solve fresh
        if problem.get("topology") is not None or topo_changed:
            self._reset_last()
            return "full", "topology", None
        if entry.evictions:
            self._reset_last()
            return "full", "evictions", None
        gangy = any(
            c.gang is not None or c.tier != 0 for c in classes
        ) or any(rec.get("gangy") for rec in entry.classes.values())
        if gangy:
            self._reset_last()
            return "full", "gangs", None

        # classes whose prior placement touched a dirty/removed node, or
        # that recorded an unschedulable pod (freed/changed capacity may
        # admit them now), re-enter the scan with the dirty set
        dirty_nodes = {
            name
            for name in set(entry.node_digests) | set(nodes)
            if entry.node_digests.get(name) != nodes.get(name)
        }
        for sig, rec in entry.classes.items():
            if sig in cur and sig not in dirty:
                if rec["errored"] or any(
                    n in dirty_nodes for n in rec["exist_nodes"]
                ):
                    dirty.add(sig)
        dirty_pods = sum(len(cur[s].pods) for s in dirty)
        bound = max(
            self.max_dirty_pods,
            int(self.max_dirty_fraction * max(len(pods), 1)),
        )
        if dirty_pods > bound:
            self._reset_last()
            return "full", "too_dirty", None

        results = self._replay_partial(
            problem, cur, entry, dirty, dirty_nodes
        )
        if results is None:
            return "full", "replay_failed", None
        ok, label = self._self_verify(problem, pods, results)
        if not ok:
            return "rejected", label, None
        ceiling = max(
            entry.baseline_nodes + 1,
            int(math.ceil(
                entry.baseline_nodes * (1.0 + self.regression_slack)
            )),
        )
        if len(results.new_node_claims) > ceiling:
            return "drift_reset", "node_regression", None
        self.last.update({
            "dirty_classes": len(dirty),
            "dirty_pods": dirty_pods,
            "pinned_pods": len(pods) - dirty_pods,
        })
        return "partial", "", results

    def _reset_last(self):
        self.last = {"dirty_classes": 0, "dirty_pods": 0,
                     "pinned_pods": 0, "violations": []}

    # -- replay ------------------------------------------------------------

    def _uid_map(self, cur, entry, sigs) -> Optional[Dict[str, object]]:
        """Recorded pod uid -> current Pod, per clean class: identity
        first (an unchanged pod replays its own placement — the byte-
        parity path), then queue order (pods inside one equivalence
        class are interchangeable by construction)."""
        uid_map: Dict[str, object] = {}
        for sig in sigs:
            rec_uids = entry.classes[sig]["uids"]
            cur_pods = cur[sig].pods
            if len(rec_uids) != len(cur_pods):
                return None
            by_uid = {p.uid: p for p in cur_pods}
            rec_set = set(rec_uids)
            spares = iter(
                p for p in cur_pods if p.uid not in rec_set
            )
            for u in rec_uids:
                p = by_uid.get(u)
                uid_map[u] = p if p is not None else next(spares)
        return uid_map

    def _pool_context(self, problem):
        """templates/overhead/it_by_name for claim reconstruction — the
        solver/remote._materialize recipe against the decoded problem."""
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.nodeclaimtemplate import (  # noqa: E501
            NodeClaimTemplate,
        )
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.scheduler import (  # noqa: E501
            _daemon_compatible,
        )
        from karpenter_core_tpu_torch.utils import resources as resutil

        it_by_name: Dict[str, object] = {}
        for its in problem["instance_types"].values():
            for it in its:
                it_by_name.setdefault(it.name, it)
        templates: Dict[str, object] = {}
        overhead: Dict[str, dict] = {}
        for np_ in problem["nodepools"]:
            nct = NodeClaimTemplate.from_nodepool(np_)
            templates[np_.name] = nct
            overhead[np_.name] = resutil.requests_for_pods(*[
                p for p in problem["daemonset_pods"]
                if _daemon_compatible(nct, p)
            ])
        return templates, overhead, it_by_name

    def _rebuild_claim(self, c, uid_map, templates, overhead, it_by_name):
        """One recorded claim back to a live InFlightNodeClaim carrying
        only the uids the map covers; None when its pool vanished (the
        core digest should have caught that — degrade, don't guess)."""
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (  # noqa: E501
            InFlightNodeClaim,
        )
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (  # noqa: E501
            Topology,
        )
        from karpenter_core_tpu_torch.utils import resources as resutil

        template = templates.get(c["nodepool"])
        if template is None:
            return None
        kept = [uid_map[u] for u in c["pod_uids"] if u in uid_map]
        if not kept:
            return ()
        claim = InFlightNodeClaim(
            template,
            Topology(),
            overhead[c["nodepool"]],
            [it_by_name[n] for n in c["instance_types"] if n in it_by_name],
        )
        claim.requirements = c["requirements"]
        if len(kept) == len(c["pod_uids"]):
            claim.requests = dict(c["requests"])
        else:
            # a partially-kept claim re-sums overhead + surviving pods;
            # the recorded total counted pods that re-entered the scan
            req = dict(overhead[c["nodepool"]])
            for k, v in resutil.requests_for_pods(*kept).items():
                req[k] = req.get(k, 0.0) + v
            claim.requests = req
        claim.pods = kept
        return claim

    def _replay_warm(self, problem, cur, entry):
        """Zero-diff replay: recorded claims/sims/errors/evictions
        re-bound to the current pod objects, order preserved."""
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (  # noqa: E501
            ExistingNodeSim,
        )
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.scheduler import (  # noqa: E501
            Results,
        )
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (  # noqa: E501
            Topology,
        )

        uid_map = self._uid_map(cur, entry, list(entry.classes))
        if uid_map is None:
            return None
        templates, overhead, it_by_name = self._pool_context(problem)
        claims = []
        for c in entry.claims:
            claim = self._rebuild_claim(
                c, uid_map, templates, overhead, it_by_name
            )
            if claim is None:
                return None
            if claim != ():
                claims.append(claim)
        node_by_name = {n.name: n for n in problem["existing_nodes"]}
        sims = []
        for name, uids in entry.existing:
            node = node_by_name.get(name)
            if node is None:
                return None
            sim = ExistingNodeSim(node, Topology(), {})
            sim.pods = [uid_map[u] for u in uids if u in uid_map]
            sims.append(sim)
        return Results(
            new_node_claims=claims,
            existing_nodes=sims,
            pod_errors={
                uid_map[u].uid: msg
                for u, msg in entry.errors.items()
                if u in uid_map
            },
            evictions={
                n: list(uids) for n, uids in entry.evictions.items()
            },
        )

    def _replay_partial(self, problem, cur, entry, dirty, dirty_nodes):
        """Pin every clean placement, host-greedy-solve the dirty pods
        against what capacity the pins leave, merge per node."""
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (  # noqa: E501
            ExistingNodeSim,
        )
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.scheduler import (  # noqa: E501
            Results,
            Scheduler,
        )
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (  # noqa: E501
            Topology,
        )
        from karpenter_core_tpu_torch.utils import resources as resutil

        clean = [
            sig for sig in entry.classes
            if sig in cur and sig not in dirty
        ]
        uid_map = self._uid_map(cur, entry, clean)
        if uid_map is None:
            return None
        templates, overhead, it_by_name = self._pool_context(problem)
        claims = []
        for c in entry.claims:
            claim = self._rebuild_claim(
                c, uid_map, templates, overhead, it_by_name
            )
            if claim is None:
                return None
            if claim != ():
                claims.append(claim)
        # pinned occupancy on existing nodes (clean classes never sit on
        # a dirty node — the diff marked those classes dirty)
        pinned_by_node: Dict[str, list] = {}
        for name, uids in entry.existing:
            kept = [uid_map[u] for u in uids if u in uid_map]
            if kept:
                pinned_by_node[name] = kept

        dirty_pods = [
            p for sig in dirty for p in cur[sig].pods
        ]
        sub_by_node: Dict[str, list] = {}
        sub_errors: Dict[str, str] = {}
        if dirty_pods:
            clones = []
            for n in problem["existing_nodes"]:
                clone = copy.copy(n)
                avail = dict(n.available)
                for p in pinned_by_node.get(n.name, ()):  # subtract pins
                    for k, v in resutil.requests_for_pods(p).items():
                        avail[k] = max(avail.get(k, 0.0) - v, 0.0)
                clone.available = avail
                # the greedy sub-solve never preempts; an evictable view
                # on the clone would only confuse downstream accounting
                clone.evictable = ()
                clones.append(clone)
            sub = Scheduler(
                problem["nodepools"],
                problem["instance_types"],
                existing_nodes=clones,
                daemonset_pods=problem["daemonset_pods"],
                topology=None,
                unavailable_offerings=problem["unavailable_offerings"],
            ).solve(dirty_pods)
            claims.extend(sub.new_node_claims)
            sub_errors = dict(sub.pod_errors)
            for sim in sub.existing_nodes:
                if sim.pods:
                    sub_by_node[sim.name] = list(sim.pods)

        sims = []
        for n in problem["existing_nodes"]:
            sim = ExistingNodeSim(n, Topology(), {})
            sim.pods = (
                pinned_by_node.get(n.name, [])
                + sub_by_node.get(n.name, [])
            )
            sims.append(sim)
        return Results(
            new_node_claims=claims,
            existing_nodes=sims,
            pod_errors=sub_errors,
            evictions={},
        )

    # -- verification / full solve ----------------------------------------

    def _self_verify(self, problem, pods, results):
        """The unmodified trust anchor over the replayed packing. Any
        violation discards the replay for a fresh solve — and is kept
        OFF the solver_result_rejected_total counter on purpose (module
        docstring): this is self-distrust, not a client-facing reject."""
        from karpenter_core_tpu_torch.solver.verify import ResultVerifier

        violations = ResultVerifier(
            problem["nodepools"],
            problem["instance_types"],
            existing_nodes=problem["existing_nodes"],
            daemonset_pods=problem["daemonset_pods"],
            topology=problem["topology"],
            unavailable_offerings=problem["unavailable_offerings"],
        ).verify(results, pods)
        self.last = {
            "violations": [str(v) for v in violations],
            "dirty_classes": 0, "dirty_pods": 0, "pinned_pods": 0,
        }
        if violations:
            return False, "verify:" + ",".join(
                sorted({v.reason for v in violations})
            )
        return True, ""

    def _full_solve(self, entry, pods, make_inner, relax_budget_s):
        inner = make_inner()
        if getattr(inner, "solver_mode", "ffd") == "relax":
            # reset-don't-set, the cached-scheduler rule service.py
            # applies one layer up (a stale budget/warm map on a cached
            # DeviceScheduler must never leak across requests)
            inner.relax_budget_s = relax_budget_s
            inner._relax_warm = (
                {
                    sig: rec["pool"]
                    for sig, rec in entry.classes.items()
                    if rec.get("pool")
                }
                if entry is not None
                else None
            ) or None
        return inner.solve(pods)

    # -- recording ---------------------------------------------------------

    def _record(
        self, key, classes, results, core, topo, nodes, label_aware,
        baseline, since_full,
    ) -> LedgerEntry:
        uid_sig: Dict[str, tuple] = {}
        recs: Dict[tuple, dict] = {}
        for c in classes:
            recs[c.signature] = {
                "count": len(c.pods),
                "uids": [p.uid for p in c.pods],
                "exist_nodes": set(),
                "pool": None,
                "errored": False,
                "gangy": c.gang is not None or c.tier != 0,
            }
            for p in c.pods:
                uid_sig[p.uid] = c.signature
        claims = []
        for cl in results.new_node_claims:
            pool = cl.template.nodepool_name
            claims.append({
                "nodepool": pool,
                "instance_types": [
                    it.name for it in cl.instance_type_options
                ],
                "requirements": cl.requirements,
                "requests": dict(cl.requests),
                "pod_uids": [p.uid for p in cl.pods],
            })
            for p in cl.pods:
                rec = recs.get(uid_sig.get(p.uid))
                if rec is not None and rec["pool"] is None:
                    rec["pool"] = pool
        existing = []
        for sim in results.existing_nodes:
            uids = [p.uid for p in sim.pods]
            existing.append((sim.name, uids))
            for u in uids:
                rec = recs.get(uid_sig.get(u))
                if rec is not None:
                    rec["exist_nodes"].add(sim.name)
        errors = dict(results.pod_errors)
        for u in errors:
            rec = recs.get(uid_sig.get(u))
            if rec is not None:
                rec["errored"] = True
        evictions = {
            n: list(uids)
            for n, uids in (
                getattr(results, "evictions", None) or {}
            ).items()
        }
        nbytes = 512 + 64 * len(nodes) + 48 * len(uid_sig)
        nbytes += sum(
            128 + 48 * len(c["pod_uids"]) + 24 * len(c["instance_types"])
            + 32 * len(c["requests"])
            for c in claims
        )
        nbytes += sum(64 + 48 * len(u) for _, u in existing)
        nbytes += sum(96 + len(msg) for msg in errors.values())
        return LedgerEntry(
            key=key,
            core_digest=core,
            topo_digest=topo,
            node_digests=nodes,
            label_aware=label_aware,
            classes=recs,
            claims=claims,
            existing=existing,
            errors=errors,
            evictions=evictions,
            node_count=len(results.new_node_claims),
            baseline_nodes=baseline,
            solves_since_full=since_full,
            nbytes=nbytes,
        )
