"""Entry ``fleet``: a closed loop of ``solve_batch`` grants over a fleet of
tenants, as one solver sidecar serves the provisioning passes of many
clusters.

The configuration gives the tenants (``tenants``), the passes a grant
(``max_batch``) and each tenant's NodePool name (``nodepool``: a prefix
and the tenant's number); every tenant has the configuration's catalog
and one ``DeviceScheduler`` of its own, kept across its passes as the
sidecar keeps one a tenant. The traffic gives a pool of backlogs that the
tenants share: tenant t's k-th pass is backlog ``(offset_t + k) mod
backlogs``, the offsets a seeded draw of distinct ones, so the members of
a grant hold distinct backlogs.

One call is one grant. Every tenant passes once a round; a round takes
the tenants in a seeded order of its own, ``max_batch`` a grant, which is
what a saturated gateway with every tenant queued hands its solver. The
call runs one ``solve_batch`` over the grant's members and keeps its
stats.

A member counts as failed when it raised, when the port's verifier
rejected an answer in its grant (``SOLVER_RESULT_REJECTED`` moved; the
counter is one for the whole process, so every member of that grant
counts), or when no scan kernel launched for its grant on the card. Its
pods are not counted as placed.

After the window a seeded sample of the members is held to the plain
reference (``reference/fleet.py``): every guarantee of a solve, the
NodeClaim count and price against the reference's own answer, and the
same backlog solved alone by a fresh scheduler of the tenant; every
completed member is checked for pods and NodePools of other tenants.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Dict, List

from kbench.lib import catalog as kcat
from kbench.lib import gen, port
from kbench.reference import fleet as rfleet

END_TO_END = "pods_per_s"
# a seeded sample of the window's members is held to the reference
SAMPLE = 24
LIMITS = rfleet.LIMITS
# rounds of grants before the window: every tenant passes this often
WARM_ROUNDS = 2


def _rejected() -> float:
    from karpenter_core_tpu_torch.metrics import wiring as m

    return sum(m.SOLVER_RESULT_REJECTED.values.values())


def _named(result, uid_names: Dict[str, str]):
    """The pods a member's answer names (NodeClaims, existing nodes and
    errors) and the NodePool of each of its NodeClaims."""
    named = [p.metadata.name for c in result.new_node_claims for p in c.pods]
    named += [p.metadata.name for s in result.existing_nodes for p in s.pods]
    named += [uid_names.get(uid, uid) for uid in result.pod_errors]
    return named, [c.template.nodepool_name for c in result.new_node_claims]


class Entry:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device: str,
                 log):
        """The harness's inputs: the catalog, the pool of backlogs and the
        tenants' walks over it."""
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.log = device, log
        T, M = config["tenants"], config["max_batch"]
        P = traffic["backlogs"]
        if T % M or P < T:
            raise ValueError(f"{T} tenants need whole grants of {M} and at"
                             f" least as many backlogs ({P})")
        self.catalog = kcat.catalog_rows(config["catalog"])
        self.rows = [gen.backlog(traffic, seed, b) for b in range(P)]
        self.pods = [port.pods(r, traffic) for r in self.rows]
        self.uid_names = [{p.metadata.uid: p.metadata.name for p in pods}
                          for pods in self.pods]
        spec = config["nodepool"]
        self.pools = [f"{spec['name_prefix']}{t:0{spec['name_digits']}d}"
                      for t in range(T)]
        self.offsets = [int(x) for x in gen.rng(seed, 4).permutation(P)[:T]]
        self.scheds = None
        self.base = 0
        # a seeded uniform sample of the window's members (reservoir)
        self.kept: List[Dict] = []
        self.seen = 0
        self.keep_rng = gen.rng(seed, 3)

    def _scheduler(self, t: int):
        from karpenter_core_tpu_torch.models.provisioner import (
            DeviceScheduler,
        )

        name = self.pools[t]
        return DeviceScheduler(
            [port.nodepool({"name": name})],
            {name: port.instance_types(self.catalog)},
            max_slots=self.traffic["max_slots"], device=self.device,
            kernel_backend="cuda")

    def _grant(self, g: int):
        """Grant ``g``'s members: (tenant, backlog) pairs."""
        T, M = self.config["tenants"], self.config["max_batch"]
        r, q = divmod(g, T // M)
        tenants = gen.rng(self.seed, 5, r).permutation(T)[q * M:(q + 1) * M]
        P = len(self.pods)
        return [(int(t), (self.offsets[t] + r) % P) for t in tenants]

    def warm(self) -> None:
        """The tenants' schedulers; every padded batch size of the
        batched scan; then ``WARM_ROUNDS`` rounds of grants, so every
        tenant has passed (its first pass builds its prepared catalog)."""
        from karpenter_core_tpu_torch.models import provisioner as prov

        T, M = self.config["tenants"], self.config["max_batch"]
        self.scheds = [self._scheduler(t) for t in range(T)]
        # throwaway schedulers of tenant 0 over one backlog: one batched
        # dispatch of each padded size (2, 4, ... max_batch), leaving the
        # tenants' own caches alone
        t0 = time.perf_counter()
        spare = [self._scheduler(0) for _ in range(M)]
        size = 2
        while size <= M:
            prov.solve_batch([(s, self.pods[0]) for s in spare[:size]])
            size *= 2
        t1 = time.perf_counter()
        n = WARM_ROUNDS * (T // M)
        padded = Counter()
        for g in range(n):
            rec = self._run(g, keep=False)
            padded[rec["stats"].get("padded_total_rows", 0)] += 1
        self.base = n
        self.log(f"warm: padded batch sizes 2-{M} in {t1 - t0!r} s; {n}"
                 f" grants ({WARM_ROUNDS} rounds) in"
                 f" {time.perf_counter() - t1!r} s; padded rows a grant"
                 f" {dict(sorted(padded.items()))}")

    def call(self, i: int, keep: bool = True) -> Dict:
        return self._run(self.base + i, keep)

    def _run(self, g: int, keep: bool) -> Dict:
        import torch

        from karpenter_core_tpu_torch.models import provisioner as prov
        from karpenter_core_tpu_torch.ops import cuda_ffd

        grant = self._grant(g)
        entries = [(self.scheds[t], self.pods[b]) for t, b in grant]
        n0, rej0 = cuda_ffd.counter.total(), _rejected()
        stats: Dict = {}
        t0 = time.perf_counter()
        try:
            outcomes, stats = prov.solve_batch(entries)
            if self.device == "cuda":
                torch.cuda.synchronize()
        except Exception as e:  # a failed grant is counted, not fatal
            outcomes = [("error", e)] * len(entries)
        t1 = time.perf_counter()
        why = (("verifier rejected" if _rejected() > rej0 else None)
               or ("no kernel launch" if self.device == "cuda"
                   and cuda_ffd.counter.total() == n0 else None))
        members, done = [], 0
        for (t, b), (status, res) in zip(grant, outcomes):
            m = {"tenant": t, "b": b,
                 "failed": repr(res) if status != "ok" else why,
                 "stats": dict(self.scheds[t].last_phase_stats or {})}
            if m["failed"] is None:
                done += len(self.pods[b])
                m["named"], m["pools"] = _named(res, self.uid_names[b])
                if keep:
                    self._sample(m, res)
            members.append(m)
        return {"g": g, "t_end": t1, "dt": t1 - t0, "pods": done,
                "stats": dict(stats), "members": members,
                "failed": sum(1 for m in members if m["failed"])}

    def _sample(self, m: Dict, res) -> None:
        self.seen += 1
        if len(self.kept) < SAMPLE:
            slot = len(self.kept)
            self.kept.append(m)
        else:
            slot = int(self.keep_rng.integers(0, self.seen))
            if slot >= SAMPLE:
                return
            self.kept[slot].pop("result", None)
            self.kept[slot] = m
        m["result"] = res

    def _rows(self, res, b: int) -> Dict:
        answer = port.answer_rows(res, self.pods[b])
        for c, row in zip(res.new_node_claims, answer["claims"]):
            row["pool"] = c.template.nodepool_name
        return answer

    def collect(self, records: List[Dict]) -> None:
        """After the window: the kept answers read back as plain rows, and
        each kept member's backlog solved alone by a fresh scheduler of
        its tenant."""
        t0 = time.perf_counter()
        for r in records:
            for m in r["members"]:
                if "result" not in m:
                    continue
                m["answer"] = self._rows(m.pop("result"), m["b"])
                try:
                    alone = self._scheduler(m["tenant"]).solve(
                        self.pods[m["b"]])
                    m["solo"] = self._rows(alone, m["b"])
                except Exception as e:  # counted as differing
                    self.log(f"solo solve failed: {e!r}")
                    m["solo"] = None
        self.log(f"solo solves of the kept members in"
                 f" {time.perf_counter() - t0!r} s")

    def end_to_end(self, records: List[Dict], t0: float) -> float:
        return sum(r["pods"] for r in records) / (records[-1]["t_end"] - t0)

    def span_points(self):
        from kbench.entries import provision
        from karpenter_core_tpu_torch.models import provisioner as prov

        return provision.Entry.span_points(self) + [
            (prov, "solve_batch", "batch"),
            (prov, "_run_kernel_batched", "dispatch")]

    def free(self) -> None:
        self.scheds = None
        self.pods = None

    def check(self, records: List[Dict]) -> Dict:
        """The numbers compared (``LIMITS``), and the window's coalescing
        and caches on standard error."""
        members = [m for r in records for m in r["members"]]
        stats = Counter()
        for r in records:
            stats.update(r["stats"])
        self.log(f"solve_batch over {len(records)} grants: "
                 f"{dict(sorted(stats.items()))}")
        mstats = [m["stats"] for m in members]

        def total(key):
            return sum(s.get(key, 0) for s in mstats)

        phases = {k: 1e3 * total(k) / max(len(mstats), 1)
                  for k in ("plan_s", "prepare_s", "decode_s", "verify_s")}
        used = [s.get("used_slots", 0) for s in mstats] or [0]
        slots = sorted(Counter(s.get("slots") for s in mstats).items())
        self.log(f"a member's host phases, ms: {phases}")
        self.log("prepared cache over the window: hits"
                 f" {total('prep_cache_hits')}, misses"
                 f" {total('prep_cache_misses')}; members with an overflow"
                 f" retry {sum(1 for s in mstats if s.get('rounds', 1) > 1)};"
                 f" slots {slots},"
                 f" used slots {min(used)}-{max(used)}")
        return rfleet.hold(members, self.rows, self.catalog, self.traffic,
                           self.pools, self.log)
