"""Entry ``provision``: a closed loop of ``DeviceScheduler.solve`` calls.

One client, as Karpenter's provisioner is a singleton loop: each solve
takes the next backlog of the pool (distinct Pod objects with fresh names
and sizes drawn for that backlog, as successive provisioning passes see
them) and the next solve starts when it returns. One scheduler serves
them all, as the port's provisioner keeps one.

A solve counts as failed when it raised, when the port's verifier rejected
its answer (``SOLVER_RESULT_REJECTED`` moved; the port then answers on the
host), or when no scan kernel launched for it on the card. Its pods are
not counted as placed.

After the window a seeded sample of the answers is held to the plain
reference: every guarantee of the configuration (``reference/check.py``),
and the NodeClaim count and price against the reference's own answer for
the same backlog (``reference/pack.py``).
"""
from __future__ import annotations

import time
from typing import Dict, List

from kbench.lib import catalog as kcat
from kbench.lib import gen, port
from kbench.reference import check as rcheck
from kbench.reference import pack as rpack

END_TO_END = "pods_per_s"
# a seeded sample of the window's solves is held to the reference
SAMPLE = 24
# the numbers compared: (limit, "max" or "min"); PERF.md gives the
# readings behind each
LIMITS = {"failed": (0, "max"), "violations": (0, "max"),
          "unplaced": (0, "max"), "options_wrong": (4, "max"),
          "nodeclaims_ratio": (1.5, "max"), "price_ratio": (1.5, "max"),
          "held": (1, "min")}


def _rejected() -> float:
    from karpenter_core_tpu_torch.metrics import wiring as m

    return sum(m.SOLVER_RESULT_REJECTED.values.values())


class Entry:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device: str,
                 log):
        """The harness's inputs: the catalog and the pool of backlogs."""
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.log = device, log
        self.catalog = kcat.catalog_rows(config["catalog"])
        self.rows = [gen.backlog(traffic, seed, b)
                     for b in range(traffic["backlogs"])]
        self.pods = [port.pods(r, traffic) for r in self.rows]
        self.sched = None
        # a seeded uniform sample of the window's answers (reservoir), so
        # the harness holds at most SAMPLE of them
        self.kept: List[Dict] = []
        self.seen = 0
        self.keep_rng = gen.rng(seed, 3)

    def warm(self) -> None:
        """The program's scheduler, then one solve of every backlog: builds
        the slot width the window's solves use."""
        from karpenter_core_tpu_torch.models.provisioner import (
            DeviceScheduler,
        )

        pool = port.nodepool(self.config["nodepool"])
        self.sched = DeviceScheduler(
            [pool], {pool.metadata.name: port.instance_types(self.catalog)},
            max_slots=self.traffic["max_slots"], device=self.device,
            kernel_backend="cuda")
        t0 = time.perf_counter()
        for b in range(len(self.pods)):
            self.call(b, keep=False)
        per = (time.perf_counter() - t0) / len(self.pods)
        self.log(f"warm: {len(self.pods)} solves, {per!r} s a solve")

    def call(self, i: int, keep: bool = True) -> Dict:
        import torch

        from karpenter_core_tpu_torch.ops import cuda_ffd

        b = i % len(self.pods)
        pods = self.pods[b]
        n0, rej0, err, res = cuda_ffd.counter.total(), _rejected(), None, None
        t0 = time.perf_counter()
        try:
            res = self.sched.solve(pods)
            if self.device == "cuda":
                torch.cuda.synchronize()
        except Exception as e:  # a failed solve is counted, not fatal
            err = repr(e)
        t1 = time.perf_counter()
        stats = dict(self.sched.last_phase_stats or {})
        why = (err or ("verifier rejected" if _rejected() > rej0 else None)
               or ("no kernel launch" if self.device == "cuda"
                   and cuda_ffd.counter.total() == n0 else None))
        rec = {"i": i, "b": b, "t_end": t1, "dt": t1 - t0,
               "pods": len(pods), "stats": stats, "failed": why}
        if keep and why is None:
            self._sample(rec, res)
        return rec

    def _sample(self, rec: Dict, res) -> None:
        self.seen += 1
        if len(self.kept) < SAMPLE:
            slot = len(self.kept)
            self.kept.append(rec)
        else:
            slot = int(self.keep_rng.integers(0, self.seen))
            if slot >= SAMPLE:
                return
            self.kept[slot].pop("result", None)
            self.kept[slot] = rec
        rec["result"] = res

    def collect(self, records: List[Dict]) -> None:
        """After the window: the kept answers read back as plain rows."""
        for r in records:
            if "result" in r:
                r["answer"] = port.answer_rows(r.pop("result"),
                                               self.pods[r["b"]])

    def end_to_end(self, records: List[Dict], t0: float) -> float:
        done = sum(r["pods"] for r in records if not r["failed"])
        return done / (records[-1]["t_end"] - t0)

    def span_points(self):
        from karpenter_core_tpu_torch.models import provisioner as prov
        from karpenter_core_tpu_torch.ops import topoplan
        from karpenter_core_tpu_torch.solver import verify

        cls = prov.DeviceScheduler
        return [(cls, "solve", "solve"),
                (cls, "_sorted_classes", "plan"),
                (topoplan, "plan_topology", "plan"),
                (cls, "_prepare_with_vocab", "prepare"),
                (cls, "_class_steps", "prepare"),
                (prov, "_run_kernel_solo", "dispatch"),
                (cls, "_decode", "decode"),
                (cls, "_decode_topo", "decode"),
                (verify.ResultVerifier, "verify", "verify")]

    def free(self) -> None:
        self.sched = None
        self.pods = None

    def check(self, records: List[Dict]) -> Dict:
        """The numbers compared (``LIMITS``)."""
        out = {"failed": sum(1 for r in records if r["failed"]),
               "violations": 0, "unplaced": 0, "options_wrong": 0,
               "nodeclaims_ratio": 0.0, "price_ratio": 0.0}
        held, claims, bound, ref = 0, [], [], {}
        for r in records:
            if "answer" not in r:
                continue
            rows = self.rows[r["b"]]
            got = rcheck.check(rows, self.catalog, self.traffic, r["answer"])
            if r["b"] not in ref:
                ref[r["b"]] = rpack.pack(rows, self.catalog, self.traffic)
            want = ref[r["b"]]
            held += 1
            for k in ("violations", "unplaced"):
                out[k] += got[k]
            # the program may leave one NodeClaim a solve with the options
            # of its requests before a partial drain (PERF.md section 2)
            out["options_wrong"] = max(out["options_wrong"],
                                       got["options_wrong"])
            out["nodeclaims_ratio"] = max(
                out["nodeclaims_ratio"],
                got["nodeclaims"] / len(want["claims"]))
            out["price_ratio"] = max(out["price_ratio"],
                                     got["price"] / want["price"])
            claims.append(got["nodeclaims"])
            bound.append(got["nodeclaims_lower_bound"])
            if got["violations"]:
                self.log(f"solve {r['i']}: {got['by_guarantee']}")
        self.log(f"reference: {held} solves of {len(records)} held;"
                 f" NodeClaims {min(claims, default=0)}-"
                 f"{max(claims, default=0)}, lower bound"
                 f" {max(bound, default=0)}; the reference's own"
                 f" {sorted(len(w['claims']) for w in ref.values())}")
        out["held"] = held
        self.log("prepared cache over the window: hits"
                 f" {sum(r['stats'].get('prep_cache_hits', 0) for r in records)},"
                 " misses"
                 f" {sum(r['stats'].get('prep_cache_misses', 0) for r in records)}")
        return out
