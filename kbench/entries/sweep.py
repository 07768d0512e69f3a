"""Entry ``sweep``: a closed loop of consolidation decisions.

Each decision is one ``models/consolidation.frontier_core`` call over the
next cluster state of the pool (built in set-up from the seed; the node
count and the candidate cap are the configuration's), asking for every
prefix of the candidate list whether its pods reschedule, how many new
NodeClaims it needs and their price bound. One client; the next decision
starts when the last returns.

A decision counts as failed when it raised, returned no frontier, or
launched no scan kernel on the card.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

from kbench.lib import catalog as kcat
from kbench.lib import gen, port
from kbench.reference import sweep as rsweep

END_TO_END = "consolidation_s"
LIMITS = {"failed": (0, "max"), "verdicts_wrong": (0, "max"),
          "price_rel_err": (1e-3, "max"), "held": (1, "min")}


class Entry:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device: str,
                 log):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.log = device, log
        self.catalog = kcat.catalog_rows(config["catalog"])
        self.pool = port.nodepool(config["nodepool"])
        self.types = {self.pool.metadata.name:
                      port.instance_types(self.catalog)}
        C = config["cluster"]["candidates"]
        self.states = [gen.sweep_state(config, traffic, self.catalog, seed, s)
                       for s in range(traffic["states"])]
        self.inputs = []
        for st in self.states:
            nodes = port.sim_nodes(st, self.pool.metadata.name)
            self.inputs.append((nodes[:C], nodes[C:], [
                port.pods(p, traffic) for p in st["candidate_pods"]]))

    def warm(self) -> None:
        t0 = time.perf_counter()
        for s in range(len(self.inputs)):
            self.call(s)
        per = (time.perf_counter() - t0) / len(self.inputs)
        self.log(f"warm: {len(self.inputs)} decisions, {per!r} s a decision")

    def call(self, i: int, keep: bool = True) -> Dict:
        import torch

        from karpenter_core_tpu_torch.models import consolidation as cons
        from karpenter_core_tpu_torch.ops import cuda_ffd

        s = i % len(self.inputs)
        cand, keep_nodes, cand_pods = self.inputs[s]
        n0, err, got = cuda_ffd.counter.total(), None, None
        t0 = time.perf_counter()
        try:
            got = cons.frontier_core(
                [self.pool], self.types, cand, keep_nodes, [], [], cand_pods,
                max_slots=self.config["cluster"]["max_slots"],
                device=self.device, kernel_backend="cuda")
            if self.device == "cuda":
                torch.cuda.synchronize()
        except Exception as e:  # a failed decision is counted, not fatal
            err = repr(e)
        t1 = time.perf_counter()
        why = (err or ("no frontier" if got is None else None)
               or ("no kernel launch" if self.device == "cuda"
                   and cuda_ffd.counter.total() == n0 else None))
        return {"i": i, "s": s, "t_end": t1, "dt": t1 - t0, "failed": why,
                "frontier": got}

    def collect(self, records: List[Dict]) -> None:
        pass

    def end_to_end(self, records: List[Dict], t0: float) -> float:
        done = sum(1 for r in records if not r["failed"])
        return (records[-1]["t_end"] - t0) / max(done, 1)

    def span_points(self):
        from karpenter_core_tpu_torch.models import consolidation as cons

        return [(cons, "frontier_core", "decision"),
                (cons, "sweep_problem", "sweep_problem"),
                (cons, "_prefix_scan", "prefix_scan")]

    def free(self) -> None:
        self.inputs = None
        self.types = None

    def check(self, records: List[Dict]) -> Dict:
        """Every decision's frontier against the reference's verdicts for
        its cluster state."""
        slots = self.config["cluster"]["max_slots"]
        ref = [rsweep.verdicts(st, self.catalog, slots)
               for st in self.states]
        wrong, err, held = 0, 0.0, 0
        for r in records:
            got = r["frontier"]
            if r["failed"] or got is None:
                continue
            held += 1
            want = ref[r["s"]]
            wrong += abs(len(got) - len(want))
            for p, (g, w) in enumerate(zip(got, want)):
                if bool(g[0]) != w[0] or int(g[1]) != w[1]:
                    wrong += 1
                    if wrong <= 5:
                        self.log(f"decision {r['i']} prefix {p}: port {g},"
                                 f" reference {w}")
                if math.isfinite(w[2]) and w[2] > 0:
                    err = max(err, abs(g[2] - w[2]) / w[2])
                elif g[2] != w[2]:  # a bound of 0 or inf missed: all off
                    err = max(err, 1.0)
        return {"failed": sum(1 for r in records if r["failed"]),
                "verdicts_wrong": wrong, "price_rel_err": err, "held": held}
