#!/usr/bin/env python3
"""How often the storm twin of ``chip_smoke.py``'s phase 13 runs long, on
one GPU.

Run from the root of a checkout, on a machine with a CUDA device and
``nvcc``:

    python3 storm_probe.py [RUNS]

It builds the kernel library, then runs phase 13's storm scenario (the
reference twin's ``_storm_fleet_scenario``: two clusters, a fleet of two
in-thread solverd members, kube and cloud faults, a member killed, a
partition) RUNS times (default 4) through the kernel, in this one process.
Each run prints one JSON line: its wall seconds, the sha256 of its trace
and of its ledger, and its failed RPCs. The last line sums the runs: how
many there were, how many distinct traces and ledgers they gave, how many
differ from the most common one, and the walls. Phase 13 holds the storm
runs of one process byte-identical; a run that differs is what this
counts. It checks nothing else and changes no file of the repo.
"""
from __future__ import annotations

import collections
import hashlib
import json
import sys
import time


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("storm_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from karpenter_core_tpu_torch.metrics import wiring as m
    from karpenter_core_tpu_torch.ops import cuda_ffd
    from karpenter_core_tpu_torch.twin.harness import run_scenario

    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    cuda_ffd.build()
    storm = chip_smoke.twin_scenarios()["storm"]()
    rows = []
    for k in range(runs):
        cuda_ffd.counter.reset()
        with chip_smoke.plain_forbidden(), chip_smoke.fresh_counters(m):
            t0 = time.perf_counter()
            res = run_scenario(storm, kernel="cuda")
            wall = time.perf_counter() - t0
        rows.append(dict(run=k, wall_s=wall, trace=_sha(res.trace_json()),
                         ledger=_sha(res.ledger_json()),
                         rpc_failures=res.counters["rpc_failures"],
                         launches=cuda_ffd.counter.total()))
        print(json.dumps(rows[-1]), flush=True)
    seen = collections.Counter((r["trace"], r["ledger"]) for r in rows)
    common = seen.most_common(1)[0][1]
    print(json.dumps(dict(
        runs=runs, traces=len({r["trace"] for r in rows}),
        ledgers=len({r["ledger"] for r in rows}), differing=runs - common,
        walls_s=[r["wall_s"] for r in rows])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
