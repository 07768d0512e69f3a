#!/usr/bin/env python3
"""Every route of the FFD scan kernel, timed through the port's wrappers on
one GPU.

Run from the root of a checkout, on a machine with a CUDA device and
``nvcc``:

    python3 route_times.py [--root DIR] [--reps N] [--tag TAG]

It imports the port and ``chip_smoke.py`` from DIR (default: the directory
of this script), so that it can time another tree of the repo (a parent
commit unpacked with ``git archive``) with the same code. On
``chip_smoke.py``'s inputs it times, by CUDA events, as the smoke times
each row of ``PERF.md``'s kernel table:

- solo: ``cuda_ffd_solve`` on plain_50k_800 and topology_5k_400;
- batched: ``cuda_ffd_solve_batched`` on the fleet's two groups (a copy
  of the stacked state inside the window), and group 0's rows in 2-row
  shards, as a 4-shard mesh splits them;
- gang: the cfg11 solve's first scan (``cuda_ffd_solve``) and its whole
  dispatch (``cuda_gang_solve``, two scans: a rollback); a gang tenant's
  request as a 1-row shard of a batched gang dispatch
  (``cuda_gang_solve_sharded``, as a 4-shard mesh gives each tenant);
- ``topo_rank``: the cfg18 scan;
- relax: the first candidate scan of a ``relax`` solve of each of
  ``chip_smoke.relax_problems()``;
- the consolidation sweep at config 4: the stacked scan alone through the
  tree's own entry (``cuda_ffd_solve_prefixes`` over the packed stack where
  the tree has it, else ``cuda_ffd_solve_batched``; each on a copy made
  outside the window), and ``_prefix_scan`` (stack, scan, verdicts).

Each number is the mean of ``--reps`` calls after one warm call. It prints
the card's name and power limit (``nvidia-smi``), then one JSON object:
``tag``, ``root``, ``build_s`` and ``routes`` (name -> ms). It checks no
answer (``chip_smoke.py`` does). To compare two trees on one card, run it
once for each in one session, alternating (parent, change, change,
parent, ...).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    os.chdir(root)
    try:
        import torch
    except ImportError:
        print("route_times: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("route_times: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    import chip_smoke as cs
    from karpenter_core_tpu_torch.models import consolidation as cons
    from karpenter_core_tpu_torch.models.provisioner import (
        _BATCH_PAD_LO,
        _bucket,
        _stack_trees,
    )
    from karpenter_core_tpu_torch.ops import cuda_ffd
    from karpenter_core_tpu_torch.ops.ffd import LEVEL_ITERS

    t0 = time.perf_counter()
    cuda_ffd.build()
    build_s = time.perf_counter() - t0
    reps = args.reps
    routes = {}

    def solo(name, req):
        a = (req.init_state, req.steps, req.statics, req.level_iters)
        routes[name] = cs._time_ms(lambda: cuda_ffd.cuda_ffd_solve(*a), reps)

    for name in ("plain_50k_800", "topology_5k_400"):
        make, n_types, max_slots = cs.problems()[name]
        solo(name, cs.first_request(
            cs.scheduler(n_types, max_slots, "reference"), make()))

    reqs = {n: cs.first_request(cs.fleet_scheduler(n, "reference"), make())
            for n, (make, _k) in cs.fleet().items()}
    for g, names in enumerate(cs.FLEET_GROUPS):
        rs = [reqs[n] for n in names]
        rs += [rs[0]] * (_bucket(len(rs), lo=_BATCH_PAD_LO) - len(rs))
        stack = tuple(_stack_trees([getattr(r, f) for r in rs])
                      for f in ("init_state", "steps", "statics"))
        li = rs[0].level_iters

        def batched(st, steps, statics):
            return cuda_ffd.cuda_ffd_solve_batched(cs._copy(st), steps,
                                                   statics, li)

        routes[f"fleet_group_{g}"] = cs._time_ms(lambda: batched(*stack),
                                                 reps)
        if g == 0:
            for lo in range(0, int(stack[0].kind.shape[0]), 2):
                shard = tuple(type(t)(*(None if x is None else x[lo:lo + 2]
                                        for x in t)) for t in stack)
                routes[f"fleet_group_0_rows_{lo}_{lo + 1}"] = cs._time_ms(
                    lambda: batched(*shard), reps)

    problem = cs.gangs_problem()
    wreq = cs.first_request(cs.gang_scheduler(problem, "reference"),
                            problem[3])
    solo("cfg11_gang_scan", wreq)
    routes["cfg11_gang_dispatch"] = cs._time_ms(
        lambda: cuda_ffd.cuda_gang_solve(
            wreq.init_state, wreq.steps, wreq.statics, wreq.gang_of_step,
            wreq.gang_min, wreq.level_iters), max(reps // 2, 1))

    problem = cs.gangs_problem(cs.GANG_TENANT_PODS, pool=cs.GANG_TENANTS[-1])
    treq = cs.first_request(cs.gang_scheduler(problem, "reference"),
                            problem[3])
    shard = (*(_stack_trees([getattr(treq, f)])
               for f in ("init_state", "steps", "statics")),
             treq.gang_of_step.unsqueeze(0), treq.gang_min.unsqueeze(0))
    routes["gang_tenant_shard_dispatch"] = cs._time_ms(
        lambda: cuda_ffd.cuda_gang_solve_sharded([shard], treq.level_iters),
        reps)

    problem = cs.topo_problem()
    solo("cfg18_topo_rank", cs.first_request(
        cs.gang_scheduler(problem, "reference", max_slots=cs.TOPO_SLOTS),
        problem[3]))

    for pname, make in cs.relax_problems().items():
        with cs.relax_spy() as log:
            cs.relax_scheduler("relax").solve(make())
        kinds = cs._solve_dispatches(log["dispatches"])
        cand = next(d for d, k in zip(log["dispatches"], kinds)
                    if k == "candidate")
        solo(f"relax_candidate_{pname}", cand["reqs"][0])

    inputs = cs.sweep_inputs()
    sched, prep, classes, kind_batch, count_batch = cons.sweep_problem(
        **inputs, max_slots=cs.SWEEP_SLOTS, device="cuda")
    entry = getattr(cuda_ffd, "cuda_ffd_solve_prefixes", None)
    state = prep.init_state
    if entry is None:
        entry = cuda_ffd.cuda_ffd_solve_batched
    else:
        state = cuda_ffd.pack_state(state)
    st, steps, statics = cons.prefix_stack(state, classes, prep.statics,
                                           kind_batch, count_batch)
    entry(cs._copy(st), steps, statics, LEVEL_ITERS)  # warm
    total = 0.0
    for _ in range(reps):
        copy = cs._copy(st)
        total += cs._time_once(
            lambda: entry(copy, steps, statics, LEVEL_ITERS))[1]
        del copy
    routes["sweep_scan"] = total / reps
    del st, steps, statics
    it_price = torch.as_tensor(cons._it_price_vector(prep), device="cuda")
    routes["sweep_prefix_scan"] = cs._time_ms(
        lambda: cons._prefix_scan(prep.init_state, classes, prep.statics,
                                  kind_batch, count_batch, it_price,
                                  len(sched.existing_nodes)), reps)

    print(json.dumps(dict(tag=args.tag, root=root, build_s=build_s,
                          reps=reps, routes=routes)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
