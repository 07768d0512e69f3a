#!/usr/bin/env python3
"""Where a step of the FFD scan kernel spends its time, on one GPU.

Run from the root of a checkout, with no arguments, on a machine with a
CUDA device and ``nvcc``:

    python3 ffd_probe.py

It builds ``karpenter_core_tpu_torch/csrc/ffd_step.cu`` three ways into the
package's (gitignored) build directory: as it is; with the four stages'
work taken out, so that a step is its four grid barriers alone; and with
extra device-clock stamps inside the prologue and the decisions (block 0,
problem 0). On the scan inputs of ``chip_smoke.py``'s shapes (the 50k-pod
and 5k topology solo problems, and the fleet batch's two groups) it prints
one JSON line a shape: the scan's ms and µs a step, the four stages' µs a
step from the kernel's own stamps, the barriers-only step, and the
sub-stages' times since the step began. It checks nothing against the
plain scan (``chip_smoke.py`` does) and changes no file of the repo.
"""
from __future__ import annotations

import json
import subprocess
import sys


def _sub(src, pairs):
    for a, b in pairs:
        if src.count(a) != 1:
            raise RuntimeError(f"ffd_probe: the kernel source has {a!r}"
                               f" {src.count(a)} times")
        src = src.replace(a, b)
    return src


# the scan loop's stage calls (the slot stages' span two lines)
_STAGE_CALLS = (
    "prologue(problem(args, b), j, region);",
    "feasible(problem(args, (int)(sl / open)), j, (int)(sl % open),\n"
    "                 (int)(i % parts), parts, lane);",
    "decide(problem(args, b), j, red, region);",
    "merge(problem(args, (int)(sl / open)), j, (int)(sl % open),\n"
    "                (int)(i % parts), parts, lane);",
    "merge_out_of_line(problem(args, (int)(sl / open)), j,\n"
    "                              (int)(sl % open), (int)(it % parts), parts,\n"
    "                              lane);",
)

# extra stamps: a stamp goes between the two texts
_SUB_STAMPS = (
    ("  __syncthreads();  // the region may still hold the last problem's"
     " rows", "\n\n  // label-group", "prologue: region free"),
    ("  __syncthreads();", "\n\n  // effective class requirements",
     "prologue: label groups"),
    ("  __syncthreads();", "\n\n  const int s = imax(a.c_new_template[j], 0);",
     "prologue: effective requirements"),
    ("  __syncthreads();", "\n\n  // one pass: existing capacity",
     "decisions: records staged"),
    ("  const int first = s1.mn;", "", "decisions: first scan"),
    ("  const int rem_claims = wsub(m, block_sum(te_sum, red));", "",
     "decisions: first-fit"),
    ("  const int L = lo;", "\n  int fsum = 0, ecount = 0;",
     "decisions: water-fill search"),
    ("  tsum = block_sum(tsum, red);", "", "decisions: claims, single slot"),
)


def variants(src):
    """name -> (source, stamps a step, names of the stamps past the five)."""
    barriers = _sub(src, [(call, "(void)0;") for call in _STAGE_CALLS])
    n = 5 + len(_SUB_STAMPS)
    pairs = [("constexpr int STAMPS = 5;", f"constexpr int STAMPS = {n};")]
    pairs += [(a + b, f"{a}\n  stamp(a, j, {5 + k});{b}")
              for k, (a, b, _name) in enumerate(_SUB_STAMPS)]
    return {
        "kernel": (src, 5, []),
        "barriers_only": (barriers, 5, []),
        "sub_stamps": (_sub(src, pairs), n, [m for _a, _b, m in _SUB_STAMPS]),
    }


def main() -> int:
    try:
        import torch
    except ImportError:
        print("ffd_probe: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ffd_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from karpenter_core_tpu_torch.models.provisioner import (
        _BATCH_PAD_LO,
        _bucket,
        _stack_trees,
    )
    from karpenter_core_tpu_torch.ops import cuda_ffd

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    out_dir = cuda_ffd.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    vs = variants(cuda_ffd.SOURCE.read_text())
    procs = {}
    for name, (src, _k, _n) in vs.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [cuda_ffd._nvcc(), *cuda_ffd.NVCC_FLAGS, "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            print(f"ffd_probe: {name} failed to build:\n{err}",
                  file=sys.stderr)
            return 1

    def use(name):  # load that build in the wrapper's place
        cuda_ffd._lib = None
        cuda_ffd.library_path = lambda: out_dir / f"{name}.so"
        cuda_ffd.build()

    shapes = {}
    for name in ("plain_50k_800", "topology_5k_400"):
        make, n_types, max_slots = cs.problems()[name]
        req = cs.first_request(cs.scheduler(n_types, max_slots, "reference"),
                               make())
        shapes[name] = (cuda_ffd.cuda_ffd_solve,
                        (req.init_state, req.steps, req.statics,
                         req.level_iters))
    reqs = {n: cs.first_request(cs.fleet_scheduler(n, "reference"), make())
            for n, (make, _k) in cs.fleet().items()}
    for g, names in enumerate(cs.FLEET_GROUPS):
        rs = [reqs[n] for n in names]
        rs += [rs[0]] * (_bucket(len(rs), lo=_BATCH_PAD_LO) - len(rs))
        shapes[f"fleet_group_{g}"] = (
            # the batched kernel updates its state in place: a copy a scan
            lambda st, *rest, **kw: cuda_ffd.cuda_ffd_solve_batched(
                cs._copy(st), *rest, **kw),
            (_stack_trees([r.init_state for r in rs]),
             _stack_trees([r.steps for r in rs]),
             _stack_trees([r.statics for r in rs]), rs[0].level_iters))

    for shape, (fn, args) in shapes.items():
        J = int(args[1].count.shape[-1])
        row = {"shape": shape, "J": J}
        for name, (_src, n_stamps, sub_names) in vs.items():
            use(name)
            cuda_ffd._STAMPS = n_stamps
            ms = cs._time_ms(lambda: fn(*args), 10)
            stamps = torch.zeros((J, n_stamps), dtype=torch.int64,
                                 device="cuda")
            fn(*args, _stamps=stamps)
            torch.cuda.synchronize()
            rel = (stamps - stamps[:, :1]).double().mean(0) / 1e3
            d = stamps[:, :5].diff(dim=1).double().mean(0) / 1e3
            row[name] = dict(
                ms=ms, us_per_step=ms / J * 1e3, blocks=cuda_ffd.counter.blocks,
                stages={s: float(d[i]) for i, s in enumerate(cs.STAGES)},
                since_step_start={n: float(rel[5 + i])
                                  for i, n in enumerate(sub_names)})
        cuda_ffd._STAMPS = 5
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
