"""The port's benchmark: one cell of ``BENCHMARK.json`` per run.

    python3 kbench/run.py --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port
(``karpenter_core_tpu_torch``) on a machine with as many CUDA devices as
the cell asks for. The cell's configuration is ``kbench/configs/<config>
.json``, its traffic ``kbench/traffic/<traffic>.json``, and the traffic
names the entry that drives the program (``kbench/entries/<entry>.py``);
each per-layer metric is read by ``kbench/metrics/<metric>.py``. A new
cell, configuration, traffic mix or metric is a new file and a new entry
in ``BENCHMARK.json``; nothing here names one.

A run builds its inputs from the seed, builds or loads the port's kernel
library and warms the cell's own shapes (all set-up, ``setup_s``), calls
the entry in a closed loop for ``--seconds``, and then holds a seeded
sample of what the window produced to the plain reference under
``kbench/reference/``. With ``--trace 1`` it reports the per-layer metrics
instead of the end-to-end ones, from the same window and from a profiled
sub-window after it. The last line of standard output is one JSON object;
the numbers compared, each beside its limit, are the last lines of
standard error and the last key of that object.

Exit codes: 0 with a result; 3 without enough CUDA devices; 4 when JAX or
the JAX package is loaded once the window has closed; 2 for a bad
argument. No result is printed unless the code is 0.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

KBENCH = Path(__file__).resolve().parent
ROOT = KBENCH.parent
# top-level module names that must not be loaded in the measuring process
FORBIDDEN = ("jax", "jaxlib", "flax", "karpenter_core_tpu")
# calls of the entry in the traced sub-window (halved until whole)
TRACE_UNITS = 4
# torch's intra-op threads: load from one process with few threads
THREADS = 4


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: Dict, workload: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def listed(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def card_power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def set_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / ".kbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def host_probe() -> float:
    """Seconds of a fixed pure-Python loop: the host's speed for this
    process, logged beside the window's rate."""
    t = time.perf_counter()
    d: Dict[int, int] = {}
    for i in range(400_000):
        d[i & 1023] = d.get(i & 1023, 0) + i
    return time.perf_counter() - t


class Context:
    """What a per-layer metric reads: the entry's name, the window's
    records and the traced sub-window's summary (None if not traced)."""

    def __init__(self, entry: str, records: List[Dict],
                 trace: Optional[Dict], log_fn):
        self.entry, self.records, self.trace, self.log = (
            entry, records, trace, log_fn)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT) -> Dict:
    """One run of a cell; returns the result object (without printing)."""
    import torch

    kb = root / "kbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = find_cell(bench, workload)
    config = json.loads((kb / "configs" / f"{cell['config']}.json")
                        .read_text())
    traffic = json.loads((kb / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    emod = load(kb / "entries" / f"{traffic['entry']}.py",
                f"kbench_entry_{traffic['entry']}")
    torch.set_num_threads(THREADS)
    if device == "cuda":
        from karpenter_core_tpu_torch.ops import cuda_ffd

        t = time.perf_counter()
        cuda_ffd.build()
        log(f"kernel library ready in {time.perf_counter() - t!r} s")
        torch.cuda.reset_peak_memory_stats()
    entry = emod.Entry(config, traffic, seed, device, log)
    # the harness's own inputs (the pool of backlogs or cluster states and
    # the catalog) leave the collector's view before the program is built,
    # so the program's heap, its warm caches included, stays in view as in
    # a running operator
    gc.collect()
    gc.freeze()
    entry.warm()
    probe = host_probe()
    setup_s = time.perf_counter() - T_START

    records: List[Dict] = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        records.append(entry.call(len(records)))
    rate = entry.end_to_end(records, t0)
    dts = sorted(r["dt"] for r in records)
    log(f"window: {len(records)} calls in {records[-1]['t_end'] - t0!r} s;"
        f" call seconds min {dts[0]:.4f}, median {dts[len(dts) // 2]:.4f},"
        f" max {dts[-1]:.4f}; garbage collections (gen 0, 1, 2)"
        f" {[g['collections'] for g in gc.get_stats()]}")
    log(f"host probe (a fixed pure-Python loop): {probe!r} s before the"
        f" window, {host_probe()!r} s after it")

    # the peak of the window, before the traced sub-window holds its
    # captured launches
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    summary = None
    if trace:
        summary = _trace(entry, len(records), device)
    entry.collect(records)
    entry.free()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    numbers = entry.check(records)
    checks = {}
    correct = True
    for name, (limit, kind) in emod.LIMITS.items():
        value = numbers[name]
        ok = value <= limit if kind == "max" else value >= limit
        correct &= ok
        checks[name] = {"value": value, "limit": limit,
                        "limit_is": kind, "ok": ok}

    if trace:
        ctx = Context(traffic["entry"], records, summary, log)
        metrics = {}
        for m in bench["per_layer"]:
            if not listed(m, workload):
                continue
            reader = load(kb / "metrics" / f"{m['name']}.py",
                          "kbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {}
        for m in bench["end_to_end"]:
            if not listed(m, workload):
                continue
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] == emod.END_TO_END:
                metrics[m["name"]] = {"value": rate, "unit": m["unit"]}

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(records),
           "failed": int(numbers["failed"]), "metrics": metrics,
           "device": dev}
    if trace and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit: {c['limit_is']}"
            f" {c['limit']!r}) {'ok' if c['ok'] else 'FAILED'}")
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                     for k, c in checks.items()}
    return out


def _trace(entry, start: int, device: str) -> Optional[Dict]:
    if device != "cuda":
        return None
    from kbench.lib import trace as ktrace

    return ktrace.profile(lambda k: entry.call(k, keep=False), start,
                          TRACE_UNITS, entry.span_points(), log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    set_caches()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = find_cell(bench, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s);"
            f" available: {torch.cuda.is_available()},"
            f" count: {torch.cuda.device_count()}")
        return 3
    from kbench.lib import roofline

    log(f"card: {card_power_limit()}; roofline peaks"
        f" {roofline.PEAK_BYTES_S!r} B/s, {roofline.PEAK_F32_OPS_S!r}"
        " float32 op/s (H100 SXM data sheet, 700 W)")
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"loaded in the measuring process: {', '.join(bad)}")
        return 4
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
