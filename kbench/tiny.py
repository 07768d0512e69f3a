"""Tiny cells for the benchmark's CPU tests: a copy of ``kbench/`` and a
``BENCHMARK.json`` under a temporary root, with traffic and a cluster cut
to a size the plain scan answers in seconds. Only data files are added;
the harness finds them by name."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

KBENCH = Path(__file__).resolve().parent
ROOT = KBENCH.parent

DIVERSE = "fake-400t.tiny-diverse"
GENERIC = "fake-400t.tiny-generic"
SWEEP = "tiny-consol.tiny-sweep"


def make_root(tmp: Path) -> Path:
    """A checkout-like root holding a copy of kbench/ and the tiny cells."""
    root = tmp / "root"
    shutil.copytree(KBENCH, root / "kbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    kb = root / "kbench"

    def edit(src, dst, **over):
        d = json.loads((kb / src).read_text())
        d.update(over)
        (kb / dst).write_text(json.dumps(d))
        return d

    edit("traffic/diverse-5k.json", "traffic/tiny-diverse.json", pods=120,
         backlogs=2, max_slots=64)
    edit("traffic/generic-50k.json", "traffic/tiny-generic.json", pods=150,
         backlogs=2, max_slots=64)
    edit("traffic/sweep.json", "traffic/tiny-sweep.json", states=2)
    cfg = json.loads((kb / "configs/consol-5k.json").read_text())
    cfg["name"] = "tiny-consol"
    cfg["cluster"].update(nodes=60, candidates=10, max_slots=128)
    (kb / "configs/tiny-consol.json").write_text(json.dumps(cfg))

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    fake = [DIVERSE, GENERIC]
    bench["workloads"] = [
        {"name": DIVERSE, "config": "fake-400t", "traffic": "tiny-diverse",
         "chips": 1, "why": "test"},
        {"name": GENERIC, "config": "fake-400t", "traffic": "tiny-generic",
         "chips": 1, "why": "test"},
        {"name": SWEEP, "config": "tiny-consol", "traffic": "tiny-sweep",
         "chips": 1, "why": "test"},
    ]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = (fake if any(w.startswith("fake")
                                          for w in m["workloads"])
                              else [SWEEP])
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run(root: Path, workload: str, seed: int = 2**31 + 11,
        seconds: float = 1.0, trace: bool = False):
    """``run.run_cell`` on the CPU (the look for a card skipped)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("kbench_run",
                                                  KBENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.run_cell(workload, seed, seconds, trace, device="cpu",
                        root=root)
