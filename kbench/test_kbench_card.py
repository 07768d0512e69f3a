"""On the card: one short run of each cell, correct and with its metrics
(``python -m pytest kbench -q -m card`` on the H100)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, workload, trace):
    done = subprocess.run(
        [sys.executable, "kbench/run.py", "--workload", workload,
         "--seed", "2147483659", "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["metrics"]
