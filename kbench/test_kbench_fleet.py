"""The fleet cell on the CPU: a tiny fleet (4 tenants of 60-pod passes,
grants of 2) runs through ``run.py`` on the port's plain scan and comes
out correct, with its host-side per-layer metrics in a traced run; three
planted faults come out not correct, each by the check that guards it:
two members' answers swapped (``crossed``), a member answered with its
tenant's previous pass (``batched_vs_solo``), half of every pass dropped
(``unplaced``). ``tiny.py`` holds the other cells; this file builds its
own root the same way: a copy of ``kbench/`` with data files added."""
import json
import shutil
from pathlib import Path

import pytest

from kbench import tiny

KB = Path(__file__).resolve().parent
CELL = "tiny-fleet.tiny-batched"
FLEET = "fleet-32t.batched"
HOST = ("grant_p90_s.fleet", "coalesced_pct.fleet", "stack_ms.fleet")
DEVICE = ("device_ms.fleet", "device_idle.fleet")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet") / "root"
    shutil.copytree(KB, root / "kbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    kb = root / "kbench"
    cfg = json.loads((kb / "configs/fleet-32t.json").read_text())
    cfg.update(name="tiny-fleet", tenants=4, max_batch=2)
    (kb / "configs/tiny-fleet.json").write_text(json.dumps(cfg))
    t = json.loads((kb / "traffic/batched.json").read_text())
    t.update(pods=60, backlogs=6, max_slots=32)
    (kb / "traffic/tiny-batched.json").write_text(json.dumps(t))
    bench = json.loads((KB.parent / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": CELL, "config": "tiny-fleet",
                           "traffic": "tiny-batched", "chips": 1,
                           "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELL] if FLEET in m["workloads"] else []
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def test_sound_run_is_correct(root):
    out = tiny.run(root, CELL, seconds=1.5)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["checks"]["held"]["value"] >= 1
    for name in ("crossed", "batched_vs_solo"):
        assert out["checks"][name] == {"value": 0, "limit": 0}
    assert set(out["metrics"]) == {"pods_per_s", "setup_s"}


def test_traced_run_reads_the_host_metrics(root):
    out = tiny.run(root, CELL, seconds=1.5, trace=True)
    assert out["correct"] is True, out["checks"]
    for name in HOST:
        assert isinstance(out["metrics"][name]["value"], float), name
    assert 0.0 <= out["metrics"]["coalesced_pct.fleet"]["value"] <= 100.0
    # device metrics are not read off a CPU run
    assert not set(DEVICE) & set(out["metrics"])


def _fault(monkeypatch, fault):
    from karpenter_core_tpu_torch.models import provisioner as prov

    real = prov.solve_batch
    last = {}

    def broken(entries):
        if fault == "half":
            entries = [(s, pods[: len(pods) // 2]) for s, pods in entries]
        outcomes, stats = real(entries)
        if fault == "swapped":
            outcomes[0], outcomes[1] = outcomes[1], outcomes[0]
        if fault == "previous":
            sched = entries[0][0]
            prev, last[id(sched)] = last.get(id(sched)), outcomes[0]
            if prev is not None:
                outcomes[0] = prev
        return outcomes, stats

    monkeypatch.setattr(prov, "solve_batch", broken)


@pytest.mark.parametrize("fault,check", [
    ("swapped", "crossed"), ("previous", "batched_vs_solo"),
    ("half", "unplaced")])
def test_fault_is_not_correct(root, monkeypatch, fault, check):
    _fault(monkeypatch, fault)
    out = tiny.run(root, CELL, seconds=1.5)
    assert out["attempted"] >= 1
    assert out["correct"] is False, out["checks"]
    got = out["checks"][check]
    assert got["value"] > got["limit"], out["checks"]
