"""The port's answer check (``bench_torch.py``) against bench.py, on the
CPU.

Each case calls one of bench.py's config functions and bench_torch's
counterpart on the same small problem (bench.py's BENCH_FAST sizes where
the config has them, else the fast primary's 64 pods x 40 types; the
``repeats`` of bench.py's timed loops go to bench.py alone), JAX on the
CPU and the port with ``device="cpu"`` (the plain scan), and holds the
port's answers (``bench_torch.ANSWERS``: node counts, evictions, gangs,
$-cost, relax outcome, frontier, wire parity, the twin's ledger) to
bench.py's, the answers bench.py does not print computed through the JAX
package by ``fleet_expected.py``'s helpers, and the port's verdict true.

The tier configs (sidecar, fleet, batch, delta, twin, incremental,
elastic) and the multi-device and restart probes are in
tests/test_torch_bench_tier.py. This file also runs ``bench_torch.py
--device cpu`` end to end, holds its exit code to the verdict, and holds
``--device cuda`` to raising without a GPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

import bench
import bench_torch
import fleet_expected
from tests.torch_bench_compare import (  # noqa: F401
    REPO,
    catalog,
    hold,
    judged,
    masked_pools,
    port_on_cpu,
)
from tests.torch_threads import one_torch_thread  # noqa: F401


def reps(mod, n):
    """bench.py's timed repeats; the port's configs take none."""
    return {"repeats": n} if mod is bench else {}


# config -> fn(module) at small sizes
SOLVE_CASES = {
    "primary": lambda m: m._solve_bench(
        m._plain_pods(64), [m._pool()], catalog(m, 40), **reps(m, 2)),
    "cfg1_5k400": lambda m: m._solve_bench(
        m._plain_pods(300), [m._pool()], catalog(m, 60), **reps(m, 2)),
    "cfg2_masked": lambda m: m._solve_bench(
        m._masked_pods(96), masked_pools(m), catalog(m, 40), **reps(m, 2)),
    "cfg3_topology": lambda m: m._solve_bench(
        m._topology_pods(120), [m._pool()], catalog(m, 40),
        max_slots=256, **reps(m, 2)),
}


@pytest.mark.parametrize("name", sorted(SOLVE_CASES))
def test_solve_configs_match_bench(name):
    ref = SOLVE_CASES[name](bench)
    port = judged(name, lambda: SOLVE_CASES[name](bench_torch))
    hold(name, ref, port)
    assert port["phases"]["kernel_backend"] == "reference"
    assert port["parity_nodes_delta"] == ref["parity_nodes_delta"]


def test_shape_churn_matches_bench():
    args = dict(n=120, types=40, rounds=3)
    ref = bench._shape_churn_bench(**args)
    port = judged("shape_churn",
                  lambda: bench_torch._shape_churn_bench(**args))
    hold("shape_churn", ref, port, extra={
        "nodes_by_round": fleet_expected.bench_churn_nodes(**args)})


def test_consolidation_matches_bench(monkeypatch):
    # both functions fix 2,560 slots over bench_catalog(400); a 40-type
    # catalog keeps the plain batched scan's CPU time small
    import karpenter_core_tpu.cloudprovider.kwok as ref_kwok
    import karpenter_core_tpu_torch.cloudprovider.kwok as port_kwok

    for kwok in (ref_kwok, port_kwok):
        monkeypatch.setattr(kwok, "bench_catalog",
                            lambda n=800, f=kwok.bench_catalog: f(min(n, 40)))
    args = dict(n_nodes=40, n_candidates=8)
    ref = bench._consolidation_bench(**args, repeats=1)
    port = judged("cfg4_consol",
                  lambda: bench_torch._consolidation_bench(**args))
    hold("cfg4_consol", ref, port)
    assert port["schedulable_prefixes"] > 0


def test_ice_storm_matches_bench():
    args = dict(n_pods=64, n_types=40)
    ref = bench._ice_storm_bench(**args, repeats=1)
    port = judged("cfg6_ice_storm",
                  lambda: bench_torch._ice_storm_bench(**args))
    hold("cfg6_ice_storm", ref, port)


def test_gangs_match_bench():
    args = dict(n_pods=200, n_existing=4)
    ref = bench._gangs_bench(**args, repeats=2, cfg1_p50=0.5)
    port = judged("cfg11_gangs", lambda: bench_torch._gangs_bench(**args))
    hold("cfg11_gangs", ref, port, extra={
        "nodes": fleet_expected.bench_gangs_nodes(200, 4, repeats=2)})
    assert port["preemption_count"] > 0 and port["gangs_placed"] > 0


def test_relax_matches_bench():
    ref = bench._relax_bench(n_pods=400, repeats=2)
    port = judged("cfg12_relax", lambda: bench_torch._relax_bench(n_pods=400))
    hold("cfg12_relax", ref, port)
    for shape in ("cfg3_shape", "cfg11_shape"):
        assert port[shape]["relax"]["phases"]["solver_mode"] == "relax"


def test_pallas_config_holds_cuda_to_reference():
    args = dict(n_pods=120, n_types=24, topo_pods=60, topo_types=24,
                max_slots=128, topo_slots=128)
    ref = bench._pallas_bench(**args, repeats=2)
    port = judged("cfg17_pallas", lambda: bench_torch._pallas_bench(**args))
    hold("cfg17_pallas", ref, port)
    assert port["parity_ok"] is True
    for shape in ("primary", "topology"):
        assert port[shape]["cuda"]["phases"]["kernel_backend"] == "cuda"
        assert (port[shape]["reference"]["phases"]["kernel_backend"]
                == "reference")


def test_topoaware_matches_bench():
    args = dict(n_gangs=3, n_plain=60)
    ref = bench._topoaware_bench(**args, repeats=2)
    port = judged("cfg18_topoaware",
                  lambda: bench_torch._topoaware_bench(**args))
    hold("cfg18_topoaware", ref, port)
    assert port["topo_hops_ok"] and port["hard_bound_ok"]


def test_judged_compares_pinned_answers(monkeypatch):
    """A pinned answer that differs makes the config not correct; a run at
    sizes with no pinned answer is judged on its gates alone."""
    monkeypatch.setattr(bench_torch, "EXPECTED", {"cfg5_sidecar":
                                                  {"nodes": 3}})
    monkeypatch.setattr(bench_torch, "FAST", False)
    out = bench_torch._judged("cfg5_sidecar", lambda: {"nodes": 4})
    assert out["expected"] == {"nodes": 3} and out["correct"] is False
    out = bench_torch._judged("cfg5_sidecar", lambda: {"nodes": 3})
    assert out["correct"] is True
    monkeypatch.setattr(bench_torch, "N_PODS", 64)
    out = bench_torch._judged("primary", lambda: {"nodes": 1})
    assert out["expected"] is None and out["correct"] is True
    out = bench_torch._judged("cfg11_gangs", lambda: {
        "nodes": 1, "gang_atomicity_ok": False})
    assert out["correct"] is False


# the pinned tables as the module defines them (the autouse fixture
# empties them for the small-size cases)
PINNED = (bench_torch.EXPECTED, bench_torch.EXPECTED_FAST)


def test_pinned_tables_name_known_configs():
    for table in PINNED:
        assert table and set(table) <= set(bench_torch.ANSWERS)
    assert set(bench_torch.GATES) <= set(bench_torch.ANSWERS)


def _json_line(stdout):
    for cand in reversed(stdout.strip().splitlines()):
        try:
            return json.loads(cand)
        except ValueError:
            continue
    return None


def test_fast_bench_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py"), "--device",
         "cpu"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env={**os.environ, "BENCH_FAST": "1", "BENCH_PODS": "64",
             "BENCH_TYPES": "40", "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.strip().splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1, proc.stdout[-2000:]
    line = json.loads(lines[0])
    # answers and the verdict only: no throughput headline, no timing
    assert set(line) == {"configs", "device", "torch", "cuda",
                         "source_digest", "correct", "detail"}
    assert line["device"]["platform"] == "cpu"
    assert line["device"]["power_limit_w"] is None
    assert line["correct"] is True
    assert len(line["source_digest"]) == 64
    assert list(line["detail"]) == [
        "primary", "cfg10_batch", "cfg11_gangs", "cfg12_relax",
        "cfg13_delta", "cfg14_twin", "cfg15_incremental", "cfg16_elastic",
        "cfg17_pallas", "cfg18_topoaware"]
    for name, cfg in line["detail"].items():
        assert cfg["correct"] is True, (name, cfg["answers"])
        # nothing on a CPU run is named a device reading
        for word in ("readings", "kernel_launches"):
            assert word not in json.dumps(cfg), (name, word)
    assert line["detail"]["primary"]["phases"]["kernel_backend"] == \
        "reference"


def test_device_cuda_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda runs there")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py")],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "BENCH_FAST": "1", "BENCH_PODS": "64",
             "BENCH_TYPES": "40"},
    )
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert _json_line(proc.stdout) is None


def test_exit_code_is_the_verdict(monkeypatch, capsys):
    """``main`` exits 0 when every config is correct, however long the
    configs take (here the clock jumps an hour a reading), and 4 when one
    is not, after printing its line."""
    hour = iter(range(0, 10 ** 9, 3600))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(hour)))
    monkeypatch.setattr(bench_torch, "N_PODS", 64)
    monkeypatch.setattr(bench_torch, "N_TYPES", 40)
    monkeypatch.setattr(bench_torch, "FAST", False)
    monkeypatch.setattr(sys, "argv", ["bench_torch.py", "--device", "cpu",
                                      "--configs", "cfg5_sidecar"])
    monkeypatch.setattr(bench_torch, "_solve_bench",
                        lambda *a, **k: {"nodes": 3, "greedy_nodes": 3})
    monkeypatch.setattr(bench_torch, "_sidecar_bench", lambda: {"nodes": 3})
    for pinned, rc in (({"nodes": 3}, 0), ({"nodes": 4}, 4)):
        monkeypatch.setattr(bench_torch, "EXPECTED",
                            {"cfg5_sidecar": pinned})
        assert bench_torch.main() == rc
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert list(line["detail"]) == ["primary", "cfg5_sidecar"]
        assert line["correct"] is (rc == 0)
        assert line["detail"]["cfg5_sidecar"]["correct"] is (rc == 0)


def _card_line():
    """A bench_torch line as the card prints it (BENCH_FAST shape, three
    configs), for phase 15's checks."""
    phases = {"kernel_backend": "cuda", "kernel_launches": 1}
    return {
        "device": {"platform": "gpu", "name": "NVIDIA H100 80GB HBM3",
                   "power_limit_w": 700.0, "count": 1},
        "correct": True,
        "source_digest": "0" * 64,
        "detail": {
            "primary": {"correct": True, "answers": {}, "expected": None,
                        "phases": dict(phases)},
            "cfg17_pallas": {
                "correct": True, "answers": {}, "expected": None,
                "primary": {
                    "cuda": {"phases": dict(phases)},
                    "reference": {"phases": {**phases,
                                             "kernel_backend": "reference",
                                             "kernel_launches": 0}},
                },
            },
            "cfg14_twin": {"correct": True, "answers": {}, "expected": None,
                           "readings": {"kernel_launches": 0}},
        },
    }


def test_phase_15_holds_the_line_to_the_card_and_the_answers():
    import chip_smoke

    name = "NVIDIA H100 80GB HBM3"
    out = chip_smoke.hold_bench_line(_card_line(), 0, name, 1.0)
    assert out["launches"] == 2 and out["primary_launches"] == 1
    assert out["rc"] == 0
    bad = []
    line = _card_line()
    line["device"]["platform"] = "cpu"
    bad.append((line, 0))
    line = _card_line()
    line["detail"]["primary"]["correct"] = False
    bad.append((line, 4))
    line = _card_line()
    line["detail"]["primary"]["phases"]["kernel_backend"] = "reference"
    bad.append((line, 0))
    line = _card_line()
    line["detail"]["primary"]["phases"]["kernel_launches"] = 0
    bad.append((line, 0))
    line = _card_line()
    line["detail"]["cfg17_pallas"]["primary"]["reference"]["phases"][
        "kernel_launches"] = 1
    bad.append((line, 0))
    # every config correct, so only exit code 0 is right
    bad.append((_card_line(), 1))
    bad.append((_card_line(), 4))
    for line, rc in bad:
        with pytest.raises(AssertionError):
            chip_smoke.hold_bench_line(line, rc, name, 1.0)
