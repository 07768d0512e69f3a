"""The port's bench (``bench_torch.py``) against bench.py, on the CPU.

Each case calls one of bench.py's config functions and bench_torch's
counterpart with the same small arguments (bench.py's BENCH_FAST sizes
where the config has them, else the fast primary's 64 pods x 40 types),
JAX on the CPU and the port with ``device="cpu"`` (the plain scan), and
compares:

* the answers (``bench_torch.ANSWERS``: node counts, evictions, gangs,
  $-cost, relax outcome, frontier, wire bytes, the twin's ledger), the
  answers bench.py does not print computed through the JAX package by
  ``fleet_expected.py``'s helpers;
* the key set of each config's dict (two levels deep), timings' values
  excluded, with the port's additions, removals and renames named below.

The tier configs (sidecar, fleet, batch, delta, twin, incremental,
elastic) and the multi-device and restart probes are in
tests/test_torch_bench_tier.py. This file also runs ``bench_torch.py
--device cpu`` end to end and holds ``--device cuda`` to raising without a
GPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

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

# config -> fn(module) at small sizes
SOLVE_CASES = {
    "primary": lambda m: m._solve_bench(
        m._plain_pods(64), [m._pool()], catalog(m, 40), repeats=2),
    "cfg1_5k400": lambda m: m._solve_bench(
        m._plain_pods(300), [m._pool()], catalog(m, 60), repeats=2),
    "cfg2_masked": lambda m: m._solve_bench(
        m._masked_pods(96), masked_pools(m), catalog(m, 40), repeats=2),
    "cfg3_topology": lambda m: m._solve_bench(
        m._topology_pods(120), [m._pool()], catalog(m, 40),
        max_slots=256, repeats=2),
}


@pytest.mark.parametrize("name", sorted(SOLVE_CASES))
def test_solve_configs_match_bench(name):
    ref = SOLVE_CASES[name](bench)
    port = judged(name, lambda: SOLVE_CASES[name](bench_torch))
    hold(name, ref, port)
    assert port["phases"]["kernel_backend"] == "reference"
    assert port["parity_nodes_delta"] == ref["parity_nodes_delta"]


def test_verified_summary_matches_bench():
    primary = SOLVE_CASES["primary"](bench)
    cfg1 = SOLVE_CASES["cfg1_5k400"](bench)
    ref = bench._verified_summary(primary, cfg1)
    port = judged("cfg9_verified",
                  lambda: bench_torch._verified_summary(primary, cfg1))
    hold("cfg9_verified", ref, port)
    assert port["pct_of_primary_p50"] == ref["pct_of_primary_p50"]


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
    args = dict(n_nodes=40, n_candidates=8, repeats=1)
    ref = bench._consolidation_bench(**args)
    port = judged("cfg4_consol",
                  lambda: bench_torch._consolidation_bench(**args))
    hold("cfg4_consol", ref, port)
    assert port["schedulable_prefixes"] > 0


def test_ice_storm_matches_bench():
    args = dict(n_pods=64, n_types=40, repeats=1)
    ref = bench._ice_storm_bench(**args)
    port = judged("cfg6_ice_storm",
                  lambda: bench_torch._ice_storm_bench(**args))
    hold("cfg6_ice_storm", ref, port)


def test_gangs_match_bench():
    args = dict(n_pods=200, n_existing=4, repeats=2, cfg1_p50=0.5)
    ref = bench._gangs_bench(**args)
    port = judged("cfg11_gangs", lambda: bench_torch._gangs_bench(**args))
    hold("cfg11_gangs", ref, port, extra={
        "nodes": fleet_expected.bench_gangs_nodes(200, 4, repeats=2)})
    assert port["preemption_count"] > 0 and port["gangs_placed"] > 0


def test_relax_matches_bench():
    ref = bench._relax_bench(n_pods=400, repeats=2)
    port = judged("cfg12_relax",
                  lambda: bench_torch._relax_bench(n_pods=400, repeats=2))
    hold("cfg12_relax", ref, port)
    for shape in ("cfg3_shape", "cfg11_shape"):
        assert port[shape]["relax"]["phases"]["solver_mode"] == "relax"


def test_pallas_config_holds_cuda_to_reference():
    args = dict(n_pods=120, n_types=24, topo_pods=60, topo_types=24,
                max_slots=128, topo_slots=128, repeats=2)
    ref = bench._pallas_bench(**args)
    port = judged("cfg17_pallas", lambda: bench_torch._pallas_bench(**args))
    hold("cfg17_pallas", ref, port)
    assert port["parity_ok"] is True
    for shape in ("primary", "topology"):
        assert port[shape]["cuda"]["phases"]["kernel_backend"] == "cuda"
        assert (port[shape]["reference"]["phases"]["kernel_backend"]
                == "reference")


def test_topoaware_matches_bench():
    args = dict(n_gangs=3, n_plain=60, repeats=2)
    ref = bench._topoaware_bench(**args)
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
    assert line["metric"] == "solve_throughput_64pods_40types"
    assert line["device"]["platform"] == "cpu"
    assert line["device"]["power_limit_w"] is None
    assert line["build_s"] is None and line["correct"] is True
    assert len(line["source_digest"]) == 64
    assert list(line["detail"]) == [
        "primary", "cfg10_batch", "cfg11_gangs", "cfg12_relax",
        "cfg13_delta", "cfg14_twin", "cfg15_incremental", "cfg16_elastic",
        "cfg17_pallas", "cfg18_topoaware"]
    for name, cfg in line["detail"].items():
        assert cfg["correct"] is True, (name, cfg["answers"])
        # nothing on a CPU run is named a device metric
        for word in ("readings", "kernel_launches", "device_idle_share",
                     "peak_device_bytes"):
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


def _card_line():
    """A bench_torch line as the card prints it (BENCH_FAST shape, two
    configs), for phase 15's checks."""
    phases = {"kernel_backend": "cuda", "kernel_launches": 1,
              "device_idle_share": 0.98, "peak_device_bytes": 1 << 20}
    return {
        "device": {"platform": "gpu", "name": "NVIDIA H100 80GB HBM3",
                   "power_limit_w": 700.0, "count": 1},
        "correct": True, "budget_ok": True, "build_s": 0.01,
        "source_digest": "0" * 64,
        "detail": {
            "primary": {"correct": True, "answers": {}, "expected": None,
                        "p50_solve_s": 0.4, "phases": dict(phases)},
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
    bad.append((_card_line(), 1))  # rc 1 with budget_ok true
    for line, rc in bad:
        with pytest.raises(AssertionError):
            chip_smoke.hold_bench_line(line, rc, name, 1.0)
    line = _card_line()
    line["budget_ok"] = False  # over bench.py's 1-s budget: rc 1 is right
    chip_smoke.hold_bench_line(line, 1, name, 1.0)
