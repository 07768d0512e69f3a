"""The port's bench (``bench_torch.py``) against bench.py, on the CPU: the
solverd tier configs and the probes in child processes.

Each case calls one of bench.py's config functions and bench_torch's
counterpart with the same small arguments (bench.py's BENCH_FAST sizes
where the config has them), JAX on the CPU and the port with
``device="cpu"``, and holds the port's answers and key set to bench.py's
(``tests/torch_bench_compare.hold``). The solve configs are in
tests/test_torch_bench.py.
"""
from __future__ import annotations

import os

import bench
import bench_torch
import fleet_expected
from tests.torch_bench_compare import (  # noqa: F401
    catalog,
    hold,
    judged,
    port_on_cpu,
)
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_sidecar_matches_bench():
    args = dict(n_pods=64, n_types=40, repeats=1)
    ref = bench._sidecar_bench(**args)
    port = judged("cfg5_sidecar", lambda: bench_torch._sidecar_bench(**args))
    hold("cfg5_sidecar", ref, port)


def test_fleet_matches_bench():
    """Solo node counts equal; the forced shed is refused (the port's
    client has no greedy path) where the reference answers greedily."""
    args = dict(n_tenants=3, n_pods=48, n_types=40, repeats=1)
    ref = bench._fleet_bench(**args)
    port = judged("cfg7_fleet", lambda: bench_torch._fleet_bench(**args))
    hold("cfg7_fleet", ref, port)
    assert ref["shed_parity_ok"] is True
    assert port["shed_refused"] is True and port["greedy_fallbacks"] == 0


def test_batch_matches_bench():
    args = dict(n_tenants=4, n_pods=24, n_types=12, repeats=2)
    ref = bench._batch_bench(**args)
    port = judged("cfg10_batch", lambda: bench_torch._batch_bench(**args))
    hold("cfg10_batch", ref, port, extra={
        "nodes": [fleet_expected.bench_batch_nodes(24, 12)]})
    assert port["backend"] == "cpu" and port["batched"]["solves"] == 8


def test_delta_matches_bench():
    args = dict(n_pods=96, n_nodes=48, n_types=16, rounds=2,
                fleet_tenants=3, fleet_rounds=2, fleet_sizes=(1, 2))
    ref = bench._delta_bench(**args)
    port = judged("cfg13_delta", lambda: bench_torch._delta_bench(**args))
    hold("cfg13_delta", ref, port)


def test_twin_matches_bench():
    ref = bench._twin_bench(scale="fast")
    port = judged("cfg14_twin", lambda: bench_torch._twin_bench(scale="fast"))
    hold("cfg14_twin", ref, port)
    assert port["twin_ok"] is True


def test_incremental_matches_bench():
    args = dict(n_pods=160, n_nodes=24, n_types=16, churn=0.05, rounds=3)
    ref = bench._incremental_bench(**args)
    port = judged("cfg15_incremental",
                  lambda: bench_torch._incremental_bench(**args))
    hold("cfg15_incremental", ref, port)


def test_elastic_matches_bench():
    args = dict(n_tenants=3, n_types=12, n_pods=12, surge_ticks=4,
                quiet_ticks=8, max_members=3)
    ref = bench._elastic_bench(**args)
    port = judged("cfg16_elastic", lambda: bench_torch._elastic_bench(**args))
    hold("cfg16_elastic", ref, port)
    assert port["autoscaled"]["failed_solves"] == 0


def test_multidev_probe_matches_bench(monkeypatch):
    """Without two GPUs both record throughput_skipped and run the parity
    battery in a child on an 8-device virtual CPU mesh (each child on one
    thread: the answers do not depend on it)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("XLA_FLAGS", " ".join(filter(None, (
        os.environ.get("XLA_FLAGS"), "--xla_cpu_multi_thread_eigen=false",
        "intra_op_parallelism_threads=1"))))
    ref = bench._multidev_bench()
    port = judged("cfg8_multidev", bench_torch._multidev_bench)
    hold("cfg8_multidev", ref, port)
    assert port["throughput_skipped"] is True and port["parity_ok"] is True
    assert port["reason"].startswith("cpu backend with 1 device(s)")


def test_restart_probe_answers_the_primary(monkeypatch):
    """The restart probe's child (a fresh process on the CPU) solves the
    primary problem to the JAX package's node count."""
    monkeypatch.setattr(bench_torch, "N_PODS", 64)
    monkeypatch.setattr(bench_torch, "N_TYPES", 40)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ref = bench._solve_bench(bench._plain_pods(64), [bench._pool()],
                             catalog(bench, 40), repeats=1, parity=False)
    port = judged("restart", bench_torch._run_restart_probe)
    assert "error" not in port, port
    assert port["answers"] == {"nodes": ref["nodes"]}
    assert set(port) == {"prewarm_s", "restart_cold_s", "load_s", "nodes",
                         "answers", "expected", "correct", "config_wall_s"}
    assert port["correct"] is True
