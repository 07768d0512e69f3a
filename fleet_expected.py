#!/usr/bin/env python3
"""The JAX package's answers that chip_smoke.py holds the port to, on the
same problems: ``FLEET_EXPECTED_NODES`` (phase 6), ``SWEEP_EXPECTED``
(phase 7), ``OPERATOR_EXPECTED`` (phase 8), ``GANGS_EXPECTED``,
``GANG_TENANTS_EXPECTED`` and ``TOPO_EXPECTED`` (phases 9-10),
``RELAX_EXPECTED`` (phase 11), ``HTTP_EXPECTED``, ``TWIN_EXPECTED`` and
``STORM_EXPECTED`` (phase 13).

Run from the root of a checkout, on the CPU:

    JAX_PLATFORMS=cpu python3 fleet_expected.py [fleet] [sweep] [operator] [gangs] [relax] [http] [twin] [storm] [bench]

(all but bench when none is named). Every problem comes from chip_smoke.py's
own recipe (the bench's shared with bench_torch.py) (built with the port's classes and carried into the JAX
package's by pickling, the inverse of
``karpenter_core_tpu_torch.interop.from_reference``):

* fleet: each tenant of the fleet batch is solved alone by the JAX
  package's ``DeviceScheduler`` (xla backend), and all 11 together through
  its ``solve_batch``; the two must agree and place every pod.
* sweep: its ``frontier_core`` over BASELINE config 4 (2,000 nodes, 100
  candidate prefixes, ``max_slots=2560``), run-length encoded.
* operator: its ``Operator(Options(solver="tpu"))`` on each phase-8
  scenario; every pod must be bound. Node count and summed node cpu.
* gangs: its ``DeviceScheduler`` (xla backend) on phase 9's cfg11 problem
  (``chip_smoke.gang_summary``: nodes, evictions, gangs placed,
  atomicity violations, unschedulable pods, result digest), on each of
  the four gang tenants alone and all four through its ``solve_batch``
  (the two must agree; node counts), and on phase 10's cfg18 problem
  (``chip_smoke.topo_summary``: nodes, worst intra-gang hops, gangs
  placed, digest).
* relax: its ``DeviceScheduler`` (xla backend) in each mode (ffd, relax)
  on each of phase 11's problems over the two-pool catalog, the solve
  sequence of ``chip_smoke.RELAX_SOLVES`` (cold, settle, three warm) on one
  scheduler, each solve as ``chip_smoke.relax_summary`` (nodes, cost,
  unschedulable pods, relax outcome, template moves, digest).
* http: its ``Operator(Options(solver="tpu"))`` over its own HTTP
  apiserver process on phase 13's HTTP problem (``chip_smoke.HTTP_PODS``
  pods of plain_5k_400's mix over ``HTTP_TYPES`` types), read back by a
  second client: node count and summed node cpu.
* twin: its ``DigitalTwin`` (``twin/harness.run_scenario``) on phase 13's
  macro scenario (``chip_smoke.twin_scenarios()["macro"]``, carried over
  as the scenario's JSON): ``chip_smoke.twin_summary`` (the ledger JSON's
  sha256, pods bound, peak nodes and $-hours by cluster).
* storm: the same on phase 13d's storm fleet scenario
  (``chip_smoke.twin_scenarios()["storm"]``: an ICE storm, kube and cloud
  chaos, amnesia, a murdered member and a partition over a tier of two
  in-thread solverd members), as ``chip_smoke.storm_summary``: the twin
  summary and the solves its sidecar clients degraded to greedy
  (``rpc_fallbacks``).
* bench: the answers ``bench_torch.py`` holds its configs to that bench.py
  does not print, through its ``DeviceScheduler`` (xla backend) on the
  bench's recipes (bench.py's own where they are functions, else
  bench_torch.py's carried over): shape_churn's node count a round, the
  cfg10 tenant problem's node count (default and BENCH_FAST sizes),
  cfg11's final warm solve's node count (default and BENCH_FAST sizes)
  and the ledger numbers of cfg14's fleet scenario (its twin on the solve
  tier under fleet faults, ``bench_torch._twin_scenarios()["fleet"]``,
  carried over as the scenario's JSON).
  Pinned in ``bench_torch.EXPECTED`` / ``EXPECTED_FAST`` (run only when
  named: ``fleet_expected.py bench``, ~2 min).

The script prints each answer and exits 1 if one differs from the value
pinned in chip_smoke.py (bench: in bench_torch.py).
"""
from __future__ import annotations

import io
import pickle
import sys
import time

import chip_smoke

_PORT, _REF = "karpenter_core_tpu_torch", "karpenter_core_tpu"


class _ToReference(pickle.Unpickler):
    def find_class(self, module, name):
        if module == _PORT or module.startswith(_PORT + "."):
            module = _REF + module[len(_PORT):]
        return super().find_class(module, name)


def to_reference(obj):
    return _ToReference(io.BytesIO(pickle.dumps(obj))).load()


def fleet():
    from karpenter_core_tpu.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu.models.provisioner import (
        DeviceScheduler,
        solve_batch,
    )

    catalog = list(bench_catalog(chip_smoke.FLEET_TYPES))

    def sched(name):
        pool = to_reference(chip_smoke._pool(name))
        return DeviceScheduler([pool], {pool.name: catalog},
                               max_slots=chip_smoke.FLEET_SLOTS,
                               kernel_backend="xla")

    tenants = chip_smoke.fleet()
    pods = {n: to_reference(make()) for n, (make, _k) in tenants.items()}
    alone = {}
    for n in tenants:
        res = sched(n).solve(pods[n])
        if res.pod_errors:
            raise AssertionError(f"{n}: {len(res.pod_errors)} pod errors")
        alone[n] = res.node_count()
    outcomes, stats = solve_batch([(sched(n), pods[n]) for n in tenants])
    batched = {}
    for n, (status, res) in zip(tenants, outcomes):
        if status != "ok" or res.pod_errors:
            raise AssertionError(f"{n}: {status} {res!r}")
        batched[n] = res.node_count()
    if batched != alone:
        raise AssertionError(f"solve_batch {batched} != alone {alone}")
    print(f"solve_batch stats {stats}")
    return alone, chip_smoke.FLEET_EXPECTED_NODES


def sweep():
    from karpenter_core_tpu.models.consolidation import frontier_core

    frontier = frontier_core(**to_reference(chip_smoke.sweep_inputs()),
                             max_slots=chip_smoke.SWEEP_SLOTS)
    return chip_smoke.run_length(frontier), chip_smoke.SWEEP_EXPECTED


def operator():
    from types import SimpleNamespace

    from karpenter_core_tpu.api.objects import Pod
    from karpenter_core_tpu.cloudprovider.kwok import KwokCloudProvider
    from karpenter_core_tpu.kube.store import KubeStore
    from karpenter_core_tpu.operator import Operator, Options
    from karpenter_core_tpu.utils.clock import FakeClock

    ns = SimpleNamespace(Operator=Operator, KubeStore=KubeStore,
                         KwokCloudProvider=KwokCloudProvider,
                         FakeClock=FakeClock, Pod=Pod, convert=to_reference)
    out = {}
    for name, scenario in chip_smoke.OPERATOR_SCENARIOS.items():
        op, run = scenario(ns, Options(solver="tpu"))
        run()
        nodes, cpu, bound = chip_smoke.operator_outcome(op)
        if not bound:
            raise AssertionError(f"{name}: a pod is not bound")
        out[name] = [nodes, cpu]
    return out, chip_smoke.OPERATOR_EXPECTED


def gangs():
    from karpenter_core_tpu.models.provisioner import (
        DeviceScheduler,
        solve_batch,
    )

    def sched(problem, max_slots):
        pool, catalog, existing, _pods = problem
        return DeviceScheduler([pool], {pool.name: list(catalog)},
                               existing_nodes=existing, max_slots=max_slots,
                               kernel_backend="xla")

    out = {}
    prob = to_reference(chip_smoke.gangs_problem())
    res = sched(prob, chip_smoke.GANG_SLOTS).solve(prob[3])
    out["gangs"] = chip_smoke.gang_summary(res, prob[3])
    print(f"gangs: {out['gangs']}", flush=True)

    tenants = {n: to_reference(chip_smoke.gangs_problem(
        chip_smoke.GANG_TENANT_PODS, pool=n)) for n in chip_smoke.GANG_TENANTS}
    alone = {n: chip_smoke.gang_summary(
        sched(p, chip_smoke.GANG_SLOTS).solve(p[3]), p[3])
        for n, p in tenants.items()}
    outcomes, stats = solve_batch(
        [(sched(p, chip_smoke.GANG_SLOTS), p[3]) for p in tenants.values()])
    for n, (status, res) in zip(tenants, outcomes):
        if status != "ok":
            raise AssertionError(f"{n}: {status} {res!r}")
        got = chip_smoke.gang_summary(res, tenants[n][3])
        if got != alone[n]:
            raise AssertionError(f"{n}: solve_batch {got} != alone {alone[n]}")
    print(f"gang tenants: solve_batch stats {stats}", flush=True)
    out["tenants"] = {n: s["nodes"] for n, s in alone.items()}

    prob = to_reference(chip_smoke.topo_problem())
    res = sched(prob, chip_smoke.TOPO_SLOTS).solve(prob[3])
    out["topo"] = chip_smoke.topo_summary(res, prob[3], prob[2])
    return out, dict(gangs=chip_smoke.GANGS_EXPECTED,
                     tenants=chip_smoke.GANG_TENANTS_EXPECTED,
                     topo=chip_smoke.TOPO_EXPECTED)


def relax():
    from karpenter_core_tpu.models.provisioner import DeviceScheduler

    pools, its = to_reference(chip_smoke.relax_world())
    out = {}
    for pname, make in chip_smoke.relax_problems().items():
        pods = to_reference(make())
        out[pname] = {}
        for mode in chip_smoke.RELAX_MODES:
            sched = DeviceScheduler(pools, its,
                                    max_slots=chip_smoke.RELAX_SLOTS,
                                    solver_mode=mode, kernel_backend="xla")
            out[pname][mode] = [
                chip_smoke.relax_summary(sched.solve(pods), pods,
                                         sched.last_phase_stats)
                for _ in chip_smoke.RELAX_SOLVES]
            print(f"relax {pname} {mode}: {out[pname][mode]}", flush=True)
    return out, chip_smoke.RELAX_EXPECTED


def ref_http_run(pods, catalog, pool):
    """The JAX package's ``Operator(Options(solver="tpu"))`` over its own
    HTTP apiserver (``python -m karpenter_core_tpu.kube.httpserver``, a
    child process), the pool and ``pods`` created through its
    ``HttpKubeClient``. Returns what a second client reads back (nodes,
    cpu, every pod bound, pods bound) and the pods' bindings."""
    import subprocess

    from karpenter_core_tpu.cloudprovider.kwok import KwokCloudProvider
    from karpenter_core_tpu.kube.httpclient import HttpKubeClient
    from karpenter_core_tpu.operator import Operator, Options

    proc = subprocess.Popen(
        [sys.executable, "-m", "karpenter_core_tpu.kube.httpserver",
         "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        port = int(proc.stdout.readline().strip().rsplit(":", 1)[1])
        client = HttpKubeClient("127.0.0.1", port)
        client.create(pool)
        for pod in pods:
            client.create(pod)
        op = Operator(kube=client,
                      cloud_provider=KwokCloudProvider(client, catalog),
                      options=Options(solver="tpu", batch_max_duration=0.0,
                                      batch_idle_duration=0.0))
        op.run_until_idle(disrupt=False)
        op.shutdown()
        probe = HttpKubeClient("127.0.0.1", port)
        nodes, bound = probe.list_nodes(), probe.list_pods()
        return ((len(nodes), sum(n.status.capacity.get("cpu", 0)
                                 for n in nodes),
                 all(p.node_name for p in bound),
                 sum(1 for p in bound if p.node_name)),
                sorted((p.name, p.node_name) for p in bound))
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def http():
    from karpenter_core_tpu.cloudprovider.kwok import bench_catalog

    readback, _ = ref_http_run(
        to_reference(chip_smoke._plain_pods(chip_smoke.HTTP_PODS)),
        list(bench_catalog(chip_smoke.HTTP_TYPES)),
        to_reference(chip_smoke._pool()))
    if not readback[2]:
        raise AssertionError(f"http: a pod is not bound ({readback})")
    return list(readback[:2]), chip_smoke.HTTP_EXPECTED


def ref_twin_run(name):
    """The JAX twin's run of ``chip_smoke.twin_scenarios()[name]``,
    carried over as the scenario's JSON; it must raise no violation."""
    from karpenter_core_tpu.metrics import wiring
    from karpenter_core_tpu.twin import scenario_from_json
    from karpenter_core_tpu.twin.harness import run_scenario
    from karpenter_core_tpu_torch.twin import scenario_to_json

    scenario = scenario_from_json(scenario_to_json(
        chip_smoke.twin_scenarios()[name]()))
    with chip_smoke.fresh_counters(wiring):
        result = run_scenario(scenario)
    if result.violations:
        raise AssertionError(f"twin {name}: {result.violations[:3]}")
    return result


def twin():
    return (chip_smoke.twin_summary(ref_twin_run("macro")),
            chip_smoke.TWIN_EXPECTED)


def storm():
    return (chip_smoke.storm_summary(ref_twin_run("storm")),
            chip_smoke.STORM_EXPECTED)


def bench_churn_nodes(n=20000, types=800, rounds=6):
    """bench.py ``_shape_churn_bench``'s rounds on one scheduler: the node
    count a round."""
    import bench
    from karpenter_core_tpu.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu.models.provisioner import DeviceScheduler

    sched = DeviceScheduler([bench._pool()],
                            {"default": list(bench_catalog(types))},
                            max_slots=1024)
    out = []
    for r in range(rounds):
        res = sched.solve(bench._plain_pods(
            n + 53 * r, shapes=(14 + r % 3, 11 + r % 2)))
        assert res.all_pods_scheduled()
        out.append(res.node_count())
    return out


def bench_batch_nodes(n_pods=120, n_types=60):
    """bench.py ``_batch_bench``'s tenant problem (every tenant's has the
    same shape; the pool name differs): its node count."""
    import bench
    from karpenter_core_tpu.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu.models.provisioner import DeviceScheduler

    res = DeviceScheduler([bench._pool("bt00")],
                          {"bt00": list(bench_catalog(n_types))},
                          max_slots=256).solve(
        bench._plain_pods(n_pods, shapes=(6, 4)))
    assert res.all_pods_scheduled()
    return res.node_count()


def bench_gangs_nodes(n_pods=20000, n_existing=None, repeats=3):
    """cfg11's problem (``bench_torch._gangs_problem``, bench.py's inline
    recipe) through one scheduler, a cold solve then ``repeats`` warm
    ones: the last solve's node count."""
    import bench_torch
    from karpenter_core_tpu.models.provisioner import DeviceScheduler

    catalog, existing, pods = to_reference(
        bench_torch._gangs_problem(n_pods, n_existing))
    sched = DeviceScheduler([to_reference(bench_torch._pool())],
                            {"default": list(catalog)},
                            existing_nodes=existing, max_slots=4096)
    for _ in range(1 + repeats):
        res = sched.solve(pods)
    return res.node_count()


def bench_twin_fleet():
    """cfg14's fleet scenario through the JAX twin: the ledger numbers
    ``bench_torch.ANSWERS`` holds."""
    import bench_torch
    from karpenter_core_tpu.metrics import wiring
    from karpenter_core_tpu.twin import scenario_from_json
    from karpenter_core_tpu.twin.harness import run_scenario
    from karpenter_core_tpu_torch.twin import scenario_to_json

    scenario = scenario_from_json(scenario_to_json(
        bench_torch._twin_scenarios()["fleet"]))
    with chip_smoke.fresh_counters(wiring):
        result = run_scenario(scenario)
    return bench_torch._pick(bench_torch._twin_outcome(result),
                             *bench_torch._TWIN_LEDGER)


def bench():
    import bench_torch

    got = {
        "default": {
            "shape_churn": {"nodes_by_round": bench_churn_nodes()},
            "cfg10_batch": {"nodes": [bench_batch_nodes()]},
            "cfg11_gangs": {"nodes": bench_gangs_nodes()},
            "cfg14_twin": {"fleet": bench_twin_fleet()},
        },
        "fast": {
            "cfg10_batch": {"nodes": [bench_batch_nodes(24, 12)]},
            "cfg11_gangs": {"nodes": bench_gangs_nodes(200, 4, repeats=2)},
        },
    }
    tables = {"default": bench_torch.EXPECTED,
              "fast": bench_torch.EXPECTED_FAST}
    pinned = {
        size: {name: {k: (tables[size].get(name) or {}).get(k)
                      for k in answer}
               for name, answer in configs.items()}
        for size, configs in got.items()
    }
    return got, pinned


PARTS = {"fleet": fleet, "sweep": sweep, "operator": operator,
         "gangs": gangs, "relax": relax, "http": http, "twin": twin,
         "storm": storm, "bench": bench}


def main(argv) -> int:
    names = argv or [name for name in PARTS if name != "bench"]
    same = True
    for name in names:
        t0 = time.perf_counter()
        got, pinned = PARTS[name]()
        print(f"{name} ({time.perf_counter() - t0:.1f} s): {got}")
        where = "bench_torch.py" if name == "bench" else "chip_smoke.py"
        print(f"equal to the pinned value in {where}" if got == pinned
              else f"DIFFERENT from the pinned value in {where}")
        same = same and got == pinned
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
