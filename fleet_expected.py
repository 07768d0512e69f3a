#!/usr/bin/env python3
"""The JAX package's answers that chip_smoke.py holds the port to, on the
same problems: ``FLEET_EXPECTED_NODES`` (phase 6), ``SWEEP_EXPECTED``
(phase 7), ``OPERATOR_EXPECTED`` (phase 8), ``GANGS_EXPECTED``,
``GANG_TENANTS_EXPECTED`` and ``TOPO_EXPECTED`` (phases 9-10), and
``RELAX_EXPECTED`` (phase 11).

Run from the root of a checkout, on the CPU:

    JAX_PLATFORMS=cpu python3 fleet_expected.py [fleet] [sweep] [operator] [gangs] [relax]

(all five when none is named). Every problem comes from chip_smoke.py's
own recipe (built with the port's classes and carried into the JAX
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

The script prints each answer and exits 1 if one differs from the value
pinned in chip_smoke.py.
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


PARTS = {"fleet": fleet, "sweep": sweep, "operator": operator,
         "gangs": gangs, "relax": relax}


def main(argv) -> int:
    names = argv or list(PARTS)
    same = True
    for name in names:
        t0 = time.perf_counter()
        got, pinned = PARTS[name]()
        print(f"{name} ({time.perf_counter() - t0:.1f} s): {got}")
        print("equal to the pinned value in chip_smoke.py" if got == pinned
              else "DIFFERENT from the pinned value in chip_smoke.py")
        same = same and got == pinned
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
