#!/usr/bin/env python3
"""The JAX package's answers that chip_smoke.py holds the port to, on the
same problems: ``FLEET_EXPECTED_NODES`` (phase 6), ``SWEEP_EXPECTED``
(phase 7) and ``OPERATOR_EXPECTED`` (phase 8).

Run from the root of a checkout, on the CPU:

    JAX_PLATFORMS=cpu python3 fleet_expected.py [fleet] [sweep] [operator]

(all three when none is named). Every problem comes from chip_smoke.py's
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


PARTS = {"fleet": fleet, "sweep": sweep, "operator": operator}


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
