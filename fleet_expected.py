#!/usr/bin/env python3
"""The JAX package's node count for each tenant of chip_smoke.py's fleet
batch: the numbers pinned in ``chip_smoke.FLEET_EXPECTED_NODES``.

Run from the root of a checkout, on the CPU:

    JAX_PLATFORMS=cpu python3 fleet_expected.py

Each tenant's pods and pool come from chip_smoke.py's own recipe (built
with the port's classes and carried into the JAX package's by pickling,
the inverse of ``karpenter_core_tpu_torch.interop.from_reference``). Every
tenant is solved alone by the JAX package's ``DeviceScheduler`` (xla
backend), and all 11 together through its ``solve_batch``. The script
raises unless the two agree and every pod is placed, prints the counts as
a dict, and exits 1 if they differ from the pinned ones.
"""
from __future__ import annotations

import io
import pickle
import sys

import chip_smoke

_PORT, _REF = "karpenter_core_tpu_torch", "karpenter_core_tpu"


class _ToReference(pickle.Unpickler):
    def find_class(self, module, name):
        if module == _PORT or module.startswith(_PORT + "."):
            module = _REF + module[len(_PORT):]
        return super().find_class(module, name)


def to_reference(obj):
    return _ToReference(io.BytesIO(pickle.dumps(obj))).load()


def main() -> int:
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
    print(alone)
    same = alone == chip_smoke.FLEET_EXPECTED_NODES
    print("equal to chip_smoke.FLEET_EXPECTED_NODES" if same
          else "DIFFERENT from chip_smoke.FLEET_EXPECTED_NODES")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
