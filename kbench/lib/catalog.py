"""The instance catalog as plain data, from the configuration's file.

A restatement of upstream Karpenter's ``fake.InstanceTypes(n)``
(``pkg/cloudprovider/fake/instancetype.go``), the catalog its scheduling
benchmark runs: type ``i`` (from 0) is ``fake-it-<i>`` with ``i+1`` cpu,
``2(i+1)`` GiB of memory and ``10(i+1)`` pods; ``NewInstanceType``'s
defaults give every type the architecture amd64, the operating systems
linux, windows and darwin, a kube-reserved overhead of 100m cpu and 10 MiB,
and five offerings (spot in two zones, on-demand in three), each priced by
``PriceFromResources``: 0.1 a cpu plus 0.1 a GB (1e9 bytes) of memory.
Both sides read these rows: the harness builds the program's instance
types from them and the reference checks answers against them.
"""
from __future__ import annotations

from typing import Dict, List

GIB = 2.0**30
MIB = 2.0**20


def catalog_rows(spec: Dict) -> List[Dict]:
    """The configuration's ``spec["types"]`` types, in the generator's
    order."""
    rows = []
    for i in range(spec["types"]):
        step = i + 1
        cpu = float(step * spec["cpu_per_step"])
        memory = step * spec["memory_gib_per_step"] * GIB
        price = spec["price_per_cpu"] * cpu + spec["price_per_gb"] * (
            memory / 1e9)
        rows.append({
            "name": f"{spec['name_prefix']}{i}",
            "cpu": cpu,
            "memory": memory,
            "pods": float(step * spec["pods_per_step"]),
            "arch": spec["arch"],
            "os": list(spec["oses"]),
            "zones": sorted({z for _, z in spec["offerings"]}),
            "offerings": [{"capacity_type": ct, "zone": z, "price": price}
                          for ct, z in spec["offerings"]],
            "overhead": {"cpu": spec["overhead"]["cpu"],
                         "memory": spec["overhead"]["memory_mib"] * MIB},
        })
    return rows
