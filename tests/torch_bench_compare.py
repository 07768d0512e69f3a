"""Helpers of the port's bench tests (tests/test_torch_bench*.py): hold
one of ``bench_torch.py``'s config dicts to bench.py's on the same small
problem.

A test module imports ``port_on_cpu`` (an autouse fixture that runs the
port's bench on the CPU with the plain scan) and calls ``hold``. Compared:
the answers (``bench_torch.ANSWERS``), and the key set of the config's
dict two levels deep, up to the port's named additions, removals and
renames below.
"""
from __future__ import annotations

import json
import os

import pytest

import bench
import bench_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# what every port config adds: its verdict, and on the card its readings
ADDED_ALL = {"answers", "expected", "correct", "readings", "config_wall_s"}
# keys the port adds to one config
ADDED = {
    "shape_churn": {"nodes_by_round"},
    "cfg10_batch": {"nodes"},
    "cfg11_gangs": {"nodes"},
    "cfg14_twin": {"rpc_failures"},
    "cfg18_topoaware": {"phases"},
}
# bench.py's keys the port drops: cfg17's speed verdicts (the plain scan
# is the kernel's oracle, not a speed baseline)
REMOVED = {
    "cfg17_pallas": {"speedup_vs_xla", "primary_p50_target_ok",
                     "topology_halved_ok", "speedup_note"},
}
# bench.py's names -> the port's
RENAMED = {
    "cfg17_pallas": {"xla": "reference", "pallas": "cuda",
                     "nodes_delta_pallas_vs_xla":
                         "nodes_delta_cuda_vs_reference"},
}
# dicts keyed by data (tenants, workload classes, reasons), not schema
DATA_KEYED = {"per_tenant", "sheds_by_reason", "cache_evictions", "slo",
              "outcomes", "ledger", "peak_nodes", "utilization", "routed",
              "parity", "relax", "cost_dollar_hours"}


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port's bench on the CPU (the plain scan). The tests call its
    config functions at their own small sizes, where no answer is pinned:
    ``hold`` compares the answers with bench.py's directly."""
    monkeypatch.setattr(bench_torch, "DEVICE", "cpu")
    monkeypatch.setattr(bench_torch, "KERNEL", "reference")
    monkeypatch.setattr(bench_torch, "EXPECTED", {})
    monkeypatch.setattr(bench_torch, "EXPECTED_FAST", {})


def key_paths(d, name, depth=2, prefix=()):
    rename = RENAMED.get(name, {})
    out = set()
    for k, v in d.items():
        path = prefix + (rename.get(k, k),)
        out.add(path)
        if isinstance(v, dict) and depth > 1 and k not in DATA_KEYED:
            out |= key_paths(v, name, depth - 1, path)
    return out


def renamed(tree, name):
    """bench.py's output with the port's names (cfg17's backends)."""
    rename = RENAMED.get(name, {})
    if isinstance(tree, dict):
        return {rename.get(k, k): renamed(v, name) for k, v in tree.items()}
    return tree


def hold(name, ref, port, extra=None):
    """The port's config dict against bench.py's: answers equal (``extra``:
    the answers bench.py does not print, computed through the JAX package),
    key sets equal up to the named differences, and the port's verdict
    true."""
    want = json.loads(json.dumps(bench_torch.ANSWERS[name](
        {**renamed(ref, name), **(extra or {})})))
    assert port["answers"] == want, (name, port["answers"], want)
    added = ADDED_ALL | ADDED.get(name, set())
    removed = REMOVED.get(name, set())
    got = {p for p in key_paths(port, name) if not added & set(p)}
    exp = {p for p in key_paths(ref, name) if not removed & set(p)}
    assert got == exp, (name, sorted(got - exp), sorted(exp - got))
    assert port["correct"] is True, (name, port)


def judged(name, fn):
    return bench_torch._judged(name, fn)


def catalog(mod, n):
    """``bench_catalog(n)`` of bench.py's package or of the port."""
    if mod is bench:
        from karpenter_core_tpu.cloudprovider.kwok import bench_catalog
    else:
        from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    return bench_catalog(n)


def masked_pools(mod):
    if mod is bench:
        from karpenter_core_tpu.api import labels as L
        from karpenter_core_tpu.api.objects import (
            NodeSelectorRequirement,
            Taint,
        )
    else:
        from karpenter_core_tpu_torch.api import labels as L
        from karpenter_core_tpu_torch.api.objects import (
            NodeSelectorRequirement,
            Taint,
        )
    pools = [
        mod._pool("default"),
        mod._pool("batch",
                  taints=[Taint(key="batch", value="", effect="NoSchedule")],
                  requirements=[
                      NodeSelectorRequirement(L.LABEL_ARCH, "In", ("amd64",)),
                      NodeSelectorRequirement(L.LABEL_OS, "In", ("linux",)),
                  ]),
    ]
    pools[1].spec.template.labels["pool"] = "batch"
    return pools
