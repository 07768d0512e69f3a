"""Helpers of the port's bench tests (tests/test_torch_bench*.py): hold
one of ``bench_torch.py``'s config dicts to bench.py's on the same small
problem.

A test module imports ``port_on_cpu`` (an autouse fixture that runs the
port's answer check on the CPU with the plain scan) and calls ``hold``,
which compares the answers (``bench_torch.ANSWERS``, bench.py's names
mapped to the port's by ``RENAMED``) and the port's verdict.
"""
from __future__ import annotations

import json
import os

import pytest

import bench
import bench_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# bench.py's names -> the port's
RENAMED = {
    "cfg17_pallas": {"xla": "reference", "pallas": "cuda",
                     "nodes_delta_pallas_vs_xla":
                         "nodes_delta_cuda_vs_reference"},
}


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port's answer check on the CPU (the plain scan). The tests call
    its config functions at their own small sizes, where no answer is
    pinned: ``hold`` compares the answers with bench.py's directly."""
    monkeypatch.setattr(bench_torch, "DEVICE", "cpu")
    monkeypatch.setattr(bench_torch, "KERNEL", "reference")
    monkeypatch.setattr(bench_torch, "EXPECTED", {})
    monkeypatch.setattr(bench_torch, "EXPECTED_FAST", {})


def renamed(tree, name):
    """bench.py's output with the port's names (cfg17's backends)."""
    rename = RENAMED.get(name, {})
    if isinstance(tree, dict):
        return {rename.get(k, k): renamed(v, name) for k, v in tree.items()}
    return tree


def hold(name, ref, port, extra=None):
    """The port's config dict against bench.py's: answers equal (``extra``:
    the answers bench.py does not print, computed through the JAX package)
    and the port's verdict true."""
    want = json.loads(json.dumps(bench_torch.ANSWERS[name](
        {**renamed(ref, name), **(extra or {})})))
    assert port["answers"] == want, (name, port["answers"], want)
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
