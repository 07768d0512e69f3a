"""The port's DeviceScheduler against the JAX package's, solve for solve.

Both solve the same problem; the port's copy is carried across with
``interop.from_reference`` and runs on the CPU through the plain scan
(``kernel_backend="reference"``). Its Results, mapped back to the
reference's classes, must encode to the identical result wire
(``codec.encode_solve_results`` with solve_seconds pinned to 0.0).
Hostname placeholders come from a per-module counter, so both counters
start at the same value before each pair of solves.
"""
import copy
import io
import itertools
import pickle

import pytest

from tests.helpers import GIB, make_nodepool, make_pod
from tests.test_fuzz_parity import fuzz_scenario
from tests.torch_threads import one_torch_thread  # noqa: F401

from karpenter_core_tpu.api import labels as L
from karpenter_core_tpu.api.objects import (
    Affinity,
    NodeAffinity,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    ObjectMeta,
    Pod,
    PreferredSchedulingTerm,
)
from karpenter_core_tpu.cloudprovider.kwok import bench_catalog, build_catalog
from karpenter_core_tpu.controllers.provisioning.scheduling import (
    inflight as ref_inflight,
)
from karpenter_core_tpu.controllers.provisioning.scheduling.inflight import (
    SimNode,
)
from karpenter_core_tpu.models.provisioner import DeviceScheduler as RefScheduler
from karpenter_core_tpu.solver import codec
from karpenter_core_tpu_torch import interop
from karpenter_core_tpu_torch.controllers.provisioning.scheduling import (
    inflight as port_inflight,
)
from karpenter_core_tpu_torch.metrics import wiring as port_metrics
from karpenter_core_tpu_torch.models.provisioner import (
    DeviceScheduler as PortScheduler,
)

_PORT = "karpenter_core_tpu_torch"
_REF = "karpenter_core_tpu"


class _BackToReference(pickle.Unpickler):
    """The inverse of interop.from_reference: port classes -> reference."""

    def find_class(self, module, name):
        if module == _PORT or module.startswith(_PORT + "."):
            module = _REF + module[len(_PORT):]
        return super().find_class(module, name)


def to_reference(obj):
    return _BackToReference(io.BytesIO(pickle.dumps(obj))).load()


# ---------------------------------------------------------------------------
# fixtures: (pools, instance_types, existing_nodes, pods, max_slots)


def topology_problem():
    """Zone + hostname spread (tests/test_pallas.py:105)."""
    pools = [make_nodepool()]
    its = {"default": build_catalog()[:16]}
    pods = []
    for i in range(24):
        if i % 3 == 0:
            pods.append(make_pod(cpu=0.25, name=f"t{i}",
                                 spread_hostname=True, labels={"app": "t"}))
        elif i % 3 == 1:
            pods.append(make_pod(cpu=0.5, name=f"t{i}", spread_zone=True))
        else:
            pods.append(make_pod(cpu=0.25 * (1 + i % 4), name=f"t{i}"))
    return pools, its, [], pods, 64


def existing_problem():
    """Existing nodes with live capacity, one tainted, plus fresh demand."""
    from karpenter_core_tpu.api.objects import Taint

    existing = []
    for i, zone in enumerate(("zone-a", "zone-b", "zone-c")):
        existing.append(SimNode(
            name=f"node-{i}",
            labels={
                L.LABEL_TOPOLOGY_ZONE: zone,
                L.LABEL_HOSTNAME: f"node-{i}",
                L.LABEL_OS: "linux",
                L.LABEL_ARCH: "amd64",
                L.CAPACITY_TYPE_LABEL_KEY: "on-demand",
                L.NODEPOOL_LABEL_KEY: "default",
            },
            taints=[Taint(key="batch", effect="NoSchedule")] if i == 2 else [],
            available={"cpu": 2.5 + i, "memory": 8 * GIB, "pods": 110.0},
            capacity={"cpu": 8.0, "memory": 16 * GIB, "pods": 110.0},
            initialized=True,
        ))
    pods = [
        make_pod(cpu=0.5 * (1 + i % 3), memory_gib=0.5, name=f"e{i}",
                 zone_in=["zone-a", "zone-b"] if i % 4 == 0 else None)
        for i in range(40)
    ]
    return [make_nodepool()], {"default": build_catalog()[:24]}, existing, pods, 64


def relax_problem():
    """A preferred node affinity no node can meet: the first round fails
    every pod and relaxation solves again (tests/test_prepared_cache)."""
    pods = [
        Pod(
            metadata=ObjectMeta(name=f"r{i}"),
            resource_requests={"cpu": 0.5, "memory": 1.0 * GIB},
            affinity=Affinity(node_affinity=NodeAffinity(
                preferred=[PreferredSchedulingTerm(
                    weight=1,
                    preference=NodeSelectorTerm(match_expressions=(
                        NodeSelectorRequirement(
                            "no-such-label", "In", ("nope",)
                        ),
                    )),
                )],
            )),
        )
        for i in range(30)
    ]
    return [make_nodepool()], {"default": bench_catalog(8)}, [], pods, 64


def overflow_problem():
    """More nodes than the slot axis holds: the solve overflows and
    regrows."""
    pods = [make_pod(cpu=3.0, memory_gib=1.0, name=f"o{i}") for i in range(40)]
    catalog = build_catalog(cpu_grid=[1, 2, 4], mem_factors=[2])
    return [make_nodepool()], {"default": catalog}, [], pods, 8


def fuzz_problem(seed):
    pods, existing, pools, its = fuzz_scenario(seed)
    return pools, its, existing, pods, 128


FIXTURES = {
    **{f"fuzz{s}": (lambda s=s: fuzz_problem(s)) for s in range(14)},
    "topology": topology_problem,
    "existing": existing_problem,
    "relax": relax_problem,
    "overflow": overflow_problem,
}


def _align_hostnames():
    start = next(ref_inflight._hostname_counter)
    ref_inflight._hostname_counter = itertools.count(start)
    port_inflight._hostname_counter = itertools.count(start)


def solve_both(problem):
    pools, its, existing, pods, max_slots = problem
    port_in = interop.from_reference((pools, its, existing, pods))
    _align_hostnames()
    ref = RefScheduler(
        copy.deepcopy(pools), its, existing_nodes=copy.deepcopy(existing),
        max_slots=max_slots,
    )
    r_ref = ref.solve(copy.deepcopy(pods))
    port = PortScheduler(
        port_in[0], port_in[1], existing_nodes=port_in[2],
        max_slots=max_slots, device="cpu", kernel_backend="reference",
    )
    r_port = port.solve(port_in[3])
    return ref, r_ref, port, r_port


@pytest.mark.parametrize("name", list(FIXTURES))
def test_result_wire_identical(name):
    rejected0 = dict(port_metrics.SOLVER_RESULT_REJECTED.values)
    ref, r_ref, port, r_port = solve_both(FIXTURES[name]())
    w_ref = codec.encode_solve_results(r_ref, 0.0)
    w_port = codec.encode_solve_results(to_reference(r_port), 0.0)
    assert w_port == w_ref, f"result wire diverged on {name}"
    assert dict(port_metrics.SOLVER_RESULT_REJECTED.values) == rejected0
    st_ref, st_port = ref.last_phase_stats, port.last_phase_stats
    assert set(st_port) == set(st_ref)
    assert st_port["kernel_backend"] == "reference"
    for k in ("rounds", "slots", "used_slots", "fetch_bytes"):
        assert st_port[k] == st_ref[k], k
    if name == "relax":
        assert st_port["rounds"] >= 2
    if name == "overflow":
        assert st_port["slots"] > 8


def test_warm_resolve_identical():
    """A second solve on the same scheduler (adaptive slot axis, cached
    class batch) still matches the reference's second solve."""
    pools, its, existing, pods, max_slots = fuzz_problem(3)
    ref, _, port, _ = solve_both((pools, its, existing, pods, max_slots))
    _align_hostnames()
    w_ref = codec.encode_solve_results(ref.solve(copy.deepcopy(pods)), 0.0)
    w_port = codec.encode_solve_results(
        to_reference(port.solve(interop.from_reference(pods))), 0.0
    )
    assert w_port == w_ref
    for k in ("prep_cache_hits", "prep_cache_misses", "slots", "used_slots"):
        assert port.last_phase_stats[k] == ref.last_phase_stats[k], k


def _port_scheduler(**kw):
    pools, its, existing, _pods, _ms = interop.from_reference(
        fuzz_problem(0)
    )
    kw.setdefault("device", "cpu")
    return PortScheduler(pools, its, existing_nodes=existing, **kw)


def test_multi_device_raises(monkeypatch):
    """devices=2 clamps to the one device a CPU host has (as the JAX
    package clamps); a count that resolves above 1 raises (A.13)."""
    from karpenter_core_tpu_torch.parallel import mesh as pmesh

    assert _port_scheduler(devices=2).devices == 1
    monkeypatch.setattr(pmesh, "_available", lambda device: 8)
    with pytest.raises(NotImplementedError, match="A.13"):
        _port_scheduler(devices=2)


def test_unknown_backend_rejected():
    with pytest.raises(ValueError):
        _port_scheduler(kernel_backend="xla")


def test_cuda_backend_on_cpu_tensors_runs_plain():
    """kernel_backend="cuda" with device="cpu": the kernel wrapper sees CPU
    tensors and takes the plain version, launching nothing."""
    from karpenter_core_tpu_torch.ops import cuda_ffd

    pools, its, existing, pods, ms = fuzz_problem(1)
    port_in = interop.from_reference((pools, its, existing, pods))
    before = dict(cuda_ffd.counter.launches)
    a = PortScheduler(port_in[0], port_in[1], existing_nodes=port_in[2],
                      max_slots=ms, device="cpu", kernel_backend="cuda")
    b = PortScheduler(*interop.from_reference((pools, its)),
                      existing_nodes=interop.from_reference(existing),
                      max_slots=ms, device="cpu", kernel_backend="reference")
    _align_hostnames()
    port_inflight._hostname_counter = itertools.count(1)
    wa = codec.encode_solve_results(to_reference(a.solve(port_in[3])), 0.0)
    port_inflight._hostname_counter = itertools.count(1)
    wb = codec.encode_solve_results(
        to_reference(b.solve(interop.from_reference(pods))), 0.0
    )
    assert wa == wb
    assert cuda_ffd.counter.launches == before
    assert a.last_phase_stats["kernel_backend"] == "cuda"
