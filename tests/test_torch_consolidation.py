"""The port's multi-node consolidation sweep against the JAX package's.

Both build the same sweep problem; the port runs on the CPU
(``device="cpu"``), where the CUDA route's wrapper takes the plain batched
scan. The frontier triples must be equal, the price bound to a relative
1e-6 (float32 sums in another order). The card path is held with the kernel
library mocked: a sweep is one batched launch with B = P over a fresh copy
of the prepared state, and never runs the plain scan.
"""
import contextlib
import itertools

import numpy as np
import pytest
import torch

import chip_smoke
from fleet_expected import to_reference
from tests.helpers import make_pod
from tests.test_batched_consolidation import CATALOG
from tests.test_batched_consolidation import underutilized_fleet as ref_fleet
from tests.test_disruption import od_nodepool, replicated
from tests.torch_threads import one_torch_thread  # noqa: F401

from karpenter_core_tpu.controllers.disruption.helpers import (
    get_candidates as ref_get_candidates,
)
from karpenter_core_tpu.controllers.provisioning.scheduling import (
    inflight as ref_inflight,
    nodeclaimtemplate as ref_template,
)
from karpenter_core_tpu.models import consolidation as ref_cons
from karpenter_core_tpu.api import objects as ref_objects
from karpenter_core_tpu_torch import interop
from karpenter_core_tpu_torch.api import objects as port_objects
from karpenter_core_tpu_torch.api.objects import Pod
from karpenter_core_tpu_torch.controllers.disruption.helpers import (
    get_candidates,
    simulate_scheduling,
)
from karpenter_core_tpu_torch.controllers.provisioning.scheduling import (
    inflight as port_inflight,
    nodeclaimtemplate as port_template,
)
from karpenter_core_tpu_torch.models import consolidation as cons
from karpenter_core_tpu_torch.operator import Options
from karpenter_core_tpu_torch.ops import cuda_ffd
from karpenter_core_tpu_torch.ops import ffd as tffd

# config 4's recipe at test size: 8 nodes, 6 candidates, 16 types (the
# last prefix opens fresh nodes, so its price bound is not 0)
SMALL = dict(n_nodes=8, n_cand=6, n_types=16)
SLOTS = 64


def align_counters(start=1):
    """Claim names, hostname placeholders and object uids come from
    module-level counters: both packages start from the same value."""
    for mod in (ref_template, port_template):
        mod._claim_counter = itertools.count(start)
    for mod in (ref_inflight, port_inflight):
        mod._hostname_counter = itertools.count(start)
    for mod in (ref_objects, port_objects):
        mod._uid_counter = itertools.count(start)


def port_fleet(n, kernel_backend="reference"):
    """tests/test_batched_consolidation.py's underutilized_fleet, on the
    port's operator on the CPU."""
    ns = chip_smoke.port_classes()
    op = chip_smoke._new_operator(ns, interop.from_reference(CATALOG), Options(
        solver="tpu",
        device_scheduler_opts={"device": "cpu",
                               "kernel_backend": kernel_backend}))
    op.kube.create(interop.from_reference(od_nodepool()))
    for i in range(n):
        for name in (f"big{i}", f"big{i}b"):
            op.kube.create(interop.from_reference(
                replicated(make_pod(cpu=7.0, name=name))))
    op.run_until_idle(disrupt=False)
    for i in range(n):
        for name in (f"big{i}", f"big{i}b"):
            p = op.kube.get(Pod, name)
            p.metadata.owner_references = []
            op.kube.delete(p)
        op.kube.create(interop.from_reference(
            replicated(make_pod(cpu=0.2, name=f"small{i}"))))
    op.run_until_idle(disrupt=False)
    return op


def candidates_of(op, get):
    cands = get(op.clock, op.cluster, op.kube, op.cloud_provider,
                lambda c: True)
    cands.sort(key=lambda c: c.disruption_cost)
    return cands


def assert_frontiers_equal(port, ref):
    assert port is not None and ref is not None
    assert len(port) == len(ref)
    for p, ((ok, n_new, lb), (ok_r, n_new_r, lb_r)) in enumerate(
            zip(port, ref)):
        assert (ok, n_new) == (ok_r, n_new_r), p
        assert lb == pytest.approx(lb_r, rel=1e-6, abs=0.0), p


# ---------------------------------------------------------------------------
# the sweep's pieces, on the same inputs


def sweep_problems():
    inputs = chip_smoke.sweep_inputs(**SMALL)
    ref_inputs = to_reference(inputs)
    port = cons.sweep_problem(**inputs, max_slots=SLOTS, device="cpu")
    ref_sched = ref_cons.DeviceScheduler(
        ref_inputs["nodepools"], ref_inputs["instance_types"],
        existing_nodes=ref_inputs["cand_nodes"] + ref_inputs["keep_nodes"],
        max_slots=SLOTS, devices=1)
    ref_sched.existing_nodes = (ref_inputs["cand_nodes"]
                                + ref_inputs["keep_nodes"])
    all_pods = [p for pods in ref_inputs["candidate_pods"] for p in pods]
    ref_prep = ref_sched._prepare(all_pods, SLOTS, ref_cons.Topology())
    return inputs, ref_inputs, port, (ref_sched, ref_prep)


def test_prefix_batches_equal():
    inputs, ref_inputs, port, (_s, ref_prep) = sweep_problems()
    _sched, prep, _classes, kind, count = port
    ref_kind, ref_count = ref_cons.prefix_batches(
        ref_prep, [], ref_inputs["candidate_pods"])
    assert kind.dtype == ref_kind.dtype and count.dtype == ref_count.dtype
    np.testing.assert_array_equal(kind, ref_kind)
    np.testing.assert_array_equal(count[:, :ref_count.shape[1]], ref_count)
    assert not count[:, ref_count.shape[1]:].any()  # pad steps count 0
    # base pods count in every prefix
    base = [p for pods in inputs["candidate_pods"][:2] for p in pods]
    k2, c2 = cons.prefix_batches(prep, base, inputs["candidate_pods"])
    rk2, rc2 = ref_cons.prefix_batches(ref_prep, to_reference(base),
                                       ref_inputs["candidate_pods"])
    np.testing.assert_array_equal(k2, rk2)
    np.testing.assert_array_equal(c2, rc2)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_prefix_scan_equal(backend):
    import jax.numpy as jnp

    _inputs, ref_inputs, port, (ref_sched, ref_prep) = sweep_problems()
    sched, prep, classes, kind, count = port
    E = len(sched.existing_nodes)
    got = cons._prefix_scan(
        prep.init_state, classes, prep.statics, kind, count,
        torch.as_tensor(cons._it_price_vector(prep)), E, backend)
    ref_classes = ref_sched._class_steps(ref_prep)
    rk, rc = ref_cons.prefix_batches(ref_prep, [],
                                     ref_inputs["candidate_pods"])
    rc = np.pad(rc, ((0, 0), (0, int(ref_classes.count.shape[0])
                              - rc.shape[1])))
    want = ref_cons._prefix_scan(
        ref_prep.init_state, ref_classes, ref_prep.statics,
        jnp.asarray(rk), jnp.asarray(rc),
        jnp.asarray(ref_cons._it_price_vector(ref_prep)), jnp.int32(E))
    names = ("next_free", "unplaced", "overflow")
    for name, a, b in zip(names, got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-6, atol=0)
    assert got[3].dtype == torch.float32 and got[0].dtype == torch.int32


@pytest.mark.parametrize("n_nodes", [7, 8, 24])
def test_frontier_core_equal_at_config4_shape(n_nodes):
    inputs = chip_smoke.sweep_inputs(n_nodes, 6, 16)
    port = cons.frontier_core(**inputs, max_slots=SLOTS, device="cpu",
                              kernel_backend="reference")
    ref = ref_cons.frontier_core(**to_reference(inputs), max_slots=SLOTS)
    assert_frontiers_equal(port, ref)
    assert chip_smoke.frontier_equal(port, chip_smoke.run_length(ref))
    if n_nodes < 24:  # fresh nodes open, at a price
        assert port[-1][1] > 0 and port[-1][2] > 0


def test_frontier_core_slot_overflow_is_none():
    """A cluster wider than max_slots: None (the caller binary-searches),
    as in the JAX package."""
    inputs = chip_smoke.sweep_inputs(**SMALL)
    assert cons.frontier_core(**inputs, max_slots=4, device="cpu") is None
    assert ref_cons.frontier_core(**to_reference(inputs),
                                  max_slots=4) is None


def test_sweep_leaves_the_prepared_state_unchanged():
    _inputs, _r, port, _ref = sweep_problems()
    sched, prep, classes, kind, count = port
    before = tffd.SlotState(*(x.clone() for x in prep.init_state))
    stack = cons.prefix_stack(prep.init_state, classes, prep.statics, kind,
                              count)
    for tree, base in zip(stack, (prep.init_state, classes, prep.statics)):
        for x, y in zip(tree, base):
            if x is not None:
                assert x.data_ptr() != y.data_ptr()
                assert x.shape == (kind.shape[0], *y.shape)
    for backend in ("cuda", "reference"):
        cons._prefix_scan(prep.init_state, classes, prep.statics, kind,
                          count, torch.as_tensor(
                              cons._it_price_vector(prep)),
                          len(sched.existing_nodes), backend)
    for name, a, b in zip(before._fields, before, prep.init_state):
        assert torch.equal(a, b), name


def test_frontier_rejects_other_kernels_and_devices(monkeypatch):
    from karpenter_core_tpu_torch.parallel import mesh as pmesh

    inputs = chip_smoke.sweep_inputs(**SMALL)
    with pytest.raises(ValueError, match="kernel backend"):
        cons.frontier_core(**inputs, max_slots=SLOTS, device="cpu",
                           kernel_backend="xla")
    # a count that resolves above 1 (here: a host faked to 8 devices) is
    # the prefix axis sharded over several GPUs, ROADMAP A.13
    monkeypatch.setattr(pmesh, "_available", lambda device: 8)
    with pytest.raises(NotImplementedError, match="A.13"):
        cons.frontier_core(**inputs, max_slots=SLOTS, device="cpu",
                           devices=2)
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cons.frontier_core(**inputs, max_slots=SLOTS)


# ---------------------------------------------------------------------------
# the card path with the kernel library mocked


class _FakeLib:
    """The kernel library's C surface, recording each scan it launches."""

    def __init__(self):
        self.calls = []

    def ffd_scan(self, args_ref, max_blocks, stream, blocks_ref):
        args = args_ref._obj
        self.calls.append(dict(B=args.B, J=args.J, valmask=args.valmask,
                               kind=args.kind))
        blocks_ref._obj.value = 132
        return 0

    @staticmethod
    def ffd_scan_smem(N, K, V, Gz):
        return 0

    @staticmethod
    def ffd_error_string(rc):
        return b"fake"


def _no_plain(*args, **kwargs):
    raise AssertionError("the card path ran the plain version")


@contextlib.contextmanager
def fake_card(monkeypatch):
    """CPU tensors take the card path: the batched wrapper goes straight to
    its launch, the library is the fake, and every plain scan raises."""
    lib = _FakeLib()
    monkeypatch.setattr(cuda_ffd, "build", lambda: lib)
    monkeypatch.setattr(cuda_ffd, "_device_stream",
                        lambda dev: contextlib.nullcontext(None))
    monkeypatch.setattr(cuda_ffd, "cuda_ffd_solve_batched",
                        lambda s, c, st, li: cuda_ffd._launch_batched(
                            s, c, st, li))
    for name in ("ffd_solve", "ffd_solve_batched", "ffd_step"):
        monkeypatch.setattr(cuda_ffd.ffd_ops, name, _no_plain)
    monkeypatch.setattr(cons, "ffd_solve_batched", _no_plain)
    cuda_ffd.counter.reset()
    try:
        yield lib
    finally:
        cuda_ffd.counter.reset()


def test_cuda_sweep_is_one_batched_launch(monkeypatch):
    _inputs, _r, port, _ref = sweep_problems()
    sched, prep, classes, kind, count = port
    P = kind.shape[0]
    with fake_card(monkeypatch) as lib:
        out = cons._prefix_scan(
            prep.init_state, classes, prep.statics, kind, count,
            torch.as_tensor(cons._it_price_vector(prep)),
            len(sched.existing_nodes), "cuda")
        assert [(c["B"], c["J"]) for c in lib.calls] == [
            (P, int(classes.count.shape[0]))]
        assert cuda_ffd.counter.launches == dict.fromkeys(cuda_ffd.KERNELS,
                                                          1)
        assert cuda_ffd.counter.rows == P
        # the kernel got a fresh stack, not the prepared state
        assert lib.calls[0]["valmask"] != prep.init_state.valmask.data_ptr()
        assert lib.calls[0]["kind"] != prep.init_state.kind.data_ptr()
    assert [x.shape for x in out] == [(P,)] * 4


def test_reference_sweep_launches_nothing(monkeypatch):
    _inputs, _r, port, _ref = sweep_problems()
    sched, prep, classes, kind, count = port
    monkeypatch.setattr(cuda_ffd, "build", _no_plain)
    launches, rows = dict(cuda_ffd.counter.launches), cuda_ffd.counter.rows
    cons._prefix_scan(prep.init_state, classes, prep.statics, kind, count,
                      torch.as_tensor(cons._it_price_vector(prep)),
                      len(sched.existing_nodes), "reference")
    assert cuda_ffd.counter.launches == launches
    assert cuda_ffd.counter.rows == rows


# ---------------------------------------------------------------------------
# schedulability_frontier over the operator's cluster


@pytest.mark.parametrize("n", [3, 6])
def test_frontier_matches_reference_and_host_simulation(n):
    align_counters()
    ref_op = ref_fleet(n)
    align_counters()
    op = port_fleet(n)
    cands = candidates_of(op, get_candidates)
    ref_cands = candidates_of(ref_op, ref_get_candidates)
    assert [c.name for c in cands] == [c.name for c in ref_cands]
    assert len(cands) >= 2
    frontier = cons.schedulability_frontier(op.provisioner, op.cluster,
                                            cands)
    ref = ref_cons.schedulability_frontier(ref_op.provisioner,
                                           ref_op.cluster, ref_cands)
    assert_frontiers_equal(frontier, ref)
    # and against the port's own host simulation, prefix by prefix
    for p, (ok_device, n_new, price_lb) in enumerate(frontier):
        results = simulate_scheduling(op.provisioner, op.cluster,
                                      cands[: p + 1])
        assert ok_device == results.all_pods_scheduled(), p
        if ok_device:
            assert n_new == results.node_count(), p
            if n_new:
                assert 0.0 < price_lb < float("inf"), (p, price_lb)


def test_topology_pods_fall_back():
    from karpenter_core_tpu_torch.api import labels as L
    from karpenter_core_tpu_torch.api.objects import (
        LabelSelector,
        TopologySpreadConstraint,
    )

    op = port_fleet(2)
    spready = chip_smoke._replicated_pod("spready", 0.2)
    spready.metadata.labels["app"] = "spread"
    spready.topology_spread_constraints = [TopologySpreadConstraint(
        max_skew=1, topology_key=L.LABEL_TOPOLOGY_ZONE,
        when_unsatisfiable="DoNotSchedule",
        label_selector=LabelSelector(match_labels=(("app", "spread"),)))]
    op.kube.create(spready)
    op.run_until_idle(disrupt=False)
    cands = candidates_of(op, get_candidates)
    assert cands
    assert cons.schedulability_frontier(op.provisioner, op.cluster,
                                        cands) is None


def test_sidecar_frontier_goes_over_rpc():
    """With a solver client the sweep crosses the RPC seam to a port
    daemon, which answers with the same frontier as the in-process
    sweep."""
    from karpenter_core_tpu_torch.solver import remote, service

    op = port_fleet(2)
    cands = candidates_of(op, get_candidates)
    local = cons.schedulability_frontier(op.provisioner, op.cluster, cands)
    srv = service.serve(0, daemon=service.SolverDaemon(
        device="cpu", kernel="reference"))
    try:
        op.provisioner.solver_client = remote.SolverClient(
            f"127.0.0.1:{srv.server_address[1]}", timeout=120)
        over_wire = cons.schedulability_frontier(op.provisioner,
                                                 op.cluster, cands)
    finally:
        srv.shutdown()
        srv.server_close()
    assert local is not None and over_wire == local


def test_sidecar_frontier_fails_without_an_answer():
    """No sidecar answers: the sweep raises, and the disruption pass that
    asked fails; nothing is searched on the host instead."""
    import socket

    from karpenter_core_tpu_torch.metrics import wiring as m
    from karpenter_core_tpu_torch.solver import remote

    op = port_fleet(2)
    cands = candidates_of(op, get_candidates)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    op.provisioner.solver_client = remote.SolverClient(
        dead, timeout=5, max_retries=0, sleep=lambda s: None)
    fallbacks = m.SOLVER_RPC_FALLBACKS.value({"endpoint": "consolidate"})
    with pytest.raises(remote.RemoteSolverError) as exc:
        cons.schedulability_frontier(op.provisioner, op.cluster, cands)
    assert exc.value.cause == "error"
    assert m.SOLVER_RPC_FALLBACKS.value(
        {"endpoint": "consolidate"}) == fallbacks
