"""The port's multi-node consolidation sweep against the JAX package's.

Both build the same sweep problem; the port runs on the CPU
(``device="cpu"``), where the CUDA route's wrapper takes the plain batched
scan. The frontier triples must be equal, the price bound to a relative
1e-6 (float32 sums in another order). The sweep's stack is P real copies
of the slot state (its requirement plane packed on the kernel's route)
and one copy of the class steps and statics expanded with stride 0; the
plain batched scan reads those views and never writes them. The card path
is held with the kernel library mocked: a sweep is one launch through
``cuda_ffd_solve_prefixes`` with B = P over a fresh packed copy of the
prepared state and the shared read-only trees, and never runs the plain
scan.
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


@pytest.mark.parametrize("packed", [False, True])
def test_sweep_leaves_the_prepared_state_unchanged(packed):
    _inputs, _r, port, _ref = sweep_problems()
    sched, prep, classes, kind, count = port
    before = tffd.SlotState(*(x.clone() for x in prep.init_state))
    state = prep.init_state
    if packed:
        state = cuda_ffd.pack_state(state)
    stack = cons.prefix_stack(state, classes, prep.statics, kind, count)
    for tree, base in zip(stack, (prep.init_state, classes, prep.statics)):
        for name, x, y in zip(tree._fields, tree, base):
            if x is not None:
                assert x.data_ptr() != y.data_ptr()
                if name == "valmask" and packed:
                    y = cuda_ffd.pack_values(y)
                    assert x.dtype == torch.uint8
                assert x.shape == (kind.shape[0], *y.shape)
    for backend in ("cuda", "reference"):
        cons._prefix_scan(prep.init_state, classes, prep.statics, kind,
                          count, torch.as_tensor(
                              cons._it_price_vector(prep)),
                          len(sched.existing_nodes), backend)
    for name, a, b in zip(before._fields, before, prep.init_state):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("packed", [False, True])
def test_prefix_stack_shares_the_read_only_trees(packed):
    """The class steps (less their counts) and the statics are one copy
    each, expanded over the prefix axis with stride 0: one storage of one
    row. Every slot-state leaf is P real rows of the prepared state (the
    kinds per prefix), the requirement plane packed on the kernel's route;
    the counts are a row a prefix."""
    _inputs, _r, port, _ref = sweep_problems()
    sched, prep, classes, kind, count = port
    P = kind.shape[0]
    state = prep.init_state
    if packed:
        state = cuda_ffd.pack_state(state)
    st, steps, statics = cons.prefix_stack(state, classes, prep.statics,
                                           kind, count)
    for tree, base in ((steps, classes), (statics, prep.statics)):
        for name, x, y in zip(tree._fields, tree, base):
            if x is None:
                continue
            assert x.shape == (P, *y.shape), name
            if name == "count":
                assert x.is_contiguous()
                np.testing.assert_array_equal(x.numpy(), count)
                continue
            assert x.stride(0) == 0, name
            assert (x.untyped_storage().nbytes()
                    == y.numel() * y.element_size()), name
            assert torch.equal(x[P - 1], y), name
    for name, x, y in zip(st._fields, st, prep.init_state):
        assert x.is_contiguous() and x.shape[0] == P, name
        assert (x.untyped_storage().nbytes()
                == x.numel() * x.element_size()), name
        if name == "valmask" and packed:
            assert x.dtype == torch.uint8
            x = cuda_ffd.unpack_values(x)
        for p in range(P):
            if name == "kind":
                np.testing.assert_array_equal(x[p].numpy(), kind[p])
            else:
                assert torch.equal(x[p], y), (name, p)


def test_plain_batched_scan_reads_the_shared_stack_only():
    """The plain batched scan over the sweep's stack (shared steps and
    statics) gives, plane for plane, what it gives over P real copies of
    them, and leaves the shared views as they were."""
    _inputs, _r, port, _ref = sweep_problems()
    sched, prep, classes, kind, count = port
    P = kind.shape[0]
    st, steps, statics = cons.prefix_stack(prep.init_state, classes,
                                           prep.statics, kind, count)
    before = [x.clone() for t in (steps, statics) for x in t
              if x is not None]
    got = tffd.ffd_solve_batched(st, steps, statics, tffd.LEVEL_ITERS)
    real = (cons._repeat(classes, P)._replace(count=steps.count),
            cons._repeat(prep.statics, P))
    want = tffd.ffd_solve_batched(st, *real, tffd.LEVEL_ITERS)
    for a, b in zip(list(got[0]) + list(got[1:]),
                    list(want[0]) + list(want[1:])):
        assert torch.equal(a, b)
    after = [x for t in (steps, statics) for x in t if x is not None]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_prefix_entry_on_the_cpu_is_the_plain_scan_of_the_packed_stack():
    """``cuda_ffd_solve_prefixes`` on CPU tensors: the plain batched scan
    of the unpacked stack, its final plane packed again; no launch."""
    _inputs, _r, port, _ref = sweep_problems()
    sched, prep, classes, kind, count = port
    stack = cons.prefix_stack(cuda_ffd.pack_state(prep.init_state), classes,
                              prep.statics, kind, count)
    plain = cons.prefix_stack(prep.init_state, classes, prep.statics, kind,
                              count)
    launches = dict(cuda_ffd.counter.launches)
    prefix_launches = cuda_ffd.counter.prefix_launches
    got = cuda_ffd.cuda_ffd_solve_prefixes(*stack, tffd.LEVEL_ITERS)
    want = tffd.ffd_solve_batched(*plain, tffd.LEVEL_ITERS)
    assert got[0].valmask.dtype == torch.uint8
    assert torch.equal(cuda_ffd.unpack_values(got[0].valmask),
                       want[0].valmask)
    for name, a, b in zip(got[0]._fields, got[0], want[0]):
        if name != "valmask":
            assert torch.equal(a, b), name
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert cuda_ffd.counter.launches == launches
    assert cuda_ffd.counter.prefix_launches == prefix_launches


def test_frontier_rejects_other_kernels_and_devices(monkeypatch):
    from karpenter_core_tpu_torch.parallel import mesh as pmesh

    inputs = chip_smoke.sweep_inputs(**SMALL)
    with pytest.raises(ValueError, match="kernel backend"):
        cons.frontier_core(**inputs, max_slots=SLOTS, device="cpu",
                           kernel_backend="xla")
    # a count that resolves above 1 (here: an 8-device virtual CPU mesh)
    # splits the prefix axis over the mesh, with the frontier of one
    # device and of the JAX package's 2-device sweep
    one = cons.frontier_core(**inputs, max_slots=SLOTS, device="cpu")
    pmesh.force_virtual_mesh(8, "cpu")
    try:
        two = cons.frontier_core(**inputs, max_slots=SLOTS, device="cpu",
                                 devices=2)
    finally:
        pmesh.force_virtual_mesh(0, "cpu")
    assert two == one
    assert_frontiers_equal(two, ref_cons.frontier_core(
        **to_reference(inputs), max_slots=SLOTS, devices=2))
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
                               kind=args.kind, c_mask=args.c_mask,
                               t_mask=args.t_mask,
                               step_stride=args.step_stride,
                               static_stride=args.static_stride))
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
    monkeypatch.setattr(cuda_ffd, "cuda_ffd_solve_prefixes",
                        lambda s, c, st, li: cuda_ffd._launch_prefixes(
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
    stacks = []
    launch = cuda_ffd._launch_batched

    def spy(state, steps, statics, li, *args, **kwargs):
        stacks.append((state, steps, statics))
        return launch(state, steps, statics, li, *args, **kwargs)

    with fake_card(monkeypatch) as lib:
        monkeypatch.setattr(cuda_ffd, "_launch_batched", spy)
        out = cons._prefix_scan(
            prep.init_state, classes, prep.statics, kind, count,
            torch.as_tensor(cons._it_price_vector(prep)),
            len(sched.existing_nodes), "cuda")
        assert [(c["B"], c["J"]) for c in lib.calls] == [
            (P, int(classes.count.shape[0]))]
        assert cuda_ffd.counter.launches == dict.fromkeys(cuda_ffd.KERNELS,
                                                          1)
        assert cuda_ffd.counter.prefix_launches == 1
        assert cuda_ffd.counter.rows == P
        # the kernel got a fresh stack, not the prepared state: the packed
        # state's own buffer (no copy of it), one row of the class steps
        # and of the statics shared by every prefix (problem stride 0)
        (state, steps, statics), call = stacks[0], lib.calls[0]
        assert call["valmask"] == state.valmask.data_ptr()
        assert state.valmask.dtype == torch.uint8
        assert call["valmask"] != prep.init_state.valmask.data_ptr()
        assert call["kind"] != prep.init_state.kind.data_ptr()
        assert call["step_stride"] == 0 and call["static_stride"] == 0
        assert call["c_mask"] == steps.mask.data_ptr()
        assert steps.mask.stride(0) == 0
    assert [x.shape for x in out] == [(P,)] * 4


@pytest.mark.parametrize("leaf", ["valmask", "kind", "requests"])
def test_card_path_refuses_a_shared_state_leaf(monkeypatch, leaf):
    """The kernel writes the slot state in place, so a state leaf must be a
    real row a problem: a stride-0 expand is refused before any launch
    (``_check``), where the class steps and statics may be one."""
    _inputs, _r, port, _ref = sweep_problems()
    sched, prep, classes, kind, count = port
    st, steps, statics = cons.prefix_stack(
        cuda_ffd.pack_state(prep.init_state), classes, prep.statics, kind,
        count)
    x = getattr(st, leaf)
    shared = x[:1].expand_as(x)
    with pytest.raises(ValueError, match=f"{leaf}: not contiguous"):
        cuda_ffd._check(leaf, shared, x.dtype, x.shape, x.device)
    assert cuda_ffd._check(leaf, shared, x.dtype, x.shape, x.device,
                           shared=True) == x.data_ptr()
    with fake_card(monkeypatch) as lib:
        with pytest.raises(ValueError, match=leaf):
            cuda_ffd._launch_batched(st._replace(**{leaf: shared}), steps,
                                     statics, tffd.LEVEL_ITERS)
        assert lib.calls == []
        assert cuda_ffd.counter.total() == 0


@pytest.mark.parametrize("shared_steps,shared_statics", [
    (True, True), (True, False), (False, True), (False, False)])
def test_card_path_strides_follow_the_read_only_trees(
        monkeypatch, shared_steps, shared_statics):
    """Each read-only tree reaches the kernel with problem stride 0 when it
    is one row expanded over the prefixes, 1 when it is a real stack; a
    tree that mixes the two is refused."""
    _inputs, _r, port, _ref = sweep_problems()
    sched, prep, classes, kind, count = port
    P = kind.shape[0]
    st, steps, statics = cons.prefix_stack(
        cuda_ffd.pack_state(prep.init_state), classes, prep.statics, kind,
        count)
    if not shared_steps:
        steps = cons._repeat(classes, P)._replace(count=steps.count)
    if not shared_statics:
        statics = cons._repeat(prep.statics, P)
    with fake_card(monkeypatch) as lib:
        cuda_ffd._launch_batched(st, steps, statics, tffd.LEVEL_ITERS)
        (call,) = lib.calls
        assert call["step_stride"] == (0 if shared_steps else 1)
        assert call["static_stride"] == (0 if shared_statics else 1)
        mixed = statics._replace(it_alloc=statics.it_alloc.contiguous()
                                 if shared_statics else
                                 statics.it_alloc[:1].expand_as(
                                     statics.it_alloc))
        with pytest.raises(ValueError, match="statics"):
            cuda_ffd._launch_batched(st, steps, mixed, tffd.LEVEL_ITERS)
        assert len(lib.calls) == 1


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
    """No sidecar answers: the sweep returns None with one fallback
    counted, as the reference's does, and multi-node consolidation takes
    the host binary search instead. Over chip_smoke's consolidation
    scenario (every node a candidate) the fleet ends as the in-process
    sweep's run ends, every pod bound, no reconcile error."""
    import socket

    from karpenter_core_tpu_torch.metrics import wiring as m
    from karpenter_core_tpu_torch.solver import remote

    ns = chip_smoke.port_classes()
    options = Options(solver="tpu", device_scheduler_opts={
        "device": "cpu", "kernel_backend": "reference"})
    inproc, run = chip_smoke.consolidation_scenario(ns, options, n=6)
    run()
    op, run = chip_smoke.consolidation_scenario(ns, options, n=6)
    cands = candidates_of(op, get_candidates)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    op.provisioner.solver_client = remote.SolverClient(
        dead, timeout=5, max_retries=0, sleep=lambda s: None)
    fallbacks = m.SOLVER_RPC_FALLBACKS.value({"endpoint": "consolidate"})
    assert cons.schedulability_frontier(op.provisioner, op.cluster,
                                        cands) is None
    assert m.SOLVER_RPC_FALLBACKS.value(
        {"endpoint": "consolidate"}) == fallbacks + 1
    errors0 = sum(m.RECONCILE_ERRORS.values.values())
    run()
    assert sum(m.RECONCILE_ERRORS.values.values()) == errors0
    assert m.SOLVER_RPC_FALLBACKS.value(
        {"endpoint": "consolidate"}) > fallbacks + 1
    assert chip_smoke.operator_outcome(op) == chip_smoke.operator_outcome(
        inproc)
    assert chip_smoke.operator_outcome(op)[2]  # every pod bound
    assert len(op.kube.list_nodes()) < 6
