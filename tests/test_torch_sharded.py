"""The port's multi-device solves against the JAX package's sharded ones.

The port's ``parallel/mesh.force_virtual_mesh(n, "cpu")`` makes n CPU
devices, the counterpart of the 8-device virtual CPU mesh the JAX package
runs on here (``tests/conftest.py``). On it:

* ``DeviceScheduler(devices=N)`` (the problems of
  ``tests/test_sharded_production.py``: plain, a slot axis padded from 100
  to 104, a 3-device mesh, topology, existing nodes) gives the JAX
  package's ``devices=N`` answer byte for byte: the result wire with
  ``solve_seconds`` pinned to 0.0, ``n_devices``, ``slots`` and ``rounds``.
  The JAX side runs its slot-sharded XLA route; the port runs the solo
  scan on the mesh's lead device, with the slot width padded as JAX pads.
* The consolidation sweep's frontier at ``devices=8`` and ``devices=3``
  (P padded to a multiple of the mesh) equals the JAX package's sharded
  frontier, one scan a prefix shard.
* ``solve_batch`` at ``devices=2`` for plain, gang (with its rollback and
  preemption pass) and relax tenants equals the JAX package's at
  ``devices=2``, wire and stats, with the batched scans split into one
  scan a problem shard.
* ``--solver-devices`` reaches the scheduler and the spawned child's argv;
  a devices=N solverd builds devices=N schedulers.
* A two-member spawned solverd fleet (CPU children) serves two operators,
  and ``FleetSupervisor(3)`` aggregates its members' respawn storms (the
  reference's own cases, read onto the port).

The exactness is bit for bit: the solve is integer-exact float32
(``ops/ffd.py:220-226``). The card runs the same routes in
``chip_smoke.py`` phase 14.
"""
from __future__ import annotations

import contextlib
import copy

import pytest
import torch

import chip_smoke
from fleet_expected import to_reference as inputs_to_reference
from tests.helpers import GIB, make_nodepool, make_pod
from tests.test_batch import _catalog as batch_catalog
from tests.test_batch import _problem as batch_problem
from tests.test_gangsched import preemption_problem
from tests.test_relaxsolve import two_pool_world
from tests.test_sharded_production import _catalog, _plain_pods, _topo_pods
from tests.test_torch_consolidation import assert_frontiers_equal, fake_card
from tests.test_torch_gangsched import rollback_problem
from tests.test_torch_provisioner import _align_hostnames, to_reference
from tests.test_torch_relax import _pods as relax_pods
from tests.torch_ported import ported
from tests.torch_threads import one_torch_thread  # noqa: F401

from karpenter_core_tpu.api import labels as L
from karpenter_core_tpu.controllers.provisioning.scheduling.inflight import (
    SimNode,
)
from karpenter_core_tpu.models import consolidation as ref_cons
from karpenter_core_tpu.models import provisioner as jprov
from karpenter_core_tpu.solver import codec
from karpenter_core_tpu_torch import interop
from karpenter_core_tpu_torch.metrics import wiring as port_metrics
from karpenter_core_tpu_torch.models import consolidation as cons
from karpenter_core_tpu_torch.models import provisioner as tprov
from karpenter_core_tpu_torch.ops import cuda_ffd
from karpenter_core_tpu_torch.parallel import mesh as pmesh

N_DEVICES = 8


@contextlib.contextmanager
def virtual_mesh(n, kind="cpu"):
    pmesh.force_virtual_mesh(n, kind)
    try:
        yield
    finally:
        pmesh.force_virtual_mesh(0, kind)


@pytest.fixture
def cpu_mesh():
    with virtual_mesh(N_DEVICES):
        yield


def _wire(results):
    return codec.encode_solve_results(results, 0.0)


# ---------------------------------------------------------------------------
# parallel/mesh.py


@pytest.mark.parametrize("kind,physical,n,want", [
    ("cpu", 1, 8, ["cpu"] * 8),
    ("cpu", 1, 3, ["cpu"] * 3),
    ("cuda", 1, 4, ["cuda:0"] * 4),
    ("cuda", 2, 4, ["cuda:0", "cuda:1", "cuda:0", "cuda:1"]),
    ("cuda", 4, 3, ["cuda:0", "cuda:1", "cuda:2"]),
])
def test_virtual_mesh_lays_shards_over_the_physical_devices(
        kind, physical, n, want, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: physical)
    with virtual_mesh(n, kind):
        mesh = pmesh.slot_mesh(n, kind)
        assert [str(d) for d in mesh.devices] == want
        assert mesh.lead == mesh.devices[0] and mesh.size == n
        assert pmesh.resolve_devices(0, kind) == n
        assert pmesh.resolve_devices(2 * n, kind) == n
        with pytest.raises(RuntimeError, match=f"need {n + 1}"):
            pmesh.slot_mesh(n + 1, kind)
    assert pmesh.resolve_devices(0, kind) == (physical if kind == "cuda"
                                              else 1)


@pytest.mark.parametrize("kind,physical", [("cpu", 1), ("cuda", 1),
                                           ("cuda", 0)])
def test_a_mesh_larger_than_the_devices_raises(kind, physical, monkeypatch):
    """No fallback to fewer devices or to the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: physical)
    with pytest.raises(RuntimeError, match="need 2"):
        pmesh.slot_mesh(2, kind)
    if kind == "cuda":
        with virtual_mesh(2, "cuda"):
            if physical == 0:  # a virtual mesh needs a card to lay it on
                with pytest.raises(RuntimeError, match="0 physical"):
                    pmesh.slot_mesh(2, "cuda")
            else:
                assert pmesh.slot_mesh(2, "cuda").size == 2


@pytest.mark.parametrize("n_rows,n,want", [
    (8, 2, [(0, 4), (4, 8)]),
    (4, 4, [(0, 1), (1, 2), (2, 3), (3, 4)]),
    (4, 3, [(0, 2), (2, 3), (3, 4)]),
    (102, 3, [(0, 34), (34, 68), (68, 102)]),
    (2, 4, [(0, 1), (1, 2)]),
    (1, 8, [(0, 1)]),
])
def test_row_shards_are_contiguous_and_cover_the_axis(n_rows, n, want):
    with virtual_mesh(n):
        mesh = pmesh.slot_mesh(n, "cpu")
        shards = pmesh.row_shards(n_rows, mesh)
    assert [(lo, hi) for lo, hi, _ in shards] == want
    assert all(dev == mesh.devices[k] for k, (_, _, dev) in
               enumerate(shards))


def test_split_and_gather_rows_round_trip():
    from karpenter_core_tpu_torch.ops.ffd import SlotState

    g = torch.Generator().manual_seed(0)
    tree = (torch.randint(0, 9, (5, 3, 2), generator=g),
            SlotState(*(torch.rand((5, 4), generator=g) if f != "zcount"
                        else None for f in SlotState._fields)))
    with virtual_mesh(3):
        mesh = pmesh.slot_mesh(3, "cpu")
        parts = [pmesh.split_rows(tree, lo, hi, dev)
                 for lo, hi, dev in pmesh.row_shards(5, mesh)]
        assert [p[0].shape[0] for p in parts] == [2, 2, 1]
        back = pmesh.gather_rows(mesh, parts)
    assert torch.equal(back[0], tree[0])
    for a, b in zip(back[1], tree[1]):
        assert (a is None and b is None) or torch.equal(a, b)
    assert back[1].zcount is None


@pytest.mark.parametrize("n,n_devices", [(100, 3), (102, 3), (5, 8),
                                         (7, 1)])
def test_pad_rows_repeats_the_last_row(n, n_devices):
    import numpy as np

    a = np.arange(n * 2).reshape(n, 2)
    out = pmesh.pad_rows(a, n_devices)
    assert out.shape[0] == pmesh.pad_to_devices(n, n_devices)
    assert (out[:n] == a).all() and (out[n:] == a[-1]).all()


# ---------------------------------------------------------------------------
# DeviceScheduler(devices=N) against the JAX package's sharded solve


def _existing():
    return [
        SimNode(
            name=f"exist-{i}",
            labels={
                L.LABEL_ARCH: "amd64",
                L.LABEL_OS: "linux",
                L.LABEL_TOPOLOGY_ZONE: "zone-a",
                L.NODEPOOL_LABEL_KEY: "default",
                L.LABEL_INSTANCE_TYPE: _catalog()[5].name,
            },
            taints=[],
            available={"cpu": 7.0, "memory": 14 * GIB, "pods": 200.0},
            capacity={"cpu": 8.0, "memory": 16 * GIB, "pods": 210.0},
        )
        for i in range(6)
    ]


# tests/test_sharded_production.py TestShardedProductionSolve's problems:
# (pods, max_slots, devices, existing nodes)
PRODUCTION = {
    "plain": (lambda: _plain_pods(120), 64, N_DEVICES, None),
    "padded_slot_axis": (lambda: _plain_pods(120), 100, N_DEVICES, None),
    "three_devices": (lambda: _plain_pods(120), 64, 3, None),
    "topology": (lambda: _topo_pods(96), 64, N_DEVICES, None),
    "existing_nodes": (lambda: _plain_pods(60), 64, N_DEVICES, _existing),
}

_STATS = ("n_devices", "slots", "rounds", "used_slots")


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("case", list(PRODUCTION))
def test_device_scheduler_matches_the_jax_sharded_solve(case, backend,
                                                        cpu_mesh):
    make_pods, max_slots, devices, existing = PRODUCTION[case]
    pods = make_pods()
    nodes = existing() if existing else None
    pool, its = make_nodepool(), {"default": _catalog()}
    _align_hostnames()
    ref = jprov.DeviceScheduler([pool], its, existing_nodes=copy.deepcopy(
        nodes), max_slots=max_slots, devices=devices)
    r_ref = ref.solve(copy.deepcopy(pods))
    pools_t, its_t, nodes_t, pods_t = interop.from_reference(
        ([pool], its, nodes or [], pods))
    rejected0 = dict(port_metrics.SOLVER_RESULT_REJECTED.values)
    _align_hostnames()
    port = tprov.DeviceScheduler(pools_t, its_t, existing_nodes=nodes_t,
                                 max_slots=max_slots, devices=devices,
                                 device="cpu", kernel_backend=backend)
    r_port = port.solve(pods_t)
    assert r_ref.all_pods_scheduled()
    assert _wire(to_reference(r_port)) == _wire(r_ref)
    assert port.devices == ref.devices == devices
    for k in _STATS:
        assert port.last_phase_stats[k] == ref.last_phase_stats[k], k
    assert dict(port_metrics.SOLVER_RESULT_REJECTED.values) == rejected0


def test_padded_slot_width_follows_jax(cpu_mesh, monkeypatch):
    """The prepared slot axis is ``pad_to_devices(max_slots, devices)``:
    100 slots become 104 on 8 devices, as in the JAX package."""
    widths = []
    prepare = tprov.DeviceScheduler._prepare_with_vocab

    def spy(self, plan, max_slots, topo):
        prep = prepare(self, plan, max_slots, topo)
        widths.append(int(prep.init_state.kind.shape[0]))
        return prep

    monkeypatch.setattr(tprov.DeviceScheduler, "_prepare_with_vocab", spy)
    pools_t, its_t, pods_t = interop.from_reference(
        ([make_nodepool()], {"default": _catalog()}, _plain_pods(40)))
    for devices, want in ((N_DEVICES, 104), (3, 102), (1, 100)):
        tprov.DeviceScheduler(pools_t, its_t, max_slots=100,
                              devices=devices, device="cpu").solve(pods_t)
        assert widths[-1] == want


def test_the_solo_route_runs_on_the_lead_device(cpu_mesh, monkeypatch):
    """On a mesh a solo solve is one scan of the whole problem: no shard."""
    shards = []
    monkeypatch.setattr(tprov, "_shards", lambda *a: shards.append(a))
    pools_t, its_t, pods_t = interop.from_reference(
        ([make_nodepool()], {"default": _catalog()}, _plain_pods(40)))
    sched = tprov.DeviceScheduler(pools_t, its_t, max_slots=64,
                                  devices=N_DEVICES, device="cpu")
    assert sched.devices == N_DEVICES
    assert sched.device == pmesh.slot_mesh(N_DEVICES, "cpu").lead
    assert sched.solve(pods_t).all_pods_scheduled()
    assert shards == []


# ---------------------------------------------------------------------------
# the consolidation sweep


def _frontier_problem():
    """tests/test_sharded_production.py's frontier problem: 12 nodes, 5
    candidates with two pods each (P = 5 pads to 8 on 8 devices, to 6 on
    3)."""
    catalog = _catalog()
    nodes = [
        SimNode(
            name=f"n{i}",
            labels={
                L.LABEL_ARCH: "amd64",
                L.LABEL_OS: "linux",
                L.LABEL_TOPOLOGY_ZONE: "zone-a",
                L.NODEPOOL_LABEL_KEY: "default",
                L.LABEL_INSTANCE_TYPE: catalog[5].name,
            },
            taints=[],
            available={"cpu": 7.0, "memory": 14 * GIB, "pods": 200.0},
            capacity={"cpu": 8.0, "memory": 16 * GIB, "pods": 210.0},
        )
        for i in range(12)
    ]
    return dict(
        nodepools=[make_nodepool()], instance_types={"default": catalog},
        cand_nodes=nodes[:5], keep_nodes=nodes[5:], daemonset_pods=[],
        base_pods=[],
        candidate_pods=[[make_pod(cpu=0.25, name=f"c{i}-{j}")
                         for j in range(2)] for i in range(5)],
    )


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("devices", [N_DEVICES, 3])
@pytest.mark.parametrize("problem", ["production", "config4"])
def test_frontier_matches_the_jax_sharded_sweep(problem, devices, backend,
                                                cpu_mesh):
    if problem == "production":
        ref_inputs = _frontier_problem()
        inputs = interop.from_reference(ref_inputs)
    else:  # config 4's recipe at test size, the last prefixes fresh nodes
        inputs = chip_smoke.sweep_inputs(n_nodes=8, n_cand=6, n_types=16)
        ref_inputs = inputs_to_reference(inputs)
    ref = ref_cons.frontier_core(**ref_inputs, max_slots=64,
                                 devices=devices)
    port = cons.frontier_core(**inputs, max_slots=64, devices=devices,
                              device="cpu", kernel_backend=backend)
    one = cons.frontier_core(**inputs, max_slots=64, devices=1,
                             device="cpu", kernel_backend=backend)
    assert_frontiers_equal(port, ref)
    assert port == one


@pytest.mark.parametrize("devices,P,rows", [(3, 6, [2, 2, 2]),
                                            (4, 6, [2, 2, 2, 2]),
                                            (8, 6, [1] * 8)])
def test_the_sweep_launches_once_a_prefix_shard(devices, P, rows,
                                                monkeypatch):
    """On the card path (the kernel library faked) a sweep over a mesh is
    one launch a shard, each on its own rows, P padded with the last
    prefix."""
    inputs = chip_smoke.sweep_inputs(n_nodes=8, n_cand=P, n_types=16)
    with virtual_mesh(devices), fake_card(monkeypatch) as lib:
        cons.frontier_core(**inputs, max_slots=64, devices=devices,
                           device="cpu")
        assert [c["B"] for c in lib.calls] == rows
        assert cuda_ffd.counter.total() == len(rows)
        assert cuda_ffd.counter.rows == sum(rows)


# ---------------------------------------------------------------------------
# solve_batch at devices=2


def _members(case):
    """[(pools, catalog, existing, pods)] of each case's tenants."""
    if case == "plain":
        out = []
        for name, n, step in (("pa", 20, 0.25), ("pb", 24, 0.3),
                              ("pc", 20, 0.2)):
            pool, pods = batch_problem(name, n, step)
            out.append(([pool], batch_catalog(), [], pods))
        return out, {}
    if case == "gang":
        return [rollback_problem("a"), rollback_problem("b")], {}
    if case == "preempt":
        return [preemption_problem(), preemption_problem()], {}
    pools, its = two_pool_world()
    pods = relax_pods(32)
    return ([(pools, None, [], pods), (pools, None, [], pods)],
            dict(solver_mode="relax", its=its))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("case", ["plain", "gang", "preempt", "relax"])
def test_solve_batch_matches_the_jax_package_on_two_devices(
        case, backend, cpu_mesh, monkeypatch):
    members, kw = _members(case)
    kw = dict(kw)
    its0 = kw.pop("its", None)
    max_slots = 256 if case == "relax" else 64
    shards = []
    split = tprov._shards
    monkeypatch.setattr(tprov, "_shards", lambda mesh, n, trees: (
        shards.append(n) or split(mesh, n, trees)))
    j_entries, p_entries = [], []
    for pools, catalog, existing, pods in members:
        its = its0 or {p.name: list(catalog) for p in pools}
        j_entries.append((jprov.DeviceScheduler(
            copy.deepcopy(pools), its, existing_nodes=copy.deepcopy(existing),
            max_slots=max_slots, devices=2, **kw), copy.deepcopy(pods)))
        pools_t, its_t, existing_t, pods_t = interop.from_reference(
            (pools, its, existing, pods))
        p_entries.append((tprov.DeviceScheduler(
            pools_t, its_t, existing_nodes=existing_t, max_slots=max_slots,
            devices=2, device="cpu", kernel_backend=backend, **kw), pods_t))
    _align_hostnames()
    j_out, j_stats = jprov.solve_batch(j_entries)
    _align_hostnames()
    p_out, p_stats = tprov.solve_batch(p_entries)
    assert [s for s, _ in p_out] == [s for s, _ in j_out] == (
        ["ok"] * len(members))
    for (_, jr), (_, pr) in zip(j_out, p_out):
        assert _wire(to_reference(pr)) == _wire(jr)
    assert p_stats == j_stats
    assert p_stats["batched_problems"] >= 2
    for (js, _), (ps, _) in zip(j_entries, p_entries):
        for k in _STATS:
            assert ps.last_phase_stats[k] == js.last_phase_stats[k], k
        assert ps.last_phase_stats.get("relax") == js.last_phase_stats.get(
            "relax")
    # every batched scan dispatch split its padded problem axis
    assert shards and all(n >= 2 for n in shards)


def test_batched_scans_launch_once_a_problem_shard(monkeypatch):
    """On the card path (the kernel library faked) a batched dispatch of
    three problems (padded to four rows) over a 2- and a 4-device mesh is
    one launch a shard."""
    reqs = []
    for name in ("sa", "sb", "sc"):
        pool, pods = batch_problem(name, 20)
        pools_t, its_t, pods_t = interop.from_reference(
            ([pool], {name: list(batch_catalog())}, pods))
        gen = tprov.DeviceScheduler(pools_t, its_t, max_slots=64,
                                    device="cpu")._solve_gen(pods_t)
        reqs.append(gen.send(None))
        gen.close()
    import dataclasses

    for devices, rows in ((2, [2, 2]), (4, [1, 1, 1, 1])):
        with virtual_mesh(devices), fake_card(monkeypatch) as lib:
            # the provisioner passes level_iters by keyword
            monkeypatch.setattr(
                cuda_ffd, "cuda_ffd_solve_batched",
                lambda s, c, st, level_iters: cuda_ffd._launch_batched(
                    s, c, st, level_iters))
            outs, padded = tprov._run_kernel_batched(
                [dataclasses.replace(r, devices=devices) for r in reqs])
            assert padded == 4 and len(outs) == 3
            assert [c["B"] for c in lib.calls] == rows
            assert cuda_ffd.counter.total() == len(rows)


def test_sharded_gang_route_launches_every_first_scan_before_a_host_read(
        monkeypatch):
    """``gang_solve_sharded_with``: both shards' first scans go out before
    the first failure check is read, and each shard equals the batched
    solve of its rows."""
    from karpenter_core_tpu_torch.ops import gangsched as tgs

    reqs = []
    for tag in ("a", "b"):
        pools, catalog, existing, pods = interop.from_reference(
            rollback_problem(tag))
        gen = tprov.DeviceScheduler(
            pools, {p.name: list(catalog) for p in pools},
            existing_nodes=existing, max_slots=64,
            device="cpu")._solve_gen(pods)
        reqs.append(gen.send(None))
        gen.close()
    shards = [(r.init_state, r.steps, r.statics, r.gang_of_step, r.gang_min)
              for r in reqs]
    shards = [tuple(type(t)(*(None if x is None else x[None] for x in t))
                    if hasattr(t, "_fields") else t[None] for t in s)
              for s in shards]
    events = []
    scan = tgs.ffd_solve_batched

    def spy_scan(*a):
        events.append("scan")
        return scan(*a)

    failed = tgs._step_failed

    def spy_failed(*a):
        events.append("check")
        return failed(*a)

    monkeypatch.setattr(tgs, "_step_failed", spy_failed)
    outs = tgs.gang_solve_sharded_with(spy_scan, shards,
                                       reqs[0].level_iters)
    assert events[:3] == ["scan", "scan", "check"]
    for out, shard in zip(outs, shards):
        want = tgs.gang_solve_batched(*shard, level_iters=reqs[0].level_iters)
        for a, b in zip(out[1:], want[1:]):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# --solver-devices plumbing (tests/test_sharded_production.py
# TestDeviceCountPlumbing)


def test_operator_threads_devices_into_the_scheduler(cpu_mesh):
    from karpenter_core_tpu_torch.operator import Operator, Options

    opts = Options.parse(["--solver", "tpu", "--solver-devices", "2",
                          "--kernel", "reference"])
    assert opts.solver_devices == 2
    opts.device_scheduler_opts = {"device": "cpu"}
    op = Operator(options=opts)
    assert op.provisioner.device_scheduler_opts.get("devices") == 2
    sched = op.provisioner.new_scheduler([])
    assert sched.devices == 2
    # an explicit device_scheduler_opts entry wins over the flag
    op2 = Operator(options=Options(
        solver="tpu", solver_devices=2,
        device_scheduler_opts={"device": "cpu", "devices": 3}))
    assert op2.provisioner.new_scheduler([]).devices == 3
    assert Options.parse(["--solver-devices", "8"]).solver_devices == 8
    with pytest.raises(ValueError, match="solver-devices"):
        Options.parse(["--solver-devices", "-1"])


def test_spawned_child_argv_carries_the_device_count():
    from karpenter_core_tpu_torch.solver.supervisor import default_command

    cmd = default_command(0, devices=8, device="cpu")
    assert cmd[cmd.index("--devices") + 1] == "8"
    assert "--devices" not in default_command(0)


def test_daemon_constructs_sharded_schedulers(cpu_mesh):
    """A devices=N daemon builds devices=N DeviceSchedulers on the CPU
    mesh, and its answer is the JAX daemon's on the same request bytes."""
    from karpenter_core_tpu.solver import service as jservice
    from karpenter_core_tpu_torch.solver import service

    body = codec.encode_solve_request(
        [make_nodepool()], {"default": _catalog()}, [], [], _plain_pods(24),
        max_slots=64,
    )
    daemon = service.SolverDaemon(devices=N_DEVICES, device="cpu",
                                  kernel="reference")
    _align_hostnames()
    out, _dt = daemon.solve(body)
    _align_hostnames()
    ref, _ = jservice.SolverDaemon(devices=N_DEVICES).solve(body)
    decoded = codec.decode_solve_results(out)
    assert not decoded["errors"]
    cached = next(iter(daemon._sched_cache._entries.values()))[0]
    assert cached.devices == N_DEVICES
    assert cached.last_phase_stats["n_devices"] == N_DEVICES

    def view(wire):
        d = codec.decode_solve_results(wire)
        d.pop("solve_seconds", None)
        return d

    assert view(out) == view(ref)


# ---------------------------------------------------------------------------
# the spawned fleet (tests/test_segments.py, tests/test_solverd.py)

_segments = ported("test_segments")
_solverd = ported("test_solverd")
_storm = _solverd.TestRespawnStorm


class TestRespawnStorm:
    """FleetSupervisor(3) and the single-member storm alarm, on the port
    (tests/test_solverd.py TestRespawnStorm's fleet cases)."""

    _sup = _storm._sup
    test_storm_trips_past_threshold_and_decays = (
        _storm.test_storm_trips_past_threshold_and_decays)
    test_fleet_aggregates_any_member_storm = (
        _storm.test_fleet_aggregates_any_member_storm)

CPU_CHILD = dict(solver_kernel="reference",
                 device_scheduler_opts={"device": "cpu"})


def test_two_operators_share_one_two_member_spawned_fleet(monkeypatch):
    """tests/test_segments.py's two-member fleet on the port: operator A
    spawns ``solver_fleet=2`` (two CPU children); operator B routes its
    own tenant through the same two members by address. Each tenant gets
    its in-process answer, with no failed RPC."""
    from karpenter_core_tpu_torch.cloudprovider.kwok import build_catalog
    from karpenter_core_tpu_torch.solver.remote import FleetRouter
    from karpenter_core_tpu_torch.solver.supervisor import FleetSupervisor

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cat_a = build_catalog(cpu_grid=[1, 2, 4, 8], mem_factors=[2, 4])
    cat_b = build_catalog(cpu_grid=[2, 4, 16], mem_factors=[4])
    battery, operator = _segments._battery, _segments._operator
    inproc_a = battery(operator(dict(solver_mode="inproc", **CPU_CHILD),
                                cat_a), "a")
    inproc_b = battery(operator(dict(solver_mode="inproc", **CPU_CHILD),
                                cat_b), "b")
    assert inproc_a["unbound"] == [] and inproc_b["unbound"] == []
    failures0 = dict(port_metrics.SOLVER_RPC_FAILURES.values)
    # --solver-devices rides every member's argv (a CPU child resolves it
    # to its one device)
    op_a = operator(dict(solver_mode="sidecar", solver_fleet=2,
                         solver_devices=2, solver_tenant="tenant-a",
                         **CPU_CHILD), cat_a)
    try:
        assert isinstance(op_a.solver_supervisor, FleetSupervisor)
        assert isinstance(op_a.solver_client, FleetRouter)
        addrs = op_a.solver_supervisor.addrs
        assert len(addrs) == 2 and addrs[0] != addrs[1]
        for m in op_a.solver_supervisor.members:
            cmd = m.command
            assert cmd[cmd.index("--device") + 1] == "cpu"
            assert cmd[cmd.index("--kernel") + 1] == "reference"
            assert cmd[cmd.index("--devices") + 1] == "2"
        op_b = operator(dict(solver_mode="sidecar",
                             solver_addr=",".join(addrs),
                             solver_tenant="tenant-b", **CPU_CHILD), cat_b)
        assert op_b.solver_supervisor is None  # borrowed, not owned
        assert isinstance(op_b.solver_client, FleetRouter)
        assert battery(op_a, "a") == inproc_a
        assert battery(op_b, "b") == inproc_b
        assert dict(port_metrics.SOLVER_RPC_FAILURES.values) == failures0
        assert op_a.solver_client.snapshot()["routed"].get(
            "affinity", 0) > 0
        assert op_a.solver_client.health()["ready_members"] == 2
        assert op_a.readyz()
    finally:
        op_a.shutdown()
    assert op_a.solver_supervisor.alive_count() == 0


def test_autoscaled_fleet_grows_and_drains_a_member(monkeypatch):
    """``solver_autoscale``: the operator spawns a fleet-shaped tier (one
    CPU child to start) behind a ``TierAutoscaler``; the scale-up actuator
    (``FleetSupervisor.add_member``) spawns a second member that answers
    the in-process solve, and the scale-down path
    (``FleetSupervisor.retire_member``) drains it with the drain exit
    code."""
    from karpenter_core_tpu_torch.cloudprovider.kwok import build_catalog
    from karpenter_core_tpu_torch.solver import remote
    from karpenter_core_tpu_torch.solver.autoscale import TierAutoscaler
    from karpenter_core_tpu_torch.solver.supervisor import DRAIN_EXIT_CODE

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cat = build_catalog(cpu_grid=[1, 2, 4, 8], mem_factors=[2, 4])
    op = _segments._operator(dict(solver_mode="sidecar",
                                  solver_autoscale=True,
                                  solver_fleet_max=2, **CPU_CHILD), cat)
    try:
        sup = op.solver_supervisor
        assert isinstance(op.solver_autoscaler, TierAutoscaler)
        assert len(sup.members) == 1
        i = sup.add_member()
        assert len(sup.members) == 2 and sup.members[i].alive()
        pools_t, its_t, pods_t = interop.from_reference(
            ([make_nodepool()], {"default": _catalog()}, _plain_pods(24)))
        _align_hostnames()
        local = tprov.DeviceScheduler(pools_t, its_t, max_slots=64,
                                      device="cpu").solve(pods_t)
        _align_hostnames()
        res = remote.RemoteScheduler(
            remote.SolverClient(sup.members[i].addr, timeout=60),
            pools_t, its_t,
            device_scheduler_opts=dict(max_slots=64)).solve(pods_t)
        assert _wire(to_reference(res)) == _wire(to_reference(local))
        proc = sup.members[i].proc
        assert sup.retire_member(i) is True
        assert proc.returncode == DRAIN_EXIT_CODE
        assert len(sup.members) == 1
    finally:
        op.shutdown()
    assert sup.alive_count() == 0
