"""The port's Operator against the JAX package's, scenario for scenario.

Each scenario runs on the JAX package's Operator (solver "tpu", on the CPU)
and on the port's, with ``device_scheduler_opts={"device": "cpu", ...}``;
the scenario objects are carried across with ``interop.from_reference``
(or built by chip_smoke.py's recipes and carried the other way). Claim
names, hostname placeholders and object uids come from module-level
counters, which both packages restart at the same value before each run.
The port must bind the same pods to the same node names and end with the
same node count and cpu, with no swallowed reconcile error.
"""
from types import SimpleNamespace

import pytest
import torch

import chip_smoke
from fleet_expected import to_reference
from tests.helpers import make_nodepool, make_pod
from tests.test_batched_consolidation import underutilized_fleet as ref_fleet
from tests.test_e2e import new_operator as ref_new_operator
from tests.test_torch_consolidation import align_counters, port_fleet
from tests.torch_threads import one_torch_thread  # noqa: F401

from karpenter_core_tpu.api.objects import Pod as RefPod
from karpenter_core_tpu.cloudprovider.kwok import (
    KwokCloudProvider as RefKwok,
    build_catalog,
)
from karpenter_core_tpu.kube.store import KubeStore as RefKubeStore
from karpenter_core_tpu.operator import Operator as RefOperator
from karpenter_core_tpu.operator import Options as RefOptions
from karpenter_core_tpu.utils.clock import FakeClock as RefFakeClock
from karpenter_core_tpu_torch import interop
from karpenter_core_tpu_torch.metrics import wiring as m
from karpenter_core_tpu_torch.operator import Operator, Options
from karpenter_core_tpu_torch.ops import cuda_ffd

CATALOG = build_catalog(cpu_grid=[1, 2, 4, 8, 16], mem_factors=[2, 4])
REF = SimpleNamespace(Operator=RefOperator, KubeStore=RefKubeStore,
                      KwokCloudProvider=RefKwok, FakeClock=RefFakeClock,
                      Pod=RefPod, convert=to_reference)


def cpu_options(kernel="reference", **kw):
    return Options(solver="tpu", device_scheduler_opts={
        "device": "cpu", "kernel_backend": kernel}, **kw)


def bindings(op):
    return sorted((p.name, p.node_name) for p in op.kube.list_pods())


def node_names(op):
    return sorted(n.name for n in op.kube.list_nodes())


def checked_run(op, run, expect_sweep=0):
    """Drive ``run`` on a port operator and hold it to chip_smoke.py's
    checks, less the launch accounting (the CPU runs the plain scan)."""
    errors0 = dict(m.RECONCILE_ERRORS.values)
    rejected0 = dict(m.SOLVER_RESULT_REJECTED.values)
    with chip_smoke.operator_spy() as log:
        run()
    chip_smoke.check_operator_run(op, log, "port", errors0, rejected0,
                                  expect_sweep, launched=False)
    return log


@pytest.mark.parametrize("kernel", ["cuda", "reference"])
def test_provisioning_matches_reference(kernel):
    """tests/test_e2e.py's TestProvisioningE2E: 20 pending pods."""
    pods = [make_pod(cpu=1.0, name=f"p{i}") for i in range(20)]
    align_counters()
    ref = ref_new_operator("tpu", CATALOG)
    ref.kube.create(make_nodepool())
    for p in pods:
        ref.kube.create(to_reference(interop.from_reference(p)))
    ref.run_until_idle()

    align_counters()
    ns = chip_smoke.port_classes()
    op = chip_smoke._new_operator(ns, interop.from_reference(CATALOG),
                                  cpu_options(kernel))
    op.kube.create(interop.from_reference(make_nodepool()))
    for p in pods:
        op.kube.create(interop.from_reference(p))
    log = checked_run(op, op.run_until_idle)
    assert log["solves"] and sum(s["scans"] for s in log["solves"]) >= 1
    assert all(node for _name, node in bindings(op))
    assert bindings(op) == bindings(ref)
    assert node_names(op) == node_names(ref)
    assert (chip_smoke.operator_outcome(op)
            == chip_smoke.operator_outcome(ref))


def test_consolidation_matches_reference():
    """tests/test_batched_consolidation.py's TestEndToEndBatched fleet."""
    align_counters()
    ref = ref_fleet(6)
    ref.run_until_idle(max_iters=200)
    align_counters()
    op = port_fleet(6)
    checked_run(op, lambda: op.run_until_idle(max_iters=200))
    assert bindings(op) == bindings(ref)
    assert node_names(op) == node_names(ref)
    outcome = chip_smoke.operator_outcome(op)
    assert outcome == chip_smoke.operator_outcome(ref)
    assert outcome[2]


@pytest.mark.parametrize("kernel", ["cuda", "reference"])
def test_multi_node_sweep_matches_reference(kernel):
    """chip_smoke.py's phase-8 consolidation scenario at 8 nodes: one pod
    on each, so multi-node consolidation sweeps all 8 prefixes, with a
    frontier on every pass."""
    align_counters()
    ref, ref_run = chip_smoke.consolidation_scenario(
        REF, RefOptions(solver="tpu"), n=8)
    ref_run()
    align_counters()
    op, run = chip_smoke.consolidation_scenario(
        chip_smoke.port_classes(), cpu_options(kernel), n=8)
    log = checked_run(op, run, expect_sweep=8)
    assert log["sweeps"][0]["candidates"] == 8
    assert bindings(op) == bindings(ref)
    assert node_names(op) == node_names(ref)
    outcome = chip_smoke.operator_outcome(op)
    assert outcome == chip_smoke.operator_outcome(ref)
    assert outcome[2] and outcome[0] < 8


def test_sweep_checks_hold_on_cpu(monkeypatch):
    """chip_smoke.py's phase-8 sweep checks at 8 nodes, on the CPU: the
    run through the ``cuda`` backend (its wrapper runs the plain version
    for CPU tensors) keeps the first sweep of each prefix count; its
    launch's output and verdicts are held to the plain batched scan
    (``hold_batched_bit_equal``, which reruns the kernel on the card, is
    stood in by the plain scan); its frontiers equal, pass by pass, those
    of the same scenario through ``reference``."""
    from karpenter_core_tpu_torch.ops import ffd

    def plain_only(state, steps, statics, li, names, grids=(0,),
                   scan=None):
        # the sweep's captured stack has its plane packed, as the kernel
        # takes it, and is held through the sweep's entry; the hold
        # compares the planes unpacked
        assert grids == (0, 2) and len(names) == int(state.kind.shape[0])
        assert scan is cuda_ffd.cuda_ffd_solve_prefixes
        return (ffd.ffd_solve_batched(cuda_ffd.unpack_state(state), steps,
                                      statics, li), 0.0, 0.0)

    monkeypatch.setattr(chip_smoke, "hold_batched_bit_equal", plain_only)
    logs = {}
    for kernel in ("cuda", "reference"):
        chip_smoke.reset_name_counters()
        op, run = chip_smoke.consolidation_scenario(
            chip_smoke.port_classes(), cpu_options(kernel), n=8)
        logs[kernel] = checked_run(op, run, expect_sweep=8)
    log = logs["cuda"]
    sizes = {s["candidates"] for s in log["sweeps"]}
    assert 8 in sizes and sorted(log["captured"]) == sorted(sizes)
    assert len(log["frontiers"]) == len(log["sweeps"])
    held = chip_smoke.hold_operator_sweeps(log, "port")
    assert [h["P"] for h in held] == sorted(sizes)
    chip_smoke.same_sweeps(log, logs["reference"], "port")
    # the reference backend never reaches the kernel's wrapper
    assert all("kernel_out" not in c
               for c in logs["reference"]["captured"].values())
    # a sweep whose verdicts differ from the plain scan's fails the check
    cap = log["captured"][8]
    cap["verdicts"] = (cap["verdicts"][0] + 1, *cap["verdicts"][1:])
    with pytest.raises(AssertionError, match="verdicts"):
        chip_smoke.hold_operator_sweeps(log, "port")
    # and so does a frontier that differs from the plain version's run
    logs["reference"]["frontiers"][0] = [
        (not ok, n, lb) for ok, n, lb in logs["reference"]["frontiers"][0]]
    with pytest.raises(AssertionError, match="frontier"):
        chip_smoke.same_sweeps(log, logs["reference"], "port")


def test_profiled_solve_writes_torch_trace(tmp_path):
    op = chip_smoke._new_operator(
        chip_smoke.port_classes(), interop.from_reference(CATALOG),
        cpu_options(profile_solves=1, profile_dir=str(tmp_path)))
    op.kube.create(interop.from_reference(make_nodepool()))
    op.kube.create(interop.from_reference(make_pod(cpu=1.0, name="p0")))
    checked_run(op, op.run_until_idle)
    assert (tmp_path / "solve-0.pprof").is_file()
    assert (tmp_path / "solve-0-torch.json").is_file()
    assert all(p.node_name for p in op.kube.list_pods())


# ---------------------------------------------------------------------------
# what the port's operator accepts and what it refuses


@pytest.mark.parametrize("kernel", ["xla", "pallas", "cudaa"])
def test_solver_kernel_rejects_other_kernels(kernel):
    with pytest.raises(ValueError, match="kernel"):
        Options.parse(["--kernel", kernel])
    with pytest.raises(ValueError, match="kernel"):
        Operator(options=Options(solver="tpu", solver_kernel=kernel,
                                 device_scheduler_opts={"device": "cpu"}))


def test_solver_kernel_defaults_to_cuda():
    assert Options().solver_kernel == "cuda"
    assert Options.parse([]).solver_kernel == "cuda"
    assert Options.parse(["--kernel=reference"]).solver_kernel == "reference"
    op = Operator(options=cpu_options("reference"))
    assert op.provisioner.device_scheduler_opts == {
        "device": "cpu", "kernel_backend": "reference",
        "solver_mode": "ffd", "devices": 1}
    op = Operator(options=Options(solver="tpu",
                                  device_scheduler_opts={"device": "cpu"}))
    assert op.provisioner.device_scheduler_opts["kernel_backend"] == "cuda"


@pytest.mark.parametrize("flag,value,attr", [
    ("--solver-addr", "127.0.0.1:1", "solver_addr"),
    ("--solver-tenant", "t", "solver_tenant"),
    ("--solver-fleet", "2", "solver_fleet"),
    ("--solver-wire", "full", "solver_wire"),
])
def test_sidecar_flags_parse(flag, value, attr):
    """The solverd sidecar's flags parse as the JAX package's do."""
    assert (getattr(Options.parse([flag, value]), attr)
            == getattr(RefOptions.parse([flag, value]), attr))
    with pytest.raises(ValueError, match="--solver-mode=sidecar requires"):
        Options.parse(["--solver-mode", "sidecar"])
    assert Options.parse(["--solver-mode", "sidecar", "--solver",
                          "tpu"]).solver_mode == "sidecar"


def test_sidecar_routes():
    """An external --solver-addr or an injected client builds no
    supervisor and routes solves through RemoteScheduler."""
    from karpenter_core_tpu_torch.solver.remote import (
        RemoteScheduler,
        SolverClient,
    )

    op = Operator(options=Options(solver="tpu", solver_mode="sidecar",
                                  solver_addr="127.0.0.1:1"))
    assert op.solver_supervisor is None
    assert isinstance(op.solver_client, SolverClient)
    assert isinstance(op.provisioner.new_scheduler([]), RemoteScheduler)
    client = SolverClient("127.0.0.1:1")
    op = Operator(options=Options(solver="tpu", solver_mode="sidecar"),
                  solver_client=client)
    assert op.solver_client is client
    assert isinstance(op.provisioner.new_scheduler([]), RemoteScheduler)
    with pytest.raises(ValueError, match="requires solver_mode=sidecar"):
        Operator(options=cpu_options(), solver_client=client)


@pytest.mark.parametrize("opts", [
    dict(solver_devices=2), dict(device_scheduler_opts={"device": "cpu",
                                                        "devices": 0})])
def test_other_device_counts_raise(opts, monkeypatch):
    """A device count resolves as in the JAX package: on a one-device host
    (the CPU) it is the single-device solve; on an 8-device virtual CPU
    mesh it resolves as JAX's does on its 8-device mesh, and the
    operator's scheduler solves on that mesh with the one-device answer,
    wire for wire. (The name is kept from when other counts were
    refused.)"""
    from karpenter_core_tpu.parallel import mesh as ref_mesh
    from karpenter_core_tpu.solver import codec
    from karpenter_core_tpu_torch.parallel import mesh as pmesh

    opts.setdefault("device_scheduler_opts", {"device": "cpu"})
    op = Operator(options=Options(solver="tpu", **opts))
    assert op.provisioner.new_scheduler([]).devices == 1
    pods = [make_pod(cpu=1.0, name=f"dc{i}") for i in range(12)]
    op.kube.create(interop.from_reference(make_nodepool()))
    align_counters()
    want = op.provisioner.new_scheduler([]).solve(
        interop.from_reference(pods))
    requested = opts.get("solver_devices",
                         opts["device_scheduler_opts"].get("devices"))
    pmesh.force_virtual_mesh(8, "cpu")
    try:
        op8 = Operator(options=Options(solver="tpu", **opts))
        op8.kube.create(interop.from_reference(make_nodepool()))
        sched = op8.provisioner.new_scheduler([])
        assert sched.devices == ref_mesh.resolve_devices(requested)
        assert sched.devices > 1
        align_counters()
        got = sched.solve(interop.from_reference(pods))
    finally:
        pmesh.force_virtual_mesh(0, "cpu")
    assert sched.last_phase_stats["n_devices"] == sched.devices
    assert got.node_count() == want.node_count() > 0
    assert (codec.encode_solve_results(to_reference(got), 0.0)
            == codec.encode_solve_results(to_reference(want), 0.0))


@pytest.mark.parametrize("opts", [dict(solver_fleet=2),
                                  dict(solver_autoscale=True)])
def test_spawned_sidecar_fleet_raises(opts, monkeypatch):
    """A spawned fleet (``solver_fleet=2``) and the autoscaled tier run as
    in the JAX package: the operator spawns its CPU children under a
    ``FleetSupervisor``, routes through a ``FleetRouter``, and provisions
    tests/test_segments.py's battery to the in-process operator's answer
    with no failed RPC; an external member list is routed."""
    from tests.torch_ported import ported
    from karpenter_core_tpu_torch.cloudprovider.kwok import build_catalog
    from karpenter_core_tpu_torch.solver.remote import FleetRouter
    from karpenter_core_tpu_torch.solver.supervisor import FleetSupervisor

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    segments = ported("test_segments")
    cat = build_catalog(cpu_grid=[1, 2, 4, 8], mem_factors=[2, 4])
    cpu = dict(solver_kernel="reference",
               device_scheduler_opts={"device": "cpu"})
    inproc = segments._battery(segments._operator(
        dict(solver_mode="inproc", **cpu), cat), "f")
    failures0 = dict(m.SOLVER_RPC_FAILURES.values)
    spawned = segments._operator(dict(solver_mode="sidecar", **opts, **cpu),
                                 cat)
    try:
        assert isinstance(spawned.solver_supervisor, FleetSupervisor)
        assert isinstance(spawned.solver_client, FleetRouter)
        assert len(spawned.solver_supervisor.members) == opts.get(
            "solver_fleet", 1)
        assert (spawned.solver_autoscaler is not None) == bool(
            opts.get("solver_autoscale"))
        assert segments._battery(spawned, "f") == inproc
        assert dict(m.SOLVER_RPC_FAILURES.values) == failures0
        assert spawned.readyz()
    finally:
        spawned.shutdown()
    assert spawned.solver_supervisor.alive_count() == 0
    op = Operator(options=Options(solver="tpu", solver_mode="sidecar",
                                  solver_addr="127.0.0.1:1,127.0.0.1:2"))
    assert op.solver_supervisor is None
    assert isinstance(op.solver_client, FleetRouter)


def test_relax_backend_threads_into_scheduler():
    op = Operator(options=cpu_options(solver_backend="relax"))
    assert op.provisioner.device_scheduler_opts["solver_mode"] == "relax"
    assert op.provisioner.new_scheduler([]).solver_mode == "relax"


def test_tpu_solver_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        Operator(options=Options(solver="tpu"))
    # the greedy solver needs no device
    assert Operator(options=Options()).options.solver == "greedy"
