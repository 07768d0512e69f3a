"""The in-process operator's crash-only exit after a sticky CUDA error.

A sticky CUDA error (illegal address, device-side assert, ...) poisons the
process's CUDA context, so every later device call in that process fails.
The port's operator records the first one a reconciler raises, stops
calling controllers and reports ``healthz()`` and ``readyz()`` False; its
binary exits ``DEVICE_FAULT_EXIT_CODE`` within a fixed bound, and the
restarted process binds the pods as the JAX operator does on the same
cluster. An error that is not sticky keeps the backoff path.

On the CPU the sticky error is faked at the kernel seam
(``models/provisioner._run_kernel_solo``) with the CUDA runtime's own
message, as tests/test_torch_solverd.py does; ``chip_smoke.py`` phase 16
raises a real one on the card.
"""
import subprocess
import sys
import textwrap
import threading
import time

import pytest

import chip_smoke
import fleet_expected
from fleet_expected import to_reference
from tests.helpers import make_nodepool, make_pod
from tests.test_e2e import new_operator as ref_new_operator
from tests.test_torch_consolidation import align_counters
from tests.test_torch_operator import (
    CATALOG,
    bindings,
    cpu_options,
    node_names,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

from karpenter_core_tpu_torch import interop
from karpenter_core_tpu_torch import main as tmain
from karpenter_core_tpu_torch.metrics import wiring as m
from karpenter_core_tpu_torch.models import provisioner as tprov
from karpenter_core_tpu_torch.operator import Operator
from karpenter_core_tpu_torch.solver.supervisor import WATCHDOG_EXIT_CODE

STICKY = "CUDA error: device-side assert triggered"
N_PODS = 20


def _pods():
    return [make_pod(cpu=1.0, name=f"p{i}") for i in range(N_PODS)]


def port_operator(pods):
    """The port's operator on the CPU (plain scan) with a pool and
    ``pods`` (the reference's, carried across) pending."""
    op = chip_smoke._new_operator(chip_smoke.port_classes(),
                                  interop.from_reference(CATALOG),
                                  cpu_options())
    op.kube.create(interop.from_reference(make_nodepool()))
    for p in pods:
        op.kube.create(interop.from_reference(p))
    return op


def reference_run(pods):
    align_counters()
    ref = ref_new_operator("tpu", CATALOG)
    ref.kube.create(make_nodepool())
    for p in pods:
        ref.kube.create(to_reference(interop.from_reference(p)))
    ref.run_until_idle()
    return ref


class Seam:
    """A stand-in for the kernel seam: raises ``errors`` in turn, then
    answers through the real seam; counts every call."""

    def __init__(self, *errors):
        self.errors = list(errors)
        self.calls = 0
        self.real = tprov._run_kernel_solo

    def __call__(self, req):
        self.calls += 1
        if self.errors:
            raise self.errors.pop(0)
        return self.real(req)


def _sticky_chained():
    """A sticky error that surfaces at a later synchronising call: the
    raise the operator sees carries it as its cause."""
    try:
        raise RuntimeError(STICKY)
    except RuntimeError as e:
        try:
            raise RuntimeError("decode fetch failed") from e
        except RuntimeError as outer:
            return outer


def _errors(controller="provisioning"):
    return m.RECONCILE_ERRORS.value(
        {"controller": controller, "error": "RuntimeError"})


@pytest.mark.parametrize("error", ["direct", "chained"])
def test_sticky_error_stops_the_operator(monkeypatch, error):
    """The first sticky error is recorded once (a DeviceFault Warning and
    one reconcile_errors count); no controller runs after it, so the seam
    is never called again, no pod binds, and healthz and readyz are
    False."""
    exc = RuntimeError(STICKY) if error == "direct" else _sticky_chained()
    seam = Seam(exc)
    monkeypatch.setattr(tprov, "_run_kernel_solo", seam)
    align_counters()
    op = port_operator(_pods())
    assert op.healthz()
    errors0 = _errors()
    op.run_until_idle()
    assert seam.calls == 1
    assert op.device_fault is exc
    assert not op.healthz() and not op.readyz()
    assert _errors() == errors0 + 1
    faults = op.recorder.with_reason("DeviceFault")
    assert len(faults) == 1 and faults[0].type == "Warning"
    assert "device-side assert" in faults[0].message
    for _ in range(3):
        op.reconcile_once()
        op.clock.step(30.0)
    op.run_until_idle()
    assert seam.calls == 1 and _errors() == errors0 + 1
    assert not any(p.node_name for p in op.kube.list_pods())
    assert not op.kube.list_nodeclaims()


def test_non_sticky_error_backs_off_and_recovers(monkeypatch):
    """A host-side raise keeps today's path: the controller backs off,
    the next pass after the backoff solves, and the result is the JAX
    operator's, binding for binding; the operator stays live."""
    pods = _pods()
    ref = reference_run(pods)
    seam = Seam(RuntimeError("chaos: poisoned"))
    monkeypatch.setattr(tprov, "_run_kernel_solo", seam)
    align_counters()
    op = port_operator(pods)
    errors0 = _errors()
    op.run_until_idle()
    assert seam.calls >= 2 and _errors() == errors0 + 1
    assert op.device_fault is None and op.healthz() and op.readyz()
    assert not op.recorder.with_reason("DeviceFault")
    assert op.recorder.with_reason("ReconcileError")
    assert all(node for _name, node in bindings(op))
    assert bindings(op) == bindings(ref)
    assert node_names(op) == node_names(ref)
    assert (chip_smoke.operator_outcome(op)
            == chip_smoke.operator_outcome(ref))


def test_restart_binds_like_the_reference(monkeypatch):
    """After the fault, a fresh Operator over the same KubeStore (the
    restarted process) binds every pod with the JAX operator's node count
    and cpu on the same cluster."""
    pods = _pods()
    ref = reference_run(pods)
    monkeypatch.setattr(tprov, "_run_kernel_solo", Seam(RuntimeError(STICKY)))
    align_counters()
    faulted = port_operator(pods)
    faulted.run_until_idle()
    assert faulted.device_fault is not None
    monkeypatch.undo()
    fresh = Operator(kube=faulted.kube, clock=faulted.clock,
                     options=cpu_options(),
                     cloud_provider=faulted.cloud_provider)
    assert fresh.healthz()
    fresh.run_until_idle()
    assert fresh.device_fault is None and fresh.readyz()
    outcome = chip_smoke.operator_outcome(fresh)
    assert outcome == chip_smoke.operator_outcome(ref) and outcome[2]


def _main_args():
    return ["--solver", "tpu", "--max-iters", "400", "--poll-interval",
            "0.01", "--batch-max-duration", "0.05",
            "--batch-idle-duration", "0.01"]


@pytest.mark.parametrize("teardown", ["clean", "raises", "hangs"])
def test_main_exits_with_the_fault_code(monkeypatch, teardown):
    """``main()`` ends its loop on the fault and returns
    DEVICE_FAULT_EXIT_CODE (solverd's watchdog code) within its bound,
    also when ``shutdown()`` meets the poisoned context and raises again
    or hangs."""
    assert tmain.DEVICE_FAULT_EXIT_CODE == WATCHDOG_EXIT_CODE
    seam = Seam(RuntimeError(STICKY))
    monkeypatch.setattr(tprov, "_run_kernel_solo", seam)
    monkeypatch.setattr(tmain, "FAULT_EXIT_GRACE_S", 0.05)
    monkeypatch.setattr(tmain, "TEARDOWN_TIMEOUT_S", 0.5)
    built = []
    release = threading.Event()

    def operator(options):
        options.device_scheduler_opts = {"device": "cpu",
                                         "kernel_backend": "reference"}
        op = Operator(options=options)
        op.kube.create(interop.from_reference(make_nodepool()))
        for p in _pods():
            op.kube.create(interop.from_reference(p))
        if teardown == "raises":
            def shutdown():
                raise RuntimeError(STICKY)
            op.shutdown = shutdown
        elif teardown == "hangs":
            op.shutdown = release.wait
        built.append(op)
        return op

    monkeypatch.setattr(tmain, "Operator", operator)
    t0 = time.monotonic()
    try:
        code = tmain.main(_main_args())
    finally:
        release.set()
    wall = time.monotonic() - t0
    assert code == tmain.DEVICE_FAULT_EXIT_CODE
    assert seam.calls == 1
    assert not built[0].healthz()
    assert wall < 20.0
    if teardown == "hangs":
        assert wall >= tmain.TEARDOWN_TIMEOUT_S


def test_main_without_a_fault_returns_zero(monkeypatch):
    """No fault: the loop runs its --max-iters and returns 0 as before."""
    def operator(options):
        options.device_scheduler_opts = {"device": "cpu"}
        return Operator(options=options)

    monkeypatch.setattr(tmain, "Operator", operator)
    assert tmain.main(["--solver", "tpu", "--max-iters", "2",
                       "--poll-interval", "0.01"]) == 0


_CHILD = """
import sys, runpy
from karpenter_core_tpu_torch import operator as opmod
from karpenter_core_tpu_torch.models import provisioner
from karpenter_core_tpu_torch.api.nodepool import NodePool, NodePoolSpec
from karpenter_core_tpu_torch.api.objects import ObjectMeta
from karpenter_core_tpu_torch.cloudprovider.kwok import build_catalog
from tests.helpers import make_pod
from karpenter_core_tpu_torch import interop

def faulting_scan(req):
    raise RuntimeError("CUDA error: device-side assert triggered")

provisioner._run_kernel_solo = faulting_scan
real = opmod.Operator

def operator(options=None):
    options.device_scheduler_opts = {"device": "cpu",
                                     "kernel_backend": "reference"}
    op = real(options=options)
    pool = NodePool(metadata=ObjectMeta(name="default"))
    pool.spec = NodePoolSpec()
    op.kube.create(pool)
    for i in range(4):
        op.kube.create(interop.from_reference(make_pod(cpu=1.0,
                                                       name=f"p{i}")))
    # teardown meets the poisoned context and hangs
    op.shutdown = lambda: __import__("time").sleep(3600)
    return op

opmod.Operator = operator
sys.argv = ["karpenter"] + sys.argv[1:]
runpy.run_module("karpenter_core_tpu_torch.main", run_name="__main__",
                 alter_sys=True)
"""


def test_binary_exits_crash_only_in_a_child(monkeypatch):
    """The binary as a process: the fault ends it with
    DEVICE_FAULT_EXIT_CODE within the teardown bound although its
    teardown hangs, and stderr names the cause."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the child's torch
    cmd = [sys.executable, "-c", textwrap.dedent(_CHILD), *_main_args()]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    wall = time.monotonic() - t0
    assert proc.returncode == tmain.DEVICE_FAULT_EXIT_CODE, proc.stderr
    assert "sticky CUDA error" in proc.stderr
    assert "device-side assert triggered" in proc.stderr
    assert "still running" in proc.stderr  # the hung teardown was left
    assert wall < 100.0


def test_fault_expected_is_the_jax_operators():
    """chip_smoke.py phase 16a's pinned answer is the JAX operator's over
    its own HTTP apiserver on the same pods (the name counters reset
    first, as phase 16a does): every pod bound, ``FAULT_EXPECTED`` nodes
    and cpu."""
    from karpenter_core_tpu.cloudprovider.kwok import bench_catalog

    chip_smoke.reset_name_counters()
    pods = to_reference(chip_smoke._plain_pods(chip_smoke.FAULT_PODS))
    readback, _ = fleet_expected.ref_http_run(
        pods, list(bench_catalog(chip_smoke.HTTP_TYPES)),
        to_reference(chip_smoke._pool()))
    assert readback[2] and readback[3] == chip_smoke.FAULT_PODS
    assert list(readback[:2]) == chip_smoke.FAULT_EXPECTED
