"""The port's device count against the JAX package's.

``parallel/mesh.resolve_devices`` resolves a request as the JAX package's
does: ``1`` touches nothing, ``0`` is every device of the kind, and any
other count clamps to what exists. So ``DeviceScheduler(devices=0)`` and
``devices=8`` on a one-device host are the single-device solve in both
packages. The JAX side runs on this suite's 8-device virtual CPU mesh (a
sharded solve, whose wire equals the single-device one) and, for the
``n_devices`` stat, on a one-device view of the same host, which is what
the port sees on the CPU. A count that resolves above 1, on the port's virtual
CPU mesh, is held to the JAX package's sharded solves in
``tests/test_torch_sharded.py``.
"""
from __future__ import annotations

import copy
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest
import torch

from tests.test_torch_provisioner import (
    _align_hostnames,
    fuzz_problem,
    to_reference,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

from karpenter_core_tpu.models.provisioner import DeviceScheduler as RefScheduler
from karpenter_core_tpu.parallel import mesh as ref_mesh
from karpenter_core_tpu.solver import codec
from karpenter_core_tpu_torch import interop
from karpenter_core_tpu_torch.models.provisioner import (
    DeviceScheduler as PortScheduler,
)
from karpenter_core_tpu_torch.operator import Operator, Options
from karpenter_core_tpu_torch.parallel import mesh as pmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _one_device_jax():
    """The JAX mesh module's view of a one-device host."""
    attrs = {k: getattr(jax, k) for k in dir(jax) if not k.startswith("__")}
    attrs["devices"] = lambda *a: jax.devices(*a)[:1]
    return SimpleNamespace(**attrs)


@pytest.mark.parametrize("requested", [1, 0, -1, 2, 8, None])
def test_resolve_devices_on_the_cpu_matches_a_one_device_jax(
    requested, monkeypatch
):
    monkeypatch.setattr(ref_mesh, "jax", _one_device_jax())
    assert pmesh.resolve_devices(requested, "cpu") == ref_mesh.resolve_devices(
        requested
    )
    assert pmesh.resolve_devices(requested, "cpu") == 1


@pytest.mark.parametrize("available", [1, 4, 8])
def test_resolve_devices_counts_gpus(available, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: available)
    for requested, want in ((1, 1), (0, available), (2, min(2, available)),
                            (16, available)):
        assert pmesh.resolve_devices(requested, "cuda") == want
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert pmesh.resolve_devices(0, "cuda") == 1


@pytest.mark.parametrize("n,n_devices", [(256, 1), (256, 3), (100, 8),
                                         (0, 4), (7, 0)])
def test_pad_to_devices_copied(n, n_devices):
    assert pmesh.pad_to_devices(n, n_devices) == ref_mesh.pad_to_devices(
        n, n_devices
    )


def _solve(cls, problem, devices, **kw):
    pools, its, existing, pods, max_slots = problem
    _align_hostnames()
    sched = cls(pools, its, existing_nodes=existing, max_slots=max_slots,
                devices=devices, **kw)
    return sched, sched.solve(pods)


@pytest.mark.parametrize("devices", [0, 8])
def test_device_scheduler_device_counts_match_jax(devices, monkeypatch):
    problem = fuzz_problem(1)
    pools, its, existing, pods, max_slots = problem
    port_in = interop.from_reference((pools, its, existing, pods))
    # the JAX package on its 8-device virtual mesh: a sharded solve
    ref8, r8 = _solve(RefScheduler, copy.deepcopy(problem), devices)
    assert ref8.last_phase_stats["n_devices"] == 8
    # ... and on a one-device view of the host, as the port sees the CPU
    monkeypatch.setattr(ref_mesh, "jax", _one_device_jax())
    ref1, r1 = _solve(RefScheduler, copy.deepcopy(problem), devices)
    monkeypatch.undo()
    port, rp = _solve(PortScheduler, (*port_in, max_slots), devices,
                      device="cpu", kernel_backend="reference")
    w8 = codec.encode_solve_results(r8, 0.0)
    w1 = codec.encode_solve_results(r1, 0.0)
    wp = codec.encode_solve_results(to_reference(rp), 0.0)
    assert wp == w1 == w8
    assert port.devices == ref1.devices == 1
    assert (port.last_phase_stats["n_devices"]
            == ref1.last_phase_stats["n_devices"] == 1)


def test_operator_all_devices_is_one_device_on_the_cpu():
    op = Operator(options=Options(
        solver="tpu", solver_devices=0,
        device_scheduler_opts={"device": "cpu"}, solver_kernel="reference",
    ))
    sched = op.provisioner.new_scheduler([])
    assert isinstance(sched, PortScheduler) and sched.devices == 1
    op.shutdown()


def test_solverd_devices_zero_serves_on_one_device():
    """``--devices 0`` (every device) starts the daemon on the CPU's one
    device, as the JAX daemon does on a one-chip host."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "karpenter_core_tpu_torch.solver.service",
         "--port", "0", "--device", "cpu", "--kernel", "reference",
         "--devices", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.strip() == "ready":
                break
        assert any("listening on" in ln for ln in lines), lines
        assert lines and lines[-1].strip() == "ready", lines
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
