"""The port's plain FFD scan against the JAX package's, plane for plane.

The JAX DeviceScheduler prepares each problem and yields its kernel
request; its init state, steps and statics go through numpy and
``interop.tensors_from_numpy`` into the port's plain ``ffd_solve`` and
``aggregate_takes`` on the CPU. Every plane of the final slot state, the
per-step takes and unplaced counts and the per-class aggregates must be
bit-equal to the JAX ``ffd_solve`` and ``aggregate_takes`` on the same
request (float planes compared as raw bits). On two problems the JAX
package's Pallas step (``pallas_ffd.pallas_ffd_solve``, interpreted on the
CPU as tests/test_pallas.py runs it) is held to the same planes.

The CUDA kernel (``ops/cuda_ffd.py``) cannot run here; ``chip_smoke.py``
holds it to this plain version on the card. Here its wrapper is checked to
take the plain version for CPU tensors, and its card path to reach the
kernel build and never the plain version. The kernel keeps, per hostname
group, a flag of "some slot has a positive count" instead of rescanning
the [N, Gh] counts every step; on every fixture the plain scan shows the
claim that makes this exact: counts never fall within a scan, so the flag
kept by the kernel's rule equals the rescan after every step.
"""
import ast
import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_provisioner import (
    fuzz_problem,
    overflow_problem,
    topology_problem,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

from karpenter_core_tpu.models.provisioner import DeviceScheduler as RefScheduler
from karpenter_core_tpu.ops import ffd as jffd
from karpenter_core_tpu.ops import pallas_ffd
from karpenter_core_tpu_torch import interop
from karpenter_core_tpu_torch.ops import cuda_ffd
from karpenter_core_tpu_torch.ops import ffd as tffd

FIXTURES = {
    **{f"fuzz{s}": (lambda s=s: fuzz_problem(s)) for s in range(14)},
    "topology": topology_problem,
    "overflow": overflow_problem,
}


def reference_request(problem):
    """The JAX scheduler's first kernel request for this problem."""
    pools, its, existing, pods, max_slots = problem
    sched = RefScheduler(
        copy.deepcopy(pools), its, existing_nodes=copy.deepcopy(existing),
        max_slots=max_slots,
    )
    gen = sched._solve_gen(copy.deepcopy(pods))
    req = gen.send(None)
    gen.close()
    return req


def _numpy(tree):
    return type(tree)(*(None if x is None else np.asarray(x) for x in tree))


def port_inputs(req):
    return interop.tensors_from_numpy(
        (_numpy(req.init_state), _numpy(req.steps), _numpy(req.statics)),
        "cpu",
    )


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_planes_equal(port: dict, ref: dict, what: str):
    assert set(port) == set(ref)
    for name in ref:
        p = port[name].numpy()
        r = np.asarray(ref[name])
        assert p.dtype == r.dtype and p.shape == r.shape, (
            what, name, p.dtype, r.dtype, p.shape, r.shape)
        unequal = int((_bits(p) != _bits(r)).sum())
        assert unequal == 0, f"{what}: {name} has {unequal} unequal elements"


def _planes(state, takes, unplaced, tbc, ubc):
    out = dict(state._asdict())
    out.update(takes=takes, unplaced=unplaced, takes_bc=tbc, unplaced_bc=ubc)
    return out


def run_reference(req, solve=jffd.ffd_solve):
    state, takes, unplaced = solve(
        req.init_state, req.steps, req.statics, level_iters=req.level_iters
    )
    tbc, ubc = jffd.aggregate_takes(
        takes, unplaced, req.step_class, num_classes=req.num_classes
    )
    return _planes(state, takes, unplaced, tbc, ubc)


def run_port(req):
    init, steps, statics = port_inputs(req)
    state, takes, unplaced = tffd.ffd_solve(
        init, steps, statics, level_iters=req.level_iters
    )
    step_class = torch.tensor(np.asarray(req.step_class))
    tbc, ubc = tffd.aggregate_takes(
        takes, unplaced, step_class, num_classes=req.num_classes
    )
    return _planes(state, takes, unplaced, tbc, ubc)


@pytest.mark.parametrize("name", list(FIXTURES))
def test_plain_scan_bit_equal(name):
    req = reference_request(FIXTURES[name]())
    assert_planes_equal(run_port(req), run_reference(req), name)


def test_overflow_case_overflows():
    req = reference_request(overflow_problem())
    planes = run_port(req)
    assert bool(planes["overflow"]) and int(planes["next_free"]) > 8


@pytest.mark.parametrize("name", ["fuzz0", "topology"])
def test_plain_scan_matches_pallas_interpret(name):
    req = reference_request(FIXTURES[name]())
    ref = run_reference(req, solve=pallas_ffd.pallas_ffd_solve)
    assert_planes_equal(run_port(req), ref, f"{name} vs pallas")


def test_cuda_wrapper_takes_plain_version_on_cpu():
    req = reference_request(fuzz_problem(2))
    init, steps, statics = port_inputs(req)
    before = dict(cuda_ffd.counter.launches)
    k = cuda_ffd.cuda_ffd_solve(init, steps, statics, req.level_iters)
    p = tffd.ffd_solve(init, steps, statics, req.level_iters)
    assert cuda_ffd.counter.launches == before
    for a, b in zip(list(k[0]) + [k[1], k[2]], list(p[0]) + [p[1], p[2]]):
        assert torch.equal(a, b)


def test_cuda_wrapper_rejects_other_devices():
    req = reference_request(fuzz_problem(2))
    init, steps, statics = port_inputs(req)
    meta = tffd.SlotState(*(x.to("meta") for x in init))
    with pytest.raises(ValueError, match="device"):
        cuda_ffd.cuda_ffd_solve(meta, steps, statics, req.level_iters)


def _no_plain(*args, **kwargs):
    raise AssertionError("the card path ran the plain version")


class _BuildReached(Exception):
    pass


def _build_reached():
    raise _BuildReached


def test_card_path_builds_the_kernel_and_never_runs_plain(monkeypatch):
    """The wrapper's card path, fed CPU tensors here (it checks their device
    only after the build), goes to the kernel build, not to the plain
    version."""
    req = reference_request(fuzz_problem(2))
    init, steps, statics = port_inputs(req)
    monkeypatch.setattr(cuda_ffd.ffd_ops, "ffd_solve", _no_plain)
    monkeypatch.setattr(cuda_ffd, "build", _build_reached)
    with pytest.raises(_BuildReached):
        cuda_ffd._launch(init, steps, statics, req.level_iters)


def test_card_path_with_no_steps_launches_nothing(monkeypatch):
    req = reference_request(fuzz_problem(2))
    init, steps, statics = port_inputs(req)
    empty = type(steps)(*(None if x is None else x[:0] for x in steps))
    monkeypatch.setattr(cuda_ffd.ffd_ops, "ffd_solve", _no_plain)
    monkeypatch.setattr(cuda_ffd, "build", _no_plain)
    before = dict(cuda_ffd.counter.launches)
    state, takes, unplaced = cuda_ffd._launch(
        init, empty, statics, req.level_iters)
    N = init.kind.shape[0]
    assert takes.shape == (0, N) and takes.dtype == torch.int32
    assert unplaced.shape == (0,) and unplaced.dtype == torch.int32
    for a, b in zip(state, init):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert cuda_ffd.counter.launches == before


def test_wrapper_calls_plain_version_only_for_cpu_tensors():
    """In ops/cuda_ffd.py the plain scan is reached from one place: the
    ``dev.type == "cpu"`` branch of ``cuda_ffd_solve``."""
    tree = ast.parse(Path(cuda_ffd.__file__).read_text())
    uses = [n for n in ast.walk(tree)
            if isinstance(n, ast.Attribute) and n.attr == "ffd_solve"]
    assert len(uses) == 1
    (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef)
             and n.name == "cuda_ffd_solve"]
    cpu_branch = [n for n in ast.walk(fn) if isinstance(n, ast.If)
                  and "cpu" in ast.unparse(n.test)]
    assert len(cpu_branch) == 1
    assert uses[0] in list(ast.walk(cpu_branch[0]))


def test_each_kernel_has_its_own_entry_and_count():
    """The scan is one kernel, launched from one C entry (``ffd_scan``) as
    one cooperative launch, and counted under its own name."""
    src = cuda_ffd.SOURCE.read_text()
    assert cuda_ffd.KERNELS == ("k_ffd_scan",)
    assert "<<<" not in src
    for name in cuda_ffd.KERNELS:
        assert f"__launch_bounds__(THREADS, 1) {name}(FfdArgs args)" in src
        assert src.count(f"cudaLaunchCooperativeKernel((const void*){name},") == 1
    assert src.count("int ffd_scan(") == 1
    assert "launch_k_" not in src
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in src
    c = cuda_ffd.LaunchCounter()
    assert c.launches == dict.fromkeys(cuda_ffd.KERNELS, 0) and c.total() == 0
    assert c.rows == 0 and c.blocks == 0


@pytest.mark.parametrize(
    "name", ["topology"] + [f"fuzz{s}" for s in range(14)])
def test_hostname_flag_kept_incrementally_equals_rescan(name):
    """The kernel's prologue reads, per hostname group, a flag that some
    slot's count is positive (``pos_any`` of ``_host_caps``) which it sets
    once from the initial counts and then only where the merge makes a
    selected group's count positive on a slot that took pods. Step by step
    through the plain scan, every take is >= 0, no count falls, and that
    flag equals ``(hcount > 0).any(0)``."""
    req = reference_request(FIXTURES[name]())
    init, steps, statics = port_inputs(req)
    flag = (init.hcount > 0).any(0)
    state, changed = init, 0
    for j in range(steps.count.shape[0]):
        c = tffd.step_at(steps, j)
        new, (take, _) = tffd.ffd_step(state, c, statics, req.level_iters)
        assert bool((take >= 0).all())
        assert bool((new.hcount >= state.hcount).all())
        kept = flag | (c.h_sel[None, :] & (take > 0)[:, None]
                       & (new.hcount > 0)).any(0)
        changed += int((kept != flag).sum())
        flag, state = kept, new
        assert torch.equal(flag, (state.hcount > 0).any(0)), (name, j)
    assert changed > 0  # the flag did turn on inside the scan


def test_kernel_source_ships_with_the_package():
    """The wrapper builds from the package's own source; nothing is built
    at import."""
    assert cuda_ffd.SOURCE.is_file()
    assert cuda_ffd.SOURCE.parent.name == "csrc"
    assert "-fmad=false" in cuda_ffd.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in cuda_ffd.NVCC_FLAGS
