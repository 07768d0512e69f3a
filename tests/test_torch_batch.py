"""The port's cross-tenant batched solves against the JAX package's.

* The plain batched scan (``ops/ffd.ffd_solve_batched``) and the batched
  per-class sum (``aggregate_takes_batched``) on three distinct stacked
  requests are bit-equal, plane for plane, to the JAX ``ffd_solve_batched``
  and ``aggregate_takes_batched``; at a tiny size also to the JAX
  package's batched Pallas step (``pallas_ffd.pallas_ffd_solve_batched``,
  interpreted on the CPU as tests/test_pallas.py runs it).
* ``models/provisioner.solve_batch`` on the batches of tests/test_batch.py
  (mixed, topology member and shape split, batch of one, a poisoned
  member) and on four tenants of a small diverse mix (generic pods, zone
  and hostname spread, hostname anti-affinity): every member's result
  wire (``codec.encode_solve_results`` with solve_seconds pinned to 0.0)
  is byte-identical to the JAX ``solve_batch`` member's, and the batch
  stats are equal; a diverse tenant's wire is also its wire solved
  alone. A batched dispatch that fails re-runs its members solo, unless
  the error is a sticky CUDA error: that one reaches every member still
  pending in the call with no further launch (spies count the
  dispatches).
* "cuda" and "reference" problems never share a batched dispatch; the
  shape key splits on backend and on device.
* ``ops/cuda_ffd.cuda_ffd_solve_batched`` takes the plain version for CPU
  tensors and rejects other devices; its card path, with the kernel
  library mocked, makes one C call and one launch per scan for all B
  problems and J class steps, counts B rows, passes the grid cap and the
  stamp buffer through, and never runs the plain version.

The CUDA kernel itself runs only on the card (``chip_smoke.py``).
"""
import ast
import ctypes
import contextlib
import copy
import dataclasses
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.helpers import make_nodepool, make_pod
from tests.test_batch import _catalog, _problem
from tests.test_torch_ffd import assert_planes_equal, reference_request
from tests.test_torch_provisioner import _align_hostnames, to_reference
from tests.torch_threads import one_torch_thread  # noqa: F401

from karpenter_core_tpu.api.labels import LABEL_HOSTNAME
from karpenter_core_tpu.models import provisioner as jprov
from karpenter_core_tpu.ops import ffd as jffd
from karpenter_core_tpu.ops import pallas_ffd
from karpenter_core_tpu.solver import codec
from karpenter_core_tpu_torch import interop
from karpenter_core_tpu_torch.models import provisioner as tprov
from karpenter_core_tpu_torch.ops import cuda_ffd
from karpenter_core_tpu_torch.ops import ffd as tffd

MIXED = [("pa", 20, 0.25), ("pb", 24, 0.3), ("pc", 20, 0.2)]


def _wire(results):
    return codec.encode_solve_results(results, 0.0)


def _stack_np(trees):
    return type(trees[0])(*(
        None if xs[0] is None else np.stack([np.asarray(x) for x in xs])
        for xs in zip(*trees)
    ))


def _jax_requests(specs, max_slots=64):
    reqs = []
    for name, n_pods, cpu_step in specs:
        pool, pods = _problem(name, n_pods, cpu_step)
        reqs.append(reference_request(
            ([pool], {name: list(_catalog())}, [], pods, max_slots)))
    assert len({r.shape_key() for r in reqs}) == 1
    return reqs


def _stacked(reqs):
    return (
        _stack_np([r.init_state for r in reqs]),
        _stack_np([r.steps for r in reqs]),
        _stack_np([r.statics for r in reqs]),
        np.stack([np.asarray(r.step_class) for r in reqs]),
    )


def _planes(state, takes, unplaced, tbc, ubc):
    out = dict(state._asdict())
    out.update(takes=takes, unplaced=unplaced, takes_bc=tbc, unplaced_bc=ubc)
    return out


def _reference_batched(reqs, solve=jffd.ffd_solve_batched):
    init, steps, statics, step_class = _stacked(reqs)
    state, takes, unplaced = solve(init, steps, statics,
                                   level_iters=reqs[0].level_iters)
    tbc, ubc = jffd.aggregate_takes_batched(
        takes, unplaced, step_class, num_classes=reqs[0].num_classes)
    return _planes(state, takes, unplaced, tbc, ubc)


def _port_inputs(reqs):
    init, steps, statics, step_class = _stacked(reqs)
    return (*interop.tensors_from_numpy((init, steps, statics), "cpu"),
            torch.tensor(step_class))


def _port_batched(reqs):
    init, steps, statics, step_class = _port_inputs(reqs)
    state, takes, unplaced = tffd.ffd_solve_batched(
        init, steps, statics, level_iters=reqs[0].level_iters)
    tbc, ubc = tffd.aggregate_takes_batched(
        takes, unplaced, step_class, num_classes=reqs[0].num_classes)
    return _planes(state, takes, unplaced, tbc, ubc)


# ---------------------------------------------------------------------------
# the plain batched scan and the batched per-class sum


def test_plain_batched_scan_bit_equal():
    reqs = _jax_requests(MIXED)
    assert_planes_equal(_port_batched(reqs), _reference_batched(reqs),
                        "batched scan")


def test_plain_batched_scan_matches_pallas_interpret():
    reqs = _jax_requests([("ta", 8, 0.25), ("tb", 7, 0.3)], max_slots=16)
    ref = _reference_batched(reqs, solve=pallas_ffd.pallas_ffd_solve_batched)
    assert_planes_equal(_port_batched(reqs), ref, "batched vs pallas")


@pytest.mark.parametrize("seed", range(3))
def test_aggregate_takes_batched_equal(seed):
    rng = np.random.default_rng(seed)
    B, J, N, Cp = 3, 12, 16, 8
    takes = rng.integers(-5, 50, (B, J, N)).astype(np.int32)
    unplaced = rng.integers(0, 9, (B, J)).astype(np.int32)
    step_class = rng.integers(0, Cp, (B, J)).astype(np.int32)
    rt, ru = jffd.aggregate_takes_batched(takes, unplaced, step_class,
                                          num_classes=Cp)
    pt, pu = tffd.aggregate_takes_batched(
        torch.tensor(takes), torch.tensor(unplaced),
        torch.tensor(step_class), num_classes=Cp)
    assert np.array_equal(pt.numpy(), np.asarray(rt))
    assert np.array_equal(pu.numpy(), np.asarray(ru))
    assert pt.dtype == torch.int32 and pu.dtype == torch.int32


def test_plain_batched_scan_needs_rows():
    reqs = _jax_requests(MIXED)
    init, steps, statics, _ = _port_inputs(reqs)
    empty = [type(t)(*(None if x is None else x[:0] for x in t))
             for t in (init, steps, statics)]
    with pytest.raises(ValueError, match="no problem rows"):
        tffd.ffd_solve_batched(*empty)


# ---------------------------------------------------------------------------
# solve_batch against the JAX package's


def _diverse(name, seed, n_pods=24):
    """One tenant of a small diverse mix: generic pods, zone spread,
    hostname spread and hostname anti-affinity, a quarter each, sizes
    drawn from ``seed``."""
    rng = random.Random(seed)
    pods = []
    for i in range(n_pods):
        cpu = rng.choice([0.1, 0.25, 0.5, 1.0])
        mem = rng.choice([0.25, 0.5, 1.0, 2.0])
        kind = ("generic", "zone", "host", "anti")[i % 4]
        kw = {}
        if kind == "zone":
            kw = dict(spread_zone=True, labels={"app": f"{name}-zone"})
        elif kind == "host":
            kw = dict(spread_hostname=True, labels={"app": f"{name}-host"})
        elif kind == "anti":
            kw = dict(labels={"app": f"{name}-anti"},
                      anti_affinity_to={"app": f"{name}-anti"},
                      affinity_key=LABEL_HOSTNAME)
        pods.append(make_pod(cpu, mem, name=f"{name}-{kind}-{i}", **kw))
    return make_nodepool(name=name), pods


def _members(case):
    if case == "mixed":
        return [(n, *_problem(n, k, c)) for n, k, c in MIXED]
    if case == "diverse":
        return [(n, *_diverse(n, seed))
                for seed, n in enumerate(("da", "db", "dc", "dd"))]
    if case == "split":
        return [("pt", *_problem("pt", 18, spread=True)),
                ("pp", *_problem("pp", 18))]
    return [("one", *_problem("one", 16))]


def _jax_sched(name, pool, cls=jprov.DeviceScheduler):
    return cls([pool], {name: list(_catalog())}, max_slots=64)


def _port_sched(name, pool, backend="reference", cls=tprov.DeviceScheduler):
    pools, its = interop.from_reference(([pool], {name: list(_catalog())}))
    return cls(pools, its, max_slots=64, device="cpu",
               kernel_backend=backend)


def _both(members, backends=None, jax_cls=None, port_cls=None):
    """The same members through the JAX solve_batch and the port's, with
    the hostname counters aligned; returns (jax, port) (outcomes, stats)."""
    k = len(members)
    backends = backends or ["reference"] * k
    jax_cls = jax_cls or [jprov.DeviceScheduler] * k
    port_cls = port_cls or [tprov.DeviceScheduler] * k
    j_entries = [
        (_jax_sched(n, pool, jc), copy.deepcopy(pods))
        for (n, pool, pods), jc in zip(members, jax_cls)
    ]
    p_entries = [
        (_port_sched(n, pool, be, pc), interop.from_reference(pods))
        for (n, pool, pods), be, pc in zip(members, backends, port_cls)
    ]
    _align_hostnames()
    j = jprov.solve_batch(j_entries)
    p = tprov.solve_batch(p_entries)
    return j, p


def _assert_same_outcomes(j_out, p_out):
    assert [s for s, _ in p_out] == [s for s, _ in j_out]
    for (js, jr), (ps, pr) in zip(j_out, p_out):
        if js == "ok":
            assert _wire(to_reference(pr)) == _wire(jr)
        else:
            assert type(pr).__name__ == type(jr).__name__
            assert str(pr) == str(jr)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("case", ["mixed", "split", "one", "diverse"])
def test_solve_batch_wire_and_stats_identical(case, backend):
    members = _members(case)
    (j_out, j_stats), (p_out, p_stats) = _both(
        members, backends=[backend] * len(members))
    assert all(s == "ok" for s, _ in p_out), p_out
    _assert_same_outcomes(j_out, p_out)
    assert p_stats == j_stats
    if case == "mixed":
        assert p_stats["batched_dispatches"] == 1
        assert p_stats["padded_rows"] == 1
    if case == "one":
        assert p_stats["batched_dispatches"] == 0


def test_diverse_batch_equals_each_tenant_alone():
    """Each tenant of the diverse batch gives, on the plain route, the
    wire of the same tenant solved alone by a scheduler of its own."""
    members = _members("diverse")
    outcomes, stats = tprov.solve_batch(_port_entries(members, "reference"))
    assert stats["batched_problems"] >= 2
    for (name, pool, pods), (status, res) in zip(members, outcomes):
        assert status == "ok", res
        assert res.all_pods_scheduled(), res.pod_errors
        alone = _port_sched(name, pool).solve(interop.from_reference(pods))
        assert _wire(to_reference(res)) == _wire(to_reference(alone)), name


def test_distinct_scheduler_instances_required():
    name, pool, pods = _members("one")[0]
    sched = _port_sched(name, pool)
    pods = interop.from_reference(pods)
    with pytest.raises(ValueError, match="distinct"):
        tprov.solve_batch([(sched, list(pods)), (sched, list(pods))])


class _JaxPoisoned(jprov.DeviceScheduler):
    def _class_steps(self, prep):
        raise RuntimeError("poisoned problem")


class _PortPoisoned(tprov.DeviceScheduler):
    def _class_steps(self, prep):
        raise RuntimeError("poisoned problem")


def test_poisoned_member_fails_alone():
    members = [(n, *_problem(n, 20)) for n in ("ia", "ix", "ib")]
    jax_cls = [jprov.DeviceScheduler, _JaxPoisoned, jprov.DeviceScheduler]
    port_cls = [tprov.DeviceScheduler, _PortPoisoned, tprov.DeviceScheduler]
    (j_out, j_stats), (p_out, p_stats) = _both(
        members, jax_cls=jax_cls, port_cls=port_cls)
    assert [s for s, _ in p_out] == ["ok", "error", "ok"]
    assert "poisoned problem" in repr(p_out[1][1])
    _assert_same_outcomes(j_out, p_out)
    assert p_stats == j_stats


def test_failed_batched_dispatch_retries_each_member_solo(monkeypatch):
    """A batched scan that raises is retried per member through the solo
    path inside the same call; every member still matches the JAX
    package's answer."""
    def broken(*args, **kwargs):
        raise RuntimeError("batched scan failed")

    monkeypatch.setattr(cuda_ffd, "cuda_ffd_solve_batched", broken)
    members = _members("mixed")
    (j_out, _), (p_out, p_stats) = _both(
        members, backends=["cuda"] * len(members))
    _assert_same_outcomes(j_out, p_out)
    assert p_stats["batched_dispatches"] == 0
    assert p_stats["dispatches"] == 1 + len(members)


STICKY = "CUDA error: an illegal memory access was encountered"


class _Spy:
    """Counts the calls of a kernel runner, and raises ``error`` from
    each when one is given."""

    def __init__(self, fn, error=None):
        self.fn, self.error, self.calls = fn, error, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.error is not None:
            raise self.error
        return self.fn(*args, **kwargs)


def _wide(name="pw"):
    """A member whose slot axis (128) no ``_members`` problem shares, so
    it dispatches in a group of its own."""
    pool, pods = _problem(name, 18)
    pools, its = interop.from_reference(([pool], {name: list(_catalog())}))
    return (tprov.DeviceScheduler(pools, its, max_slots=128, device="cpu",
                                  kernel_backend="cuda"),
            interop.from_reference(pods))


def _port_entries(members, backend="cuda"):
    return [(_port_sched(n, pool, backend), interop.from_reference(pods))
            for n, pool, pods in members]


@pytest.mark.parametrize("error", ["sticky", "plain"])
def test_failed_batched_dispatch_reruns_solo_unless_sticky(monkeypatch,
                                                           error):
    """A batched dispatch that raises: a plain error re-runs each member
    solo, with the JAX package's outcomes; a sticky CUDA error poisoned
    the context, so it reaches every member of the group with no solo
    re-run. A spy counts the solo dispatches."""
    exc = RuntimeError(STICKY if error == "sticky" else "batched failed")
    monkeypatch.setattr(cuda_ffd, "cuda_ffd_solve_batched",
                        _Spy(None, exc))
    solo = _Spy(tprov._run_kernel_solo)
    monkeypatch.setattr(tprov, "_run_kernel_solo", solo)
    members = _members("mixed")
    (j_out, _), (p_out, p_stats) = _both(
        members, backends=["cuda"] * len(members))
    if error == "plain":
        _assert_same_outcomes(j_out, p_out)
        assert solo.calls == len(members)
        assert all(s == "ok" for s, _ in p_out)
        return
    assert solo.calls == 0
    assert p_stats["dispatches"] == 1 and p_stats["batched_dispatches"] == 0
    assert [s for s, _ in p_out] == ["error"] * len(members)
    assert all(str(e) == STICKY for _, e in p_out)


@pytest.mark.parametrize("first", ["batched", "solo"])
def test_sticky_error_stops_every_later_launch(monkeypatch, first):
    """Once a call has seen a sticky CUDA error, the problems still
    pending in it get that error in place of a launch: the group of
    another shape that would dispatch after it launches nothing."""
    exc = RuntimeError(STICKY)
    solo = _Spy(tprov._run_kernel_solo, exc if first == "solo" else None)
    batched = _Spy(tprov._run_kernel_batched,
                   exc if first == "batched" else None)
    monkeypatch.setattr(tprov, "_run_kernel_solo", solo)
    monkeypatch.setattr(tprov, "_run_kernel_batched", batched)
    group = _port_entries(_members("mixed"))
    entries = group + [_wide()] if first == "batched" else [_wide()] + group
    outcomes, stats = tprov.solve_batch(entries)
    assert (solo.calls, batched.calls) == (
        (0, 1) if first == "batched" else (1, 0))
    assert stats["dispatches"] == 1
    assert [s for s, _ in outcomes] == ["error"] * len(entries)
    assert all(e is exc for _, e in outcomes)


def test_cuda_and_reference_members_never_coalesce():
    """Two "cuda" and two "reference" problems of identical shapes split
    into two batched dispatches, and every member's wire still equals the
    JAX package's."""
    members = [(n, *_problem(n, 20)) for n in ("bca", "bcb", "bra", "brb")]
    (j_out, j_stats), (p_out, p_stats) = _both(
        members, backends=["cuda", "cuda", "reference", "reference"])
    assert j_stats["batched_dispatches"] == 1
    assert p_stats["batched_dispatches"] == 2
    assert p_stats["batched_problems"] == 4
    _assert_same_outcomes(j_out, p_out)


def _port_request(backend="cuda"):
    name, pool, pods = _members("one")[0]
    gen = _port_sched(name, pool, backend)._solve_gen(
        interop.from_reference(pods))
    req = gen.send(None)
    gen.close()
    return req


def test_shape_key_splits_on_backend_and_device():
    req = _port_request()
    assert req.shape_key() == _port_request().shape_key()
    assert (dataclasses.replace(req, backend="reference").shape_key()
            != req.shape_key())
    meta = dataclasses.replace(
        req, init_state=tffd.SlotState(*(x.to("meta")
                                          for x in req.init_state)))
    assert meta.shape_key() != req.shape_key()
    assert req.kind == "solve" and req.mode == "ffd" and req.devices == 1


@pytest.mark.parametrize("change,item", [
    pytest.param(dict(devices=2), "A.13", id="change2-A.13"),
])
def test_later_dispatch_kinds_raise(change, item):
    """Every dispatch kind the JAX package runs is answered: a request for
    two devices (ROADMAP ``item``, once refused) runs on a 2-device
    virtual CPU mesh, the batched scan split one problem a device and the
    solo scan on the lead device, and answers as on one device."""
    from karpenter_core_tpu_torch.parallel import mesh as pmesh

    base = _port_request()
    req = dataclasses.replace(base, **change)
    want_b, pad_b = tprov._run_kernel_batched([base, base])
    want_s = tprov._run_kernel_solo(base)
    pmesh.force_virtual_mesh(2, "cpu")
    try:
        got_b, pad = tprov._run_kernel_batched([req, req])
        got_s = tprov._run_kernel_solo(req)
    finally:
        pmesh.force_virtual_mesh(0, "cpu")
    assert pad == pad_b == 2
    for got, want in zip(got_b + [got_s], want_b + [want_s]):
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a, b)
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


# ---------------------------------------------------------------------------
# the batched kernel wrapper


def _wrapper_inputs():
    reqs = _jax_requests(MIXED)
    reqs = reqs + [reqs[0]]  # a pad row, as _run_kernel_batched makes
    init, steps, statics, _ = _port_inputs(reqs)
    return init, steps, statics, reqs[0].level_iters


def test_batched_wrapper_takes_plain_version_on_cpu():
    init, steps, statics, li = _wrapper_inputs()
    launches, rows = dict(cuda_ffd.counter.launches), cuda_ffd.counter.rows
    k = cuda_ffd.cuda_ffd_solve_batched(init, steps, statics, li)
    p = tffd.ffd_solve_batched(init, steps, statics, li)
    assert cuda_ffd.counter.launches == launches
    assert cuda_ffd.counter.rows == rows
    for a, b in zip(list(k[0]) + [k[1], k[2]], list(p[0]) + [p[1], p[2]]):
        assert torch.equal(a, b)


def test_batched_wrapper_rejects_other_devices():
    init, steps, statics, li = _wrapper_inputs()
    meta = tffd.SlotState(*(x.to("meta") for x in init))
    with pytest.raises(ValueError, match="device"):
        cuda_ffd.cuda_ffd_solve_batched(meta, steps, statics, li)


def _no_plain(*args, **kwargs):
    raise AssertionError("the card path ran the plain version")


def _forbid_plain(monkeypatch):
    for name in ("ffd_solve", "ffd_solve_batched", "ffd_step"):
        monkeypatch.setattr(cuda_ffd.ffd_ops, name, _no_plain)


def test_batched_card_path_with_no_steps_launches_nothing(monkeypatch):
    init, steps, statics, li = _wrapper_inputs()
    empty = type(steps)(*(None if x is None else x[:, :0] for x in steps))
    _forbid_plain(monkeypatch)
    monkeypatch.setattr(cuda_ffd, "build", _no_plain)
    launches, rows = dict(cuda_ffd.counter.launches), cuda_ffd.counter.rows
    state, takes, unplaced = cuda_ffd._launch_batched(init, empty, statics,
                                                      li)
    B, N = init.kind.shape
    assert takes.shape == (B, 0, N) and takes.dtype == torch.int32
    assert unplaced.shape == (B, 0) and unplaced.dtype == torch.int32
    assert state is init
    assert cuda_ffd.counter.launches == launches
    assert cuda_ffd.counter.rows == rows


def test_batched_card_path_needs_rows(monkeypatch):
    init, steps, statics, li = _wrapper_inputs()
    monkeypatch.setattr(cuda_ffd, "build", _no_plain)
    empty = [type(t)(*(None if x is None else x[:0] for x in t))
             for t in (init, steps, statics)]
    with pytest.raises(ValueError, match="problem rows"):
        cuda_ffd._launch_batched(*empty, li)


class _FakeLib:
    """The kernel library's C surface, recording each scan it launches."""

    BLOCKS = 132

    def __init__(self):
        self.calls = []

    def ffd_scan(self, args_ref, max_blocks, stream, blocks_ref):
        args = args_ref._obj
        n = args.B * args.N * args.K * args.V // 8
        self.packed = torch.frombuffer(
            (ctypes.c_uint8 * n).from_address(args.valmask),
            dtype=torch.uint8).clone()
        self.calls.append(dict(B=args.B, J=args.J, valmask=args.valmask,
                               takes=args.takes, stamps=args.stamps,
                               max_blocks=max_blocks))
        blocks_ref._obj.value = (min(max_blocks, self.BLOCKS) if max_blocks
                                 else self.BLOCKS)
        return 0

    @staticmethod
    def ffd_scan_smem(N, K, V, Gz):
        return 0

    @staticmethod
    def ffd_error_string(rc):
        return b"fake"


def _fake_card(monkeypatch):
    lib = _FakeLib()
    _forbid_plain(monkeypatch)
    monkeypatch.setattr(cuda_ffd, "build", lambda: lib)
    monkeypatch.setattr(cuda_ffd, "_device_stream",
                        lambda dev: contextlib.nullcontext(None))
    cuda_ffd.counter.reset()
    return lib


def test_batched_card_path_launches_each_kernel_once_per_step(monkeypatch):
    """With the library mocked, one batched scan of B problems and J steps
    is one C call and one launch of the scan kernel, which walks all J
    steps itself (not J launches, nor J x B); it counts B rows and the
    grid, hands the kernel the stacked tensors (the requirement plane as
    its packed copy, ``pack_values``), and never runs the plain version."""
    init, steps, statics, li = _wrapper_inputs()
    B, J = steps.count.shape
    lib = _fake_card(monkeypatch)
    _, takes, unplaced = cuda_ffd._launch_batched(init, steps, statics, li)
    assert cuda_ffd.counter.launches == dict.fromkeys(cuda_ffd.KERNELS, 1)
    assert cuda_ffd.counter.prefix_launches == 0
    assert cuda_ffd.counter.rows == B == 4
    assert cuda_ffd.counter.blocks == _FakeLib.BLOCKS
    (call,) = lib.calls
    assert call["valmask"] != init.valmask.data_ptr()
    assert torch.equal(lib.packed,
                       cuda_ffd.pack_values(init.valmask).reshape(-1))
    assert call == dict(B=B, J=J, valmask=call["valmask"],
                        takes=takes.data_ptr(), stamps=None, max_blocks=0)
    assert takes.shape == (B, J, init.kind.shape[1])
    assert unplaced.shape == (B, J)
    cuda_ffd.counter.reset()


def test_solo_card_path_is_the_batched_kernel_at_one_row(monkeypatch):
    init, steps, statics, li = _wrapper_inputs()
    row = [tffd._row(t, 0) for t in (init, steps, statics)]
    J = row[1].count.shape[0]
    lib = _fake_card(monkeypatch)
    state, takes, unplaced = cuda_ffd._launch(*row, li)
    assert cuda_ffd.counter.launches == dict.fromkeys(cuda_ffd.KERNELS, 1)
    assert cuda_ffd.counter.rows == 1
    assert [(c["B"], c["J"]) for c in lib.calls] == [(1, J)]
    assert takes.shape == (J, row[0].kind.shape[0]) and unplaced.shape == (J,)
    for a, b in zip(state, row[0]):  # a copy, untouched by the fake
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    cuda_ffd.counter.reset()


def test_card_path_passes_grid_cap_and_stamps(monkeypatch):
    """The private grid cap and the [J, 5] int64 stamp buffer reach the C
    entry (the buffer's address; null when absent); a buffer of another
    shape is refused before any launch."""
    init, steps, statics, li = _wrapper_inputs()
    B, J = steps.count.shape
    lib = _fake_card(monkeypatch)
    stamps = torch.zeros((J, 5), dtype=torch.int64)
    cuda_ffd._launch_batched(init, steps, statics, li, 2, stamps)
    assert lib.calls[-1]["max_blocks"] == 2
    assert lib.calls[-1]["stamps"] == stamps.data_ptr()
    assert cuda_ffd.counter.blocks == 2
    with pytest.raises(ValueError, match="stamps"):
        cuda_ffd._launch_batched(init, steps, statics, li, 0,
                                 torch.zeros((J, 4), dtype=torch.int64))
    assert len(lib.calls) == 1
    assert cuda_ffd.counter.launches == dict.fromkeys(cuda_ffd.KERNELS, 1)
    cuda_ffd.counter.reset()


def test_card_path_scratch_starts_as_the_kernel_expects(monkeypatch):
    """The kernel sets the hostname flags and the open bound only upward
    and combines its type parts by atomicMax, so the wrapper hands it those
    planes zeroed (flags, open bound) and at -1 (best counts)."""
    init, steps, statics, li = _wrapper_inputs()
    B, N = init.kind.shape
    lib = _fake_card(monkeypatch)
    seen = {}

    def scan(args_ref, max_blocks, stream, blocks_ref):
        args = args_ref._obj
        for name, n, dt in (("hflag", B * init.hcount.shape[2], torch.uint8),
                            ("open", 1, torch.int32),
                            ("kv", B * N, torch.int32)):
            addr = getattr(args, name)
            seen[name] = torch.frombuffer(
                (ctypes.c_byte * (n * dt.itemsize)).from_address(addr),
                dtype=dt).clone()
        blocks_ref._obj.value = 1
        return 0

    monkeypatch.setattr(lib, "ffd_scan", scan)
    cuda_ffd._launch_batched(init, steps, statics, li)
    assert not seen["hflag"].any() and not seen["open"].any()
    assert bool((seen["kv"] == -1).all())
    cuda_ffd.counter.reset()


def test_batched_wrapper_calls_plain_version_only_for_cpu_tensors():
    """In ops/cuda_ffd.py the plain batched scan is reached from one place:
    the ``dev.type == "cpu"`` branch of ``cuda_ffd_solve_batched``."""
    tree = ast.parse(Path(cuda_ffd.__file__).read_text())
    uses = [n for n in ast.walk(tree)
            if isinstance(n, ast.Attribute) and n.attr == "ffd_solve_batched"]
    assert len(uses) == 1
    (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef)
             and n.name == "cuda_ffd_solve_batched"]
    cpu_branch = [n for n in ast.walk(fn) if isinstance(n, ast.If)
                  and "cpu" in ast.unparse(n.test)]
    assert len(cpu_branch) == 1
    assert uses[0] in list(ast.walk(cpu_branch[0]))


def test_args_struct_matches_the_kernel_source():
    """The C struct FfdArgs and the wrapper's ctypes mirror list the same
    fields in the same order (ffd_args_size() checks the sizes on the
    card)."""
    src = cuda_ffd.SOURCE.read_text()
    body = re.search(r"struct FfdArgs \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names, pointers = [], 0
    for stmt in filter(None, (s.strip() for s in body.split(";"))):
        pointers += "*" in stmt
        decl = re.sub(r"^(?:const\s+)?\w+\s*\*?\s*", "", stmt)
        names += [n.strip() for n in decl.split(",")]
    assert names == list(cuda_ffd._POINTERS + cuda_ffd._DIMS)
    assert pointers == len(cuda_ffd._POINTERS)
    assert len(cuda_ffd._DIMS) % 2 == 0  # no tail padding to disagree on


def test_problem_axis_is_in_every_grid():
    """One launch serves every problem: the per-problem stages take problem
    b on block b mod gridDim.x, and the slot stages take (problem, slot,
    part) items in a grid-stride loop, so B x N may exceed the grid (with
    many items a warp, the merge's warps test 32 of their items at a time
    and merge those whose slot joined)."""
    src = cuda_ffd.SOURCE.read_text()
    assert src.count("for (int b = blockIdx.x; b < B; b += G) {") == 2
    assert "prologue(problem(args, b), j, region);" in src
    assert "decide(problem(args, b), j, red, region);" in src
    assert src.count("for (long long i = rank; i < slots * parts; i += warps)") == 2
    assert src.count(
        "for (long long i = rank; i < slots * parts; i += 32 * warps)") == 1
    for stage in ("feasible", "merge"):
        assert (f"{stage}(problem(args, (int)(sl / open)), j, (int)(sl % open),"
                in src)
    assert "cg::this_grid()" in src and src.count("grid.sync();") == 5
