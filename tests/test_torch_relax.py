"""The port's relax backend against the JAX package's.

* The ops of ``ops/relax.py`` on the same seeded numpy inputs:
  ``relax_viability``'s four planes exactly; ``relax_choose[_batched]``'s
  integral outputs (new_template, kstar, changed) exactly and its float
  iterates to a relative 1e-5 (XLA may fuse ``g + mu * x`` into one
  rounding where torch rounds twice); ``relax_score`` exactly. One case
  holds the left-to-right cumulative sum of the simplex projection: its
  rows' sums differ from a float64-accumulated (``torch.cumsum`` on the
  CPU) sum in the last bit.
* Solves: the port's ``DeviceScheduler(solver_mode="relax")`` (CPU, plain
  scan) against the JAX package's on the in-process cases of
  tests/test_relaxsolve.py — byte-identical result wires
  (``codec.encode_solve_results``, solve_seconds 0.0), the same outcome
  and the same ``last_phase_stats["relax"]``, solo and through
  ``solve_batch``.
* Routing: the candidate scan goes through the CUDA route's wrapper (which
  takes the plain scan for CPU tensors) with the rounded override on its
  steps; a cached verdict makes a warm solve one dispatch; ``device=
  "cuda"`` raises without a GPU.
"""
from __future__ import annotations

import copy
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import make_nodepool
from tests.test_fuzz_parity import fuzz_scenario
from tests.test_relaxsolve import (
    _gang_tier_pods,
    _pods,
    _topology_pods,
    two_pool_world,
)
from tests.test_torch_ffd import _bits
from tests.test_torch_provisioner import _align_hostnames, to_reference
from tests.torch_threads import one_torch_thread  # noqa: F401

from karpenter_core_tpu.cloudprovider.kwok import build_catalog
from karpenter_core_tpu.models import provisioner as jprov
from karpenter_core_tpu.ops import ffd as jffd
from karpenter_core_tpu.ops import relax as jrelax
from karpenter_core_tpu.solver import codec
from karpenter_core_tpu_torch import interop
from karpenter_core_tpu_torch.metrics import wiring as port_metrics
from karpenter_core_tpu_torch.models import provisioner as tprov
from karpenter_core_tpu_torch.operator import Options
from karpenter_core_tpu_torch.ops import cuda_ffd
from karpenter_core_tpu_torch.ops import ffd as tffd
from karpenter_core_tpu_torch.ops import relax as trelax

ITERATE_RTOL = 1e-5
ITERATE_ATOL = 1e-7


def assert_equal(port, ref, what):
    p = np.asarray(port.numpy() if isinstance(port, torch.Tensor) else port)
    r = np.asarray(ref)
    assert p.dtype == r.dtype, (what, p.dtype, r.dtype)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    assert np.array_equal(_bits(p), _bits(r)), what


def _t(*arrays):
    return [None if a is None else torch.tensor(np.asarray(a))
            for a in arrays]


# ---------------------------------------------------------------------------
# the ops


def viability_inputs(seed, C=16, S=8, T=32, Z=3, CT=2, R=3):
    rng = np.random.default_rng(seed)
    return (
        rng.random((C, T)) < 0.7,  # class_it
        rng.random((C, S)) < 0.7,  # tmpl_ok
        rng.random((S, T)) < 0.6,  # tmpl_it
        rng.random((C, Z)) < 0.8,
        rng.random((C, CT)) < 0.8,
        rng.random((S, Z)) < 0.8,
        rng.random((S, CT)) < 0.9,
        rng.random((T, Z, CT)) < 0.7,  # off_avail
        rng.integers(1, 64, (T, R)).astype(np.float32),  # it_alloc
        rng.integers(0, 2, (S, R)).astype(np.float32),  # tmpl_overhead
        rng.integers(0, 5, (C, R)).astype(np.float32),  # class_requests
        (rng.random(T) * 3).astype(np.float32),  # it_price
        np.where(rng.random(C) < 0.3, 2, 2**31 - 1).astype(np.int32),
    )


@pytest.mark.parametrize("seed", range(4))
def test_relax_viability_equal(seed):
    args = viability_inputs(seed)
    ref = jrelax.relax_viability(*args)
    port = trelax.relax_viability(*_t(*args))
    for name, p, r in zip(("viable", "k_cs", "k_node", "podcost"), port,
                          ref):
        assert_equal(p, r, name)


def choose_inputs(seed, num_gangs, topo, C=16, S=8):
    viable, k_cs, k_node, podcost = (
        np.asarray(x) for x in jrelax.relax_viability(
            *viability_inputs(seed, C=C, S=S)))
    rng = np.random.default_rng(100 + seed)
    counts = rng.integers(0, 30, C).astype(np.float32)
    gang_id = np.full(C, -1, np.int32)
    if num_gangs:
        gang_id = rng.integers(-1, num_gangs, C).astype(np.int32)
        gang_id[:num_gangs] = np.arange(num_gangs)  # every gang non-empty
    base_t = rng.integers(-1, S, C).astype(np.int32)
    base_k = rng.integers(0, 9, C).astype(np.int32)
    warm = np.where(rng.random(C) < 0.3, rng.integers(0, S, C),
                    -1).astype(np.int32)
    tc = (rng.random((C, S)) * 3).astype(np.float32) if topo else None
    return (viable, k_cs, k_node, podcost, counts, gang_id, base_t, base_k,
            warm, tc)


CHOOSE_CASES = [(s, g, t) for s in range(3) for g in (0, 3)
                for t in (False, True)]


@pytest.mark.parametrize("seed,num_gangs,topo", CHOOSE_CASES)
def test_relax_choose_integral_outputs_equal(seed, num_gangs, topo):
    args = choose_inputs(seed, num_gangs, topo)
    ref = jrelax.relax_choose(*args, iters=jrelax.DEFAULT_ITERS,
                              num_gangs=num_gangs)
    port = trelax.relax_choose(*_t(*args), iters=trelax.DEFAULT_ITERS,
                               num_gangs=num_gangs)
    for name, p, r in zip(("new_template", "kstar", "changed"), port, ref):
        assert_equal(p, r, name)


@partial(jax.jit, static_argnames=("iters", "num_gangs"))
def _jax_iterates(viable, k_node, podcost, counts, gang_id, warm_template,
                  topo_cost, iters, num_gangs):
    """The JAX package's projected-gradient loop (the head of its
    ``_relax_choose_impl``), returning the iterates it rounds."""
    vf = viable.astype(jnp.float32)
    uniform = vf / jnp.maximum(jnp.sum(vf, axis=1, keepdims=True), 1.0)
    S = viable.shape[1]
    wt = jnp.clip(warm_template, 0)
    warm_viable = (warm_template >= 0) & jnp.take_along_axis(
        viable, wt[:, None], axis=1)[:, 0]
    x0 = jnp.where(warm_viable[:, None],
                   jax.nn.one_hot(wt, S, dtype=jnp.float32), uniform)
    cost = jnp.where(viable, counts[:, None] * podcost, 0.0)
    cost = cost / jnp.maximum(jnp.max(jnp.abs(cost)), 1e-6)
    nodeshare = jnp.where(
        viable,
        counts[:, None] / jnp.maximum(k_node.astype(jnp.float32), 1.0), 0.0)
    nodeshare = nodeshare / jnp.maximum(jnp.max(nodeshare), 1e-6)
    g = cost + jrelax._NODE_WEIGHT * nodeshare
    if topo_cost is not None:
        tc = jnp.where(viable, topo_cost, 0.0)
        g = g + jrelax._TOPO_WEIGHT * (tc / jnp.maximum(jnp.max(tc), 1e-6))

    def body(_, x):
        y = x - jrelax._ETA * (g + jrelax._MU * x)
        y = jrelax._gang_consensus(y, gang_id, num_gangs)
        return jrelax._project_rows(y, viable)

    return jax.lax.fori_loop(0, iters, body, x0)


@pytest.mark.parametrize("seed,num_gangs,topo", CHOOSE_CASES)
def test_relax_iterates_within_tolerance(seed, num_gangs, topo):
    (viable, _k_cs, k_node, podcost, counts, gang_id, _bt, _bk, warm,
     tc) = choose_inputs(seed, num_gangs, topo)
    ref = np.asarray(_jax_iterates(viable, k_node, podcost, counts, gang_id,
                                   warm, tc, iters=jrelax.DEFAULT_ITERS,
                                   num_gangs=num_gangs))
    port = trelax._relax_iterates(
        *(None if a is None else a.unsqueeze(0)
          for a in _t(viable, k_node, podcost, counts, gang_id, warm, tc)),
        iters=trelax.DEFAULT_ITERS, num_gangs=num_gangs)[0].numpy()
    np.testing.assert_allclose(port, ref, rtol=ITERATE_RTOL,
                               atol=ITERATE_ATOL)


def test_relax_choose_batched_equal_and_rows_equal_solo():
    rows = [choose_inputs(s, 3, True) for s in range(3)]
    stacked = [np.stack([r[i] for r in rows]) for i in range(10)]
    ref = jrelax.relax_choose_batched(*stacked, iters=jrelax.DEFAULT_ITERS,
                                      num_gangs=3)
    port = trelax.relax_choose_batched(*_t(*stacked),
                                       iters=trelax.DEFAULT_ITERS,
                                       num_gangs=3)
    for name, p, r in zip(("new_template", "kstar", "changed"), port, ref):
        assert_equal(p, r, name)
    for b, row in enumerate(rows):
        solo = trelax.relax_choose(*_t(*row), iters=trelax.DEFAULT_ITERS,
                                   num_gangs=3)
        for p, s in zip(port, solo):
            assert torch.equal(p[b], s)


def test_project_rows_sums_left_to_right():
    """Rows whose cumulative sums differ from a float64-accumulated one in
    the last bit: the projection must equal XLA's bit for bit, and a
    ``torch.cumsum`` version (double accumulation on the CPU) must not."""
    rng = np.random.default_rng(7)
    rows = []
    while len(rows) < 4:
        y = (rng.random(8) * 0.3).astype(np.float32)
        u = np.sort(y)[::-1]
        seq = np.empty_like(u)
        acc = np.float32(0.0)
        for j, v in enumerate(u):
            acc = np.float32(acc + v)
            seq[j] = acc
        if not np.array_equal(seq, np.cumsum(u.astype(np.float64))
                              .astype(np.float32)):
            rows.append(y)
    y = np.stack(rows)
    viable = np.ones_like(y, dtype=bool)
    ref = np.asarray(jrelax._project_rows(jnp.asarray(y),
                                          jnp.asarray(viable)))
    port = trelax._project_rows(torch.tensor(y), torch.tensor(viable))
    assert_equal(port, ref, "projection")
    # the discriminating half: a double-accumulated cumsum moves the bits
    yt = torch.tensor(y)
    u = torch.sort(yt, dim=-1, descending=True).values
    css = torch.cumsum(u.double(), dim=-1).float()
    jj = torch.arange(1, 9, dtype=torch.float32)
    rho = (((u + (1.0 - css) / jj) > 0).sum(-1)).clamp(min=1)
    tau = (css.gather(-1, (rho - 1)[:, None])[:, 0] - 1.0) / rho.float()
    other = torch.clamp(yt - tau[:, None], min=0.0)
    assert not np.array_equal(_bits(other.numpy()), _bits(ref))


def test_relax_score_equal():
    rng = np.random.default_rng(3)
    N, S = 64, 8
    kind = rng.integers(0, 3, N).astype(np.int8)
    podcount = rng.integers(0, 4, N).astype(np.int32)
    template = rng.integers(-1, S, N).astype(np.int32)
    tmpl_price = (rng.random(S) * 5).astype(np.float32)
    unplaced = rng.integers(0, 3, 16).astype(np.int32)
    fields = {f: np.zeros((1,), np.int32) for f in jffd.SlotState._fields}
    fields.update(kind=kind, podcount=podcount, template=template)
    ref = jrelax.relax_score(jffd.SlotState(**fields), tmpl_price, unplaced)
    port = trelax.relax_score(
        tffd.SlotState(**{k: torch.tensor(v) for k, v in fields.items()}),
        torch.tensor(tmpl_price), torch.tensor(unplaced))
    assert int(port[0]) == int(ref[0]) and int(port[1]) == int(ref[1])
    assert port[2].dtype == torch.float32
    assert float(port[2]) == pytest.approx(float(ref[2]), rel=1e-6)


# ---------------------------------------------------------------------------
# solves against the JAX package


def _pair(pools, its, existing=(), **kw):
    port_in = interop.from_reference((pools, its, list(existing)))
    ref = jprov.DeviceScheduler(copy.deepcopy(pools), its,
                                existing_nodes=copy.deepcopy(list(existing)),
                                **kw)
    port = tprov.DeviceScheduler(port_in[0], port_in[1],
                                 existing_nodes=port_in[2], device="cpu",
                                 kernel_backend="reference", **kw)
    return ref, port


def solve_pair(ref, port, pods):
    """One solve on each scheduler, wires compared byte for byte."""
    rejected0 = dict(port_metrics.SOLVER_RESULT_REJECTED.values)
    _align_hostnames()
    r_ref = ref.solve(copy.deepcopy(pods))
    r_port = port.solve(interop.from_reference(pods))
    w_ref = codec.encode_solve_results(r_ref, 0.0)
    assert codec.encode_solve_results(to_reference(r_port), 0.0) == w_ref
    assert dict(port_metrics.SOLVER_RESULT_REJECTED.values) == rejected0
    st_ref, st_port = ref.last_phase_stats, port.last_phase_stats
    assert st_port.get("relax") == st_ref.get("relax")
    for k in ("rounds", "slots", "used_slots", "solver_mode"):
        assert st_port[k] == st_ref[k], k
    return r_ref, r_port


def test_relax_strictly_beats_ffd_on_two_pool_problem():
    pools, its = two_pool_world()
    pods = _pods(64)
    _, res_f = solve_pair(*_pair(pools, its, max_slots=256), pods)
    ref, port = _pair(pools, its, max_slots=256, solver_mode="relax")
    _, res_r = solve_pair(ref, port, pods)
    assert res_r.node_count() < res_f.node_count()
    assert port.last_phase_stats["relax"]["outcome"] == "won"
    assert port.last_phase_stats["solver_mode"] == "relax"


def test_relax_verdict_cache_warm_solves_dispatch_once():
    pools, its = two_pool_world()
    pods = _pods(48)
    ref, port = _pair(pools, its, max_slots=256, solver_mode="relax")
    for _ in range(3):
        solve_pair(ref, port, pods)
    assert port.last_phase_stats["relax"]["outcome"] == "cached_won"
    assert port.last_phase_stats["relax"]["cached"] is True


def test_relax_noop_on_single_template_matches_ffd_exactly():
    catalog = build_catalog(cpu_grid=[2, 4, 8], mem_factors=[4],
                            oses=["linux"], arches=["amd64"])
    pools, its = [make_nodepool()], {"default": catalog}
    pods = _pods(40)
    ref, port = _pair(pools, its, max_slots=128, solver_mode="relax")
    solve_pair(ref, port, pods)
    assert port.last_phase_stats["relax"]["outcome"] == "noop"


def test_relax_deadline_serves_the_ffd_answer():
    pools, its = two_pool_world()
    pods = _pods(48)
    ref, port = _pair(pools, its, max_slots=256, solver_mode="relax",
                      relax_budget_s=0.0)
    solve_pair(ref, port, pods)
    assert port.last_phase_stats["relax"]["outcome"] == "deadline"
    ref.relax_budget_s = port.relax_budget_s = None
    solve_pair(ref, port, pods)
    assert port.last_phase_stats["relax"]["outcome"] == "won"


@pytest.mark.parametrize("seed", range(14))
def test_relax_fuzz_seed_wire_identical(seed):
    pods, existing, pools, its = fuzz_scenario(seed)
    solve_pair(*_pair(pools, its, existing, max_slots=128,
                      solver_mode="relax"), pods)


@pytest.mark.parametrize("problem", ["topology", "tier_and_gang"])
def test_relax_constraint_problems_wire_identical(problem):
    pools, its = two_pool_world()
    pods = (_topology_pods(36) if problem == "topology"
            else _gang_tier_pods())
    ref, port = _pair(pools, its, max_slots=256, solver_mode="relax")
    _, res = solve_pair(ref, port, pods)
    assert res.all_pods_scheduled()


def test_kernel_request_shape_key_carries_mode():
    pools, its = two_pool_world()
    _, port = _pair(pools, its, max_slots=256)
    gen = port._solve_gen(interop.from_reference(_pods(8)))
    req = gen.send(None)
    gen.close()
    relax = dataclasses.replace(req, mode="relax")
    assert req.shape_key() != relax.shape_key()
    assert req.shape_key() == dataclasses.replace(req).shape_key()


def _batch_both(modes, pods):
    pools, its = two_pool_world()
    scheds = [_pair(pools, its, max_slots=256, solver_mode=m)
              for m in modes]
    _align_hostnames()
    ref_out, ref_stats = jprov.solve_batch(
        [(r, copy.deepcopy(pods)) for r, _ in scheds])
    _align_hostnames()
    port_out, port_stats = tprov.solve_batch(
        [(p, interop.from_reference(pods)) for _, p in scheds])
    assert port_stats == ref_stats
    for (st_r, r), (st_p, p) in zip(ref_out, port_out):
        assert st_r == st_p == "ok"
        assert (codec.encode_solve_results(to_reference(p), 0.0)
                == codec.encode_solve_results(r, 0.0))
    for r, p in scheds:
        assert p.last_phase_stats.get("relax") == r.last_phase_stats.get(
            "relax")
    return port_out, port_stats


def test_mixed_mode_solve_batch_never_shares_a_batched_dispatch():
    _, stats = _batch_both(("ffd", "ffd"), _pods(32))
    assert stats["batched_dispatches"] >= 1
    out, stats = _batch_both(("ffd", "relax"), _pods(32))
    assert stats["batched_dispatches"] == 0
    assert out[1][1].node_count() < out[0][1].node_count()


def test_two_relax_problems_coalesce_their_dispatches():
    out, stats = _batch_both(("relax", "relax"), _pods(32))
    assert stats["batched_dispatches"] >= 2  # solve + relax rounds
    assert out[0][1].node_count() == out[1][1].node_count()


def test_operator_solver_backend_flag():
    opts = Options.parse(["--solver-backend", "relax"])
    assert opts.solver_backend == "relax"
    assert Options.parse([]).solver_backend == "ffd"
    with pytest.raises(ValueError, match="unknown solver backend"):
        Options.parse(["--solver-backend", "zzz"])


def test_device_scheduler_rejects_unknown_mode():
    pools, its = interop.from_reference(two_pool_world())
    with pytest.raises(ValueError, match="unknown solver mode"):
        tprov.DeviceScheduler(pools, its, solver_mode="zzz", device="cpu")


# ---------------------------------------------------------------------------
# routing: the candidate scan through the CUDA route's wrapper


@pytest.fixture
def counted_scans(monkeypatch):
    """Stand the CUDA route's solo and batched wrappers in with counting
    ones (the plain scan for CPU tensors, as the wrappers themselves do),
    recording each scan's override planes."""
    calls = {"solo": [], "batched": []}
    solo, batched = cuda_ffd.cuda_ffd_solve, cuda_ffd.cuda_ffd_solve_batched

    def count_solo(state, steps, statics, **kw):
        calls["solo"].append((steps.new_template.clone(),
                              steps.kstar.clone()))
        return solo(state, steps, statics, **kw)

    def count_batched(state, steps, statics, **kw):
        calls["batched"].append(steps.new_template.clone())
        return batched(state, steps, statics, **kw)

    monkeypatch.setattr(cuda_ffd, "cuda_ffd_solve", count_solo)
    monkeypatch.setattr(cuda_ffd, "cuda_ffd_solve_batched", count_batched)
    return calls


def test_candidate_scan_rides_the_cuda_route(counted_scans):
    """Cold: the baseline and the candidate (with the rounded override)
    both go through the CUDA route, which launches nothing for CPU
    tensors; the settle solve re-evaluates; then a cached verdict makes a
    warm solve one scan that already carries the override. The wires
    equal the plain-scan scheduler's."""
    pools, its = two_pool_world()
    pods = _pods(48)
    port_in = interop.from_reference((pools, its))
    cuda = tprov.DeviceScheduler(*port_in, max_slots=256, device="cpu",
                                 solver_mode="relax", kernel_backend="cuda")
    ref, plain = _pair(pools, its, max_slots=256, solver_mode="relax")
    before = dict(cuda_ffd.counter.launches)
    scans = []
    for _ in range(3):
        _align_hostnames()
        w_cuda = codec.encode_solve_results(
            to_reference(cuda.solve(interop.from_reference(pods))), 0.0)
        _align_hostnames()
        w_plain = codec.encode_solve_results(
            to_reference(plain.solve(interop.from_reference(pods))), 0.0)
        assert w_cuda == w_plain
        scans.append(len(counted_scans["solo"]))
        assert cuda.last_phase_stats["relax"] == (
            plain.last_phase_stats["relax"])
    assert scans == [2, 4, 5]
    (base_nt, _), (cand_nt, _) = counted_scans["solo"][:2]
    assert not torch.equal(base_nt, cand_nt)
    assert torch.equal(counted_scans["solo"][-1][0], cand_nt)
    assert cuda_ffd.counter.launches == before


def test_batched_candidate_scan_rides_the_cuda_route(counted_scans):
    pools, its = two_pool_world()
    pods = _pods(32)
    port_in = interop.from_reference((pools, its))
    scheds = [tprov.DeviceScheduler(*interop.from_reference(port_in),
                                    max_slots=256, device="cpu",
                                    solver_mode="relax",
                                    kernel_backend="cuda")
              for _ in range(2)]
    out, stats = tprov.solve_batch(
        [(s, interop.from_reference(pods)) for s in scheds])
    assert all(st == "ok" for st, _ in out)
    # baseline and candidate, each one batched scan of the two problems
    assert len(counted_scans["batched"]) == 2
    assert stats["batched_dispatches"] == 3  # + the batched relax_choose
    assert counted_scans["solo"] == []


def test_relax_scheduler_needs_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default resolves")
    pools, its = interop.from_reference(two_pool_world())
    with pytest.raises(RuntimeError, match="cuda"):
        tprov.DeviceScheduler(pools, its, solver_mode="relax")
