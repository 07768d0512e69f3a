"""The port's gangs, priority tiers and preemption against the JAX package.

* Units, on the same seeded numpy inputs, with exact equality (the scan
  is integer-exact float32; the preemption pass's float carry must match
  bit for bit): ``ops/masks.gang_joint_templates``; the gang-atomic solve
  (first scan committing, a rollback, and a rollback whose second scan
  fails another gang — the cascade guard — driven by one scan stand-in
  written in both frameworks) and its batched twin; the preemption pass
  and its batched twin, on the JAX package's own preempt requests and on
  seeded evictable planes with costs that no float32 holds exactly.
* Solves: the port's ``DeviceScheduler`` (CPU, plain scan) against the
  JAX package's on the cases of tests/test_gangsched.py — off-by-default
  parity, preemption (all but the sharded mesh), gang atomicity, the two
  ``solve_batch`` seams, the degraded host path — with byte-identical
  result wires (``codec.encode_solve_results``, solve_seconds 0.0),
  evictions included; and the operator end to end (drain-before-bind
  preemption, an atomic gang), binding for binding.
* The card route of the gang solve (``cuda_ffd.cuda_gang_solve[_batched]``)
  takes the plain version for CPU tensors; around a counting scan it runs
  one scan when every gang commits and two when one rolls back.
"""
from __future__ import annotations

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import GIB, make_nodepool, make_pod
from tests.test_e2e import new_operator as ref_new_operator
from tests.test_e2e import replicated
from tests.test_gangsched import (
    SYSTEM_CLUSTER_CRITICAL,
    _plain_problem,
    full_node,
    gang_pod,
    preemption_problem,
    small_catalog,
)
from tests.test_torch_consolidation import align_counters
from tests.test_torch_ffd import _bits
from tests.test_torch_provisioner import _align_hostnames, to_reference
from tests.torch_threads import one_torch_thread  # noqa: F401

import chip_smoke
from karpenter_core_tpu.api import labels as L
from karpenter_core_tpu.api.objects import NodeSelectorRequirement
from karpenter_core_tpu.cloudprovider.kwok import build_catalog
from karpenter_core_tpu.controllers.provisioning.scheduling.inflight import (
    EvictablePod,
    SimNode,
)
from karpenter_core_tpu.metrics import wiring as jmetrics
from karpenter_core_tpu.models import provisioner as jprov
from karpenter_core_tpu.ops import ffd as jffd
from karpenter_core_tpu.ops import gangsched as jgs
from karpenter_core_tpu.ops import masks as jmasks
from karpenter_core_tpu.solver import codec
from karpenter_core_tpu.solver import verify as jverify
from karpenter_core_tpu_torch import interop
from karpenter_core_tpu_torch.metrics import wiring as port_metrics
from karpenter_core_tpu_torch.models import provisioner as tprov
from karpenter_core_tpu_torch.ops import cuda_ffd
from karpenter_core_tpu_torch.ops import gangsched as tgs
from karpenter_core_tpu_torch.ops import masks as tmasks
from karpenter_core_tpu_torch.operator import Options
from karpenter_core_tpu_torch.solver import verify as tverify


def _wire(results):
    return codec.encode_solve_results(results, 0.0)


def _np(tree):
    return type(tree)(*(None if x is None else np.asarray(x) for x in tree))


def _t(x):
    return interop.tensors_from_numpy(x, "cpu")


def assert_equal(port, ref, what):
    """Exact equality, float32 as raw bits."""
    p = np.asarray(port.numpy() if isinstance(port, torch.Tensor) else port)
    r = np.asarray(ref)
    assert p.dtype == r.dtype, (what, p.dtype, r.dtype)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    assert np.array_equal(_bits(p), _bits(r)), what


def assert_trees_equal(port_tree, ref_tree, what):
    for name, p, r in zip(ref_tree._fields, port_tree, ref_tree):
        assert_equal(p, r, f"{what}.{name}")


# ---------------------------------------------------------------------------
# gang_joint_templates


@pytest.mark.parametrize("seed", range(4))
def test_gang_joint_templates_equal(seed):
    rng = np.random.default_rng(seed)
    C, S, G = 12, 5, 3
    tmpl_ok = rng.random((C, S)) < 0.6
    gang_id = rng.integers(-1, G, size=C).astype(np.int32)
    ref = jmasks.gang_joint_templates(tmpl_ok, gang_id, num_gangs=G)
    port = tmasks.gang_joint_templates(torch.tensor(tmpl_ok),
                                       torch.tensor(gang_id), num_gangs=G)
    assert_equal(port, ref, "joint")


def test_gang_joint_templates_unit():
    """tests/test_gangsched.py's hand case: members AND-reduce to their
    common template, the gang-free class passes through."""
    out = tmasks.gang_joint_templates(
        torch.tensor([[True, True, False], [False, True, True],
                      [True, False, True]]),
        torch.tensor([0, 0, -1], dtype=torch.int32), num_gangs=1)
    assert out.tolist() == [[False, True, False], [False, True, False],
                            [True, False, True]]


# ---------------------------------------------------------------------------
# the gang-atomic solve


def _jax_scheduler(pools, catalog, existing=(), max_slots=64):
    return jprov.DeviceScheduler(
        copy.deepcopy(pools), {p.name: list(catalog) for p in pools},
        existing_nodes=copy.deepcopy(list(existing)), max_slots=max_slots)


def _jax_requests(pools, catalog, existing, pods, max_slots=64):
    """Every kernel request the JAX solve yields (the scan, then the
    preemption pass when there is one), each answered by the JAX package's
    own solo runner."""
    gen = _jax_scheduler(pools, catalog, existing, max_slots)._solve_gen(
        copy.deepcopy(pods))
    reqs, out = [], None
    try:
        while True:
            req = gen.send(out)
            reqs.append(req)
            out = jprov._run_kernel_solo(req)
    except StopIteration:
        pass
    return reqs


def rollback_problem(tag="a", cpu=4.0, n=3, min_size=None):
    """A 3 x 4-cpu gang over 9 free cpu (no fresh node fits): the gang
    misses its min and rolls back; two gang-free fillers take its room."""
    node = full_node(name=f"exist-{tag}", available_cpu=9.0, victims=0)
    gang = [gang_pod(f"{tag}g{i}", f"job-{tag}", cpu=cpu, min_size=min_size)
            for i in range(n)]
    fill = [make_pod(cpu=4.0, memory_gib=0.5, name=f"{tag}f{i}")
            for i in range(2)]
    return [make_nodepool()], small_catalog(), [node], gang + fill


def commit_problem(tag="c"):
    """Two gangs that fit: the first scan commits them."""
    node = full_node(name=f"exist-{tag}", available_cpu=9.0, victims=0)
    pods = ([gang_pod(f"{tag}a{i}", f"job-{tag}a", cpu=2.0) for i in range(2)]
            + [gang_pod(f"{tag}b{i}", f"job-{tag}b", cpu=1.0)
               for i in range(4)])
    return [make_nodepool()], small_catalog(), [node], pods


def _gang_args(req):
    return (_np(req.init_state), _np(req.steps), _np(req.statics),
            np.asarray(req.gang_of_step), np.asarray(req.gang_min))


def _assert_gang_equal(port_out, ref_out, what):
    (ps, pt, pu), (rs, rt, ru) = port_out, ref_out
    assert_trees_equal(ps, _np(rs), f"{what} state")
    assert_equal(pt, rt, f"{what} takes")
    assert_equal(pu, ru, f"{what} unplaced")


@pytest.mark.parametrize("case", ["commit", "rollback"])
def test_gang_solve_equal(case):
    problem = commit_problem() if case == "commit" else rollback_problem()
    req = _jax_requests(*problem)[0]
    assert req.gang_of_step is not None
    init, steps, statics, gos, gmin = _gang_args(req)
    ref = jgs.gang_solve(init, steps, statics, gos, gmin,
                         level_iters=req.level_iters)
    port = tgs.gang_solve(*_t((init, steps, statics)), _t(gos), _t(gmin),
                          req.level_iters)
    _assert_gang_equal(port, ref, case)
    # and the first scan alone tells the two cases apart
    _, takes1, _ = jffd.ffd_solve(init, steps, statics,
                                  level_iters=req.level_iters)
    failed = np.asarray(jgs._gang_failures(takes1, gos, gmin))
    assert failed.any() == (case == "rollback")


def _jax_fake_scan(state, classes, statics, level_iters):
    """A scan stand-in whose second pass fails a gang the first committed:
    step 0 places at most one pod; step 1 places its whole count while
    step 0 has pods, and one fewer once step 0 is zeroed."""
    c = classes.count
    take0 = jnp.minimum(c[0], 1)
    take1 = jnp.where(c[0] > 0, c[1], c[1] - 1)
    per_step = jnp.stack([take0, take1] + [c[j] for j in range(2, c.shape[0])])
    N = state.kind.shape[0]
    takes = jnp.zeros((c.shape[0], N), jnp.int32).at[:, 0].set(per_step)
    return state, takes, c - per_step


def _port_fake_scan(state, classes, statics, level_iters):
    c = classes.count
    take0 = torch.minimum(c[0], torch.ones_like(c[0]))
    take1 = torch.where(c[0] > 0, c[1], c[1] - 1)
    per_step = torch.stack([take0, take1] + [c[j] for j in range(2, c.shape[0])])
    N = state.kind.shape[0]
    takes = torch.zeros((c.shape[0], N), dtype=torch.int32)
    takes[:, 0] = per_step
    return state, takes, c - per_step


def test_gang_cascade_guard_equal(monkeypatch):
    """Gang 0 misses its min on the first scan and rolls back; gang 1
    committed there but fails on the second scan: the guard drops both,
    zeroing their takes and reporting each class count unplaced."""
    req = _jax_requests(*rollback_problem())[0]
    init, steps, statics, _, _ = _gang_args(req)
    J = steps.count.shape[0]
    count = np.zeros((J,), np.int32)
    count[:3] = [2, 2, 1]
    steps = steps._replace(count=count)
    gos = np.full((J,), -1, np.int32)
    gos[:2] = [0, 1]
    gmin = np.array([2, 2], np.int32)
    monkeypatch.setattr(jgs, "_ffd_solve_impl", _jax_fake_scan)
    ref = jgs._gang_solve_impl(init, steps, statics, gos, gmin,
                               req.level_iters)
    port = tgs.gang_solve_with(_port_fake_scan, *_t((init, steps, statics)),
                               torch.tensor(gos), torch.tensor(gmin),
                               req.level_iters)
    _assert_gang_equal(port, ref, "cascade")
    takes, unplaced = np.asarray(ref[1]), np.asarray(ref[2])
    assert not takes[:2].any() and takes[2, 0] == 1
    assert unplaced[:2].tolist() == [2, 2]


def _stack(trees):
    return type(trees[0])(*(
        None if xs[0] is None else np.stack([np.asarray(x) for x in xs])
        for xs in zip(*trees)))


def _gang_batch():
    """Two same-shaped gang problems, one rolling back, one committing."""
    reqs = [_jax_requests(*rollback_problem("a"))[0],
            _jax_requests(*rollback_problem("b", min_size=2))[0]]
    assert reqs[0].shape_key() == reqs[1].shape_key()
    return reqs


def test_gang_solve_batched_equal():
    reqs = _gang_batch()
    args = [_stack([_gang_args(r)[i] for r in reqs]) if i < 3 else
            np.stack([_gang_args(r)[i] for r in reqs]) for i in range(5)]
    li = reqs[0].level_iters
    ref = jgs.gang_solve_batched(*args, level_iters=li)
    port = tgs.gang_solve_batched(*_t(tuple(args[:3])),
                                  torch.tensor(args[3]),
                                  torch.tensor(args[4]), li)
    _assert_gang_equal(port, ref, "batched")
    # every row equals its solo answer
    for b, r in enumerate(reqs):
        solo = jgs.gang_solve(*_gang_args(r), level_iters=li)
        assert_equal(port[1][b], solo[1], f"row {b} takes")
    via_wrapper = cuda_ffd.cuda_gang_solve_sharded(
        [(*_t(tuple(args[:3])), torch.tensor(args[3]),
          torch.tensor(args[4]))], li)[0]
    _assert_gang_equal(via_wrapper, ref, "batched wrapper")


def _counting(scan):
    calls = []

    def run(*args):
        calls.append(1)
        return scan(*args)

    return run, calls


@pytest.mark.parametrize("case,scans", [("commit", 1), ("rollback", 2)])
def test_gang_route_scans_once_or_twice(case, scans):
    """The gang route's scan count: one when every gang commits, two when
    one rolls back (the one host read decides), solo and batched; the
    input state is left untouched."""
    problem = commit_problem() if case == "commit" else rollback_problem()
    req = _jax_requests(*problem)[0]
    init, steps, statics, gos, gmin = _gang_args(req)
    ref = jgs.gang_solve(init, steps, statics, gos, gmin,
                         level_iters=req.level_iters)
    t_init, t_steps, t_statics = _t((init, steps, statics))
    scan, calls = _counting(tgs.ffd_solve)
    port = tgs.gang_solve_with(scan, t_init, t_steps, t_statics,
                               torch.tensor(gos), torch.tensor(gmin),
                               req.level_iters)
    assert len(calls) == scans
    _assert_gang_equal(port, ref, case)
    assert_trees_equal(t_init, init, "untouched init")

    def one(tree):
        return type(tree)(*(None if x is None else x[None] for x in tree))

    scan_b, calls_b = _counting(tgs.ffd_solve_batched)
    port_b = tgs.gang_solve_batched_with(
        scan_b, one(t_init), one(t_steps), one(t_statics),
        torch.tensor(gos)[None], torch.tensor(gmin)[None], req.level_iters)
    assert len(calls_b) == scans
    assert_equal(port_b[1][0], ref[1], f"{case} batched takes")


def test_gang_wrappers_take_plain_version_on_cpu():
    req = _jax_requests(*rollback_problem())[0]
    init, steps, statics, gos, gmin = _gang_args(req)
    ref = jgs.gang_solve(init, steps, statics, gos, gmin,
                         level_iters=req.level_iters)
    before = dict(cuda_ffd.counter.launches)
    port = cuda_ffd.cuda_gang_solve(*_t((init, steps, statics)),
                                    torch.tensor(gos), torch.tensor(gmin),
                                    req.level_iters)
    _assert_gang_equal(port, ref, "wrapper")
    assert cuda_ffd.counter.launches == before
    meta = tgs.SlotState(*(x.to("meta") for x in _t(init)))
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_ffd.cuda_gang_solve(meta, *_t((steps, statics)),
                                 torch.tensor(gos), torch.tensor(gmin))


# ---------------------------------------------------------------------------
# the preemption pass


def preempt_fleet(n_nodes=5, seed=0):
    """Several full nodes whose victims carry costs no float32 holds
    exactly, tiers below and at the critical pods', and several critical
    classes: the pass claims prefixes over many nodes and rounds."""
    rng = np.random.default_rng(seed)
    existing = []
    for i in range(n_nodes):
        victims = tuple(
            EvictablePod(
                uid=f"v{i}-{j}", priority=int(rng.choice([0, 0, 5, 10])),
                requests={"cpu": float(rng.choice([1.0, 1.5, 3.0])),
                          "memory": 0.5 * GIB},
                cost=float(1.0 + 0.01 * j + rng.random() / 7.0),
            )
            for j in range(int(rng.integers(1, 5)))
        )
        existing.append(SimNode(
            name=f"exist-{i}",
            labels={L.LABEL_TOPOLOGY_ZONE: "zone-a", L.LABEL_OS: "linux",
                    L.LABEL_ARCH: "amd64",
                    L.CAPACITY_TYPE_LABEL_KEY: "on-demand",
                    L.NODEPOOL_LABEL_KEY: "default",
                    L.LABEL_HOSTNAME: f"exist-{i}"},
            taints=[],
            available={"cpu": float(rng.choice([0.5, 1.0, 2.0])),
                       "memory": 8 * GIB, "pods": 100.0},
            capacity={"cpu": 16.0, "memory": 16 * GIB, "pods": 110.0},
            initialized=True,
            evictable=victims,
        ))
    pods = []
    for i in range(int(rng.integers(4, 9))):
        p = make_pod(cpu=float(rng.choice([2.5, 3.0, 4.0])),
                     memory_gib=float(rng.choice([0.5, 1.0])), name=f"c{i}")
        p.priority = int(rng.choice([7, 100, SYSTEM_CLUSTER_CRITICAL]))
        pods.append(p)
    return [make_nodepool()], small_catalog(), existing, pods


def _preempt_request(problem):
    reqs = _jax_requests(*problem)
    assert [r.kind for r in reqs] == ["solve", "preempt"]
    return reqs[1]


def _preempt_args(req):
    return (_np(req.init_state), _np(req.steps), _np(req.statics),
            np.asarray(req.step_tier), np.asarray(req.step_gang),
            np.asarray(req.unplaced), _np(req.ev))


def _run_preempt_both(args, node_rounds=jgs.NODE_ROUNDS):
    ref = jgs.preempt_pass(*args, node_rounds=node_rounds)
    port = tgs.preempt_pass(*_t(tuple(args)), node_rounds=node_rounds)
    for name, p, r in zip(("extra", "m_left", "evicted"), port, ref):
        assert_equal(p, r, name)
    return ref


@pytest.mark.parametrize("name", ["hand", "fleet0", "fleet1", "fleet2"])
def test_preempt_pass_equal(name):
    problem = (preemption_problem() if name == "hand"
               else preempt_fleet(seed=int(name[-1])))
    ref = _run_preempt_both(_preempt_args(_preempt_request(problem)))
    assert np.asarray(ref[2]).any()  # something was evicted


@pytest.mark.parametrize("seed", range(4))
def test_preempt_pass_float_carry_equal(seed):
    """Seeded evictable planes over every existing slot, with costs such as
    1 + 0.01 j + u/7 that float32 rounds, random tiers and validity: the
    prefix costs, the per-node scores, the argmin (ties to the first
    index) and the capacity bonus carry must match bit for bit."""
    req = _preempt_request(preempt_fleet(seed=seed))
    args = list(_preempt_args(req))
    ev = args[6]
    rng = np.random.default_rng(100 + seed)
    N, P = ev.tier.shape
    E = int((np.asarray(args[0].kind) == 1).sum())
    cost = np.zeros((N, P), np.float32)
    cost[:E] = (1.0 + 0.01 * np.arange(P)[None, :]
                + rng.random((E, P)) / 7.0).astype(np.float32)
    cost[:E, 1] = cost[:E, 0]  # equal prefix costs: argmin ties
    valid = np.zeros((N, P), bool)
    valid[:E] = rng.random((E, P)) < 0.8
    tier = np.where(valid, rng.choice([0, 3, 10**9], size=(N, P)),
                    1 << 30).astype(np.int32)
    args[6] = jgs.EvPlanes(req=ev.req, tier=tier, cost=cost, valid=valid)
    for rounds in (jgs.NODE_ROUNDS, 2):
        _run_preempt_both(tuple(args), node_rounds=rounds)


def _order_sensitive_costs(seed=0):
    """Two nodes' four victim costs whose left-to-right float32 sums order
    the nodes one way while a pairwise sum ((c0 + c1) + (c2 + c3)) orders
    them the other way."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def seq(c):
        return f(f(f(c[0] + c[1]) + c[2]) + c[3])

    def pair(c):
        return f(f(c[0] + c[1]) + f(c[2] + c[3]))

    while True:
        a = (1.0 + rng.random(4) / 3.0).astype(np.float32)
        b = a[rng.permutation(4)]
        if (seq(a) < seq(b)) and (pair(a) > pair(b)):
            return a, b


def test_preempt_pass_argmin_follows_the_float_order():
    """Two full nodes whose whole victim prefix must go, with the same
    victims in another order: the prefix costs are equal in exact
    arithmetic and differ by an ulp in float32, so the node the pass
    claims depends on summing in the JAX package's order (a pairwise
    sum picks the other node)."""
    pools, catalog, _, _ = preemption_problem()
    existing = [full_node(name=f"exist-{i}") for i in range(2)]
    crit = make_pod(cpu=12.0, memory_gib=1.0, name="critical")
    crit.priority = SYSTEM_CLUSTER_CRITICAL
    args = list(_preempt_args(_preempt_request(
        (pools, catalog, existing, [crit]))))
    ev = args[6]
    cost = np.array(ev.cost)
    cost[0], cost[1] = _order_sensitive_costs()
    args[6] = ev._replace(cost=cost)
    ref = _run_preempt_both(tuple(args))
    evicted = np.asarray(ref[2])
    assert evicted[0].all() and not evicted[1].any()  # node 0: smaller sum


def test_preempt_pass_nothing_enabled_is_inert():
    """A pass whose steps are all gang members or tier 0 takes nothing and
    evicts nothing (every step is skipped on the host)."""
    args = list(_preempt_args(_preempt_request(preemption_problem())))
    args[4] = np.zeros_like(args[4])  # every step a kernel gang member
    ref = _run_preempt_both(tuple(args))
    assert not np.asarray(ref[0]).any() and not np.asarray(ref[2]).any()


def test_preempt_pass_batched_equal():
    """Two rows: a fleet's preempt request, and the same request with
    other victims' costs and validity."""
    row = _preempt_args(_preempt_request(preempt_fleet(seed=0)))
    ev = row[6]
    rng = np.random.default_rng(7)
    other = jgs.EvPlanes(
        req=ev.req, tier=ev.tier,
        cost=(ev.cost + rng.random(ev.cost.shape) / 3.0).astype(np.float32),
        valid=ev.valid & (rng.random(ev.valid.shape) < 0.7))
    rows = [row, row[:6] + (other,)]
    args = [(_stack if i in (0, 1, 2, 6) else np.stack)([row[i] for row in rows])
            for i in range(7)]
    args[6] = jgs.EvPlanes(*args[6])
    ref = jgs.preempt_pass_batched(*args, node_rounds=jgs.NODE_ROUNDS)
    port = tgs.preempt_pass_batched(*_t(tuple(args)))
    for name, p, r in zip(("extra", "m_left", "evicted"), port, ref):
        assert_equal(p, r, name)


# ---------------------------------------------------------------------------
# solves: byte-identical result wires


def _preempt_case(**kw):
    pools, catalog, _, pods = preemption_problem()
    return pools, catalog, [full_node(**kw)], pods


def _negative_tier():
    pools, catalog, existing, _ = preemption_problem()
    low = make_pod(cpu=8.0, memory_gib=1.0, name="low")
    low.priority = -5
    return pools, catalog, existing, [low]


def _gang_member_preempt():
    pools, catalog, existing, _ = preemption_problem()
    return pools, catalog, existing, [gang_pod(
        "g0", "job-g", cpu=8.0, memory_gib=1.0,
        priority=SYSTEM_CLUSTER_CRITICAL)]


def _straddling():
    pools, catalog, existing, _ = preemption_problem()
    big = gang_pod("gs-big", "job-s", cpu=8.0, memory_gib=1.0,
                   priority=SYSTEM_CLUSTER_CRITICAL)
    small = gang_pod("gs-small", "job-s", cpu=0.5, memory_gib=0.5,
                     priority=SYSTEM_CLUSTER_CRITICAL,
                     spread_zone=True, zone_in=["zone-a"])
    return pools, catalog, existing, [big, small]


def _plain_off_by_default():
    pools, catalog, pods = _plain_problem()
    return pools, catalog, [full_node(victims=0)], pods


def _zoned_pool():
    return make_nodepool(requirements=[NodeSelectorRequirement(
        L.LABEL_TOPOLOGY_ZONE, "In", ("zone-a", "zone-b", "zone-c"))])


def _same_zone(flag_all):
    pods = [gang_pod(f"z{i}", "job-z", cpu=1.0, same_zone=flag_all or i > 0,
                     **({"zone_in": ["zone-b"]} if i == 0 else {}))
            for i in range(4)]
    return [_zoned_pool()], small_catalog(), [], pods


def _two_pools(pods, heavy_arch=True):
    heavy = make_nodepool(name="heavy", weight=10, requirements=[
        NodeSelectorRequirement(L.LABEL_ARCH, "In", ("amd64",)),
    ] if heavy_arch else None)
    light = make_nodepool(name="light")
    return [heavy, light], small_catalog(), [], pods


def _same_template():
    return _two_pools([gang_pod(f"t{i}", "job-t", cpu=1.0,
                                same_template=True) for i in range(4)])


def _same_template_one_flag():
    return _two_pools([
        gang_pod("t0", "job-t", cpu=1.0, same_template=True),
        gang_pod("t1", "job-t", cpu=1.0,
                 node_selector={L.NODEPOOL_LABEL_KEY: "light"}),
    ], heavy_arch=False)


def _min_count_partial():
    pools, catalog, existing, pods = rollback_problem(min_size=2)
    return pools, catalog, existing, pods[:3]


WIRE_CASES = {
    "off_by_default_plain": _plain_off_by_default,
    "preempt_minimal_cost": preemption_problem,
    "preempt_equal_tier": lambda: _preempt_case(
        victim_tier=SYSTEM_CLUSTER_CRITICAL),
    "preempt_negative_tier": _negative_tier,
    "preempt_gang_member": _gang_member_preempt,
    "preempt_fallback_straddling": _straddling,
    "preempt_fleet0": lambda: preempt_fleet(seed=0),
    "preempt_fleet1": lambda: preempt_fleet(seed=1),
    "gang_rollback": rollback_problem,
    "gang_min_count_partial": _min_count_partial,
    "gang_commit": commit_problem,
    "gang_same_zone": lambda: _same_zone(True),
    "gang_same_zone_one_flag": lambda: _same_zone(False),
    "gang_same_template": _same_template,
    "gang_same_template_one_flag": _same_template_one_flag,
}


def solve_both(problem, backend="reference", max_slots=64):
    pools, catalog, existing, pods = problem
    its = {p.name: list(catalog) for p in pools}
    port_in = interop.from_reference((pools, its, existing, pods))
    _align_hostnames()
    ref = jprov.DeviceScheduler(
        copy.deepcopy(pools), its, existing_nodes=copy.deepcopy(existing),
        max_slots=max_slots)
    r_ref = ref.solve(copy.deepcopy(pods))
    port = tprov.DeviceScheduler(
        port_in[0], port_in[1], existing_nodes=port_in[2],
        max_slots=max_slots, device="cpu", kernel_backend=backend)
    r_port = port.solve(port_in[3])
    return ref, r_ref, port, r_port


@pytest.mark.parametrize("name", list(WIRE_CASES))
def test_result_wire_identical(name):
    rejected0 = dict(port_metrics.SOLVER_RESULT_REJECTED.values)
    gangs0 = (jmetrics.SOLVER_GANG_UNSCHEDULABLE.value(),
              port_metrics.SOLVER_GANG_UNSCHEDULABLE.value())
    ref, r_ref, port, r_port = solve_both(WIRE_CASES[name]())
    assert _wire(to_reference(r_port)) == _wire(r_ref), name
    assert r_port.evictions == r_ref.evictions
    assert dict(port_metrics.SOLVER_RESULT_REJECTED.values) == rejected0
    for k in ("rounds", "slots", "used_slots", "fetch_bytes"):
        assert port.last_phase_stats[k] == ref.last_phase_stats[k], k
    whole = (jmetrics.SOLVER_GANG_UNSCHEDULABLE.value() - gangs0[0],
             port_metrics.SOLVER_GANG_UNSCHEDULABLE.value() - gangs0[1])
    assert whole[1] == whole[0]
    if name == "preempt_minimal_cost":
        assert r_port.evictions == {
            "exist-0": ["victim-0", "victim-1", "victim-2"]}
    if name == "gang_rollback":
        assert whole[1] == 1
        assert sorted(p.name for s in r_port.existing_nodes
                      for p in s.pods) == ["af0", "af1"]


@pytest.mark.parametrize("name", ["gang_rollback", "preempt_fleet0"])
def test_cuda_backend_on_cpu_matches(name):
    """kernel_backend="cuda" on CPU tensors: the gang and preemption
    routes take the plain versions and launch nothing."""
    before = dict(cuda_ffd.counter.launches)
    _, r_ref, _, r_port = solve_both(WIRE_CASES[name](), backend="cuda")
    assert _wire(to_reference(r_port)) == _wire(r_ref)
    assert cuda_ffd.counter.launches == before


def test_warm_resolve_identical():
    """A second solve on the same schedulers (cached class batch, step
    rows and evictable planes) still matches."""
    problem = preempt_fleet(seed=2)
    ref, _, port, _ = solve_both(problem)
    _align_hostnames()
    w_ref = _wire(ref.solve(copy.deepcopy(problem[3])))
    w_port = _wire(to_reference(port.solve(
        interop.from_reference(problem[3]))))
    assert w_port == w_ref
    assert port.last_phase_stats["prep_cache_hits"] >= 1


def test_plain_problem_never_dispatches_gang_routes(monkeypatch):
    """Off by default: a plain problem never reaches the gang or
    preemption functions and carries no eviction."""
    def boom(*a, **k):
        raise AssertionError("gang route dispatched on a plain problem")

    for mod, names in ((tgs, ("gang_solve", "gang_solve_batched",
                              "gang_solve_sharded", "preempt_pass",
                              "preempt_pass_batched")),
                       (cuda_ffd, ("cuda_gang_solve",
                                   "cuda_gang_solve_sharded"))):
        for n in names:
            monkeypatch.setattr(mod, n, boom)
    _, r_ref, _, r_port = solve_both(_plain_off_by_default())
    assert _wire(to_reference(r_port)) == _wire(r_ref)
    assert not r_port.evictions and b"evictions" not in _wire(r_ref)


def test_degraded_device_path_identical(monkeypatch):
    """A forced verifier rejection in both packages: the re-solve goes
    through the tiered host wrapper, and the wires (evictions included)
    agree."""
    monkeypatch.setattr(
        jverify.ResultVerifier, "verify",
        lambda self, res, p: [jverify.Violation("capacity", "forged")])
    monkeypatch.setattr(
        tverify.ResultVerifier, "verify",
        lambda self, res, p: [tverify.Violation("capacity", "forged")])
    _, r_ref, _, r_port = solve_both(preemption_problem())
    assert _wire(to_reference(r_port)) == _wire(r_ref)
    assert r_port.evictions == {
        "exist-0": ["victim-0", "victim-1", "victim-2"]}


# ---------------------------------------------------------------------------
# solve_batch seams


def _batch_both(problems):
    j_entries, p_entries = [], []
    for pools, catalog, existing, pods in problems:
        its = {p.name: list(catalog) for p in pools}
        j_entries.append((jprov.DeviceScheduler(
            copy.deepcopy(pools), its, existing_nodes=copy.deepcopy(existing),
            max_slots=64), copy.deepcopy(pods)))
        pools_t, its_t, existing_t, pods_t = interop.from_reference(
            (pools, its, existing, pods))
        p_entries.append((tprov.DeviceScheduler(
            pools_t, its_t, existing_nodes=existing_t, max_slots=64,
            device="cpu", kernel_backend="reference"), pods_t))
    _align_hostnames()
    j = jprov.solve_batch(j_entries)
    p = tprov.solve_batch(p_entries)
    return j, p


def _assert_batch_equal(j, p):
    (j_out, j_stats), (p_out, p_stats) = j, p
    assert [s for s, _ in p_out] == [s for s, _ in j_out] == ["ok"] * len(j_out)
    for (_, jr), (_, pr) in zip(j_out, p_out):
        assert _wire(to_reference(pr)) == _wire(jr)
    assert p_stats == j_stats
    return p_stats


def test_mixed_gang_plain_batch_never_coalesces():
    node_g = full_node(name="exist-g", available_cpu=9.0, victims=0)
    node_p = full_node(name="exist-p", available_cpu=9.0, victims=0)
    gang = [gang_pod(f"g{i}", "job-a", cpu=4.0) for i in range(2)]
    plain = [make_pod(cpu=4.0, memory_gib=0.5, name=f"p{i}")
             for i in range(2)]
    stats = _assert_batch_equal(*_batch_both([
        ([make_nodepool()], small_catalog(), [node_g], gang),
        ([make_nodepool()], small_catalog(), [node_p], plain),
    ]))
    assert stats["batched_problems"] == 0


@pytest.mark.parametrize("case", ["commit", "rollback", "preempt"])
def test_same_shaped_gang_problems_coalesce(case):
    if case == "preempt":
        problems = [preemption_problem(), preemption_problem()]
    else:
        make = commit_problem if case == "commit" else rollback_problem
        problems = [make("a"), make("b")]
    stats = _assert_batch_equal(*_batch_both(problems))
    assert stats["batched_problems"] >= 2


def test_shape_key_splits_gang_and_plain_requests():
    def first(problem):
        pools, catalog, existing, pods = interop.from_reference(problem)
        gen = tprov.DeviceScheduler(
            pools, {p.name: list(catalog) for p in pools},
            existing_nodes=existing, max_slots=64, device="cpu",
        )._solve_gen(pods)
        req = gen.send(None)
        gen.close()
        return req

    ga, gb = first(rollback_problem("a")), first(rollback_problem("b"))
    assert ga.gang_of_step is not None and ga.gang_min is not None
    assert ga.shape_key() == gb.shape_key()
    plain = dataclasses.replace(ga, gang_of_step=None, gang_min=None)
    assert plain.shape_key() != ga.shape_key()
    assert ga.kind == "solve"


def test_relax_mode_gang_dispatch_runs_and_devices_raise():
    """A relax problem's gang dispatch (mode="relax") is answered like an
    ffd one, and so is a multi-device request: on a 2-device virtual CPU
    mesh the gang dispatch runs on the lead device with the one-device
    answer."""
    from karpenter_core_tpu_torch.parallel import mesh as pmesh

    req = _port_request()
    relax = dataclasses.replace(req, mode="relax")
    assert relax.shape_key() != req.shape_key()
    out = tprov._run_kernel_solo(dataclasses.replace(
        relax, init_state=tprov.SlotState(*(x.clone()
                                           for x in req.init_state))))
    ref = tprov._run_kernel_solo(dataclasses.replace(
        req, init_state=tprov.SlotState(*(x.clone()
                                         for x in req.init_state))))
    for a, b in zip(out[1:3], ref[1:3]):
        assert torch.equal(a, b)
    pmesh.force_virtual_mesh(2, "cpu")
    try:
        two = tprov._run_kernel_solo(dataclasses.replace(
            req, devices=2, init_state=tprov.SlotState(
                *(x.clone() for x in req.init_state))))
    finally:
        pmesh.force_virtual_mesh(0, "cpu")
    for a, b in zip(two[:3], ref[:3]):
        for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert torch.equal(x, y)


def _port_request():
    pools, catalog, existing, pods = interop.from_reference(
        preemption_problem())
    gen = tprov.DeviceScheduler(
        pools, {p.name: list(catalog) for p in pools},
        existing_nodes=existing, max_slots=64, device="cpu")._solve_gen(pods)
    req = gen.send(None)
    gen.close()
    return req


# ---------------------------------------------------------------------------
# the operator end to end


def _port_operator(catalog):
    return chip_smoke._new_operator(
        chip_smoke.port_classes(), interop.from_reference(catalog),
        Options(solver="tpu", device_scheduler_opts={
            "device": "cpu", "kernel_backend": "reference"}))


def _bindings(op):
    return sorted((p.name, p.node_name) for p in op.kube.list_pods())


def _preemption_story(op, convert):
    """tests/test_gangsched.py's drain-before-bind story on ``op``."""
    pool = convert(make_nodepool(requirements=[NodeSelectorRequirement(
        L.LABEL_TOPOLOGY_ZONE, "In", ("zone-a",))]))
    op.kube.create(pool)
    for i in range(3):
        op.kube.create(convert(replicated(make_pod(cpu=1.0, name=f"low{i}"))))
    op.run_until_idle()
    (node_a,) = op.kube.list_nodes()
    pool = op.kube.get(type(pool), "default")
    pool.spec.template.requirements = [convert(NodeSelectorRequirement(
        L.LABEL_TOPOLOGY_ZONE, "In", ("zone-b",)))]
    op.kube.update(pool)
    crit = replicated(make_pod(cpu=3.0, name="crit", zone_in=["zone-a"]))
    crit.priority = SYSTEM_CLUSTER_CRITICAL
    op.kube.create(convert(crit))
    op.run_until_idle()
    return node_a.name


def test_operator_preemption_matches_reference():
    catalog = build_catalog(cpu_grid=[4])
    align_counters()
    ref = ref_new_operator("tpu", catalog=catalog)
    ref_node = _preemption_story(ref, lambda x: x)
    align_counters()
    op = _port_operator(catalog)
    evicted0 = port_metrics.SOLVER_PREEMPTION_EVICTIONS.value()
    errors0 = dict(port_metrics.RECONCILE_ERRORS.values)
    node = _preemption_story(op, interop.from_reference)
    assert node == ref_node
    assert _bindings(op) == _bindings(ref)
    pods = {p.name: p for p in op.kube.list_pods()}
    assert pods["crit"].node_name == node
    assert all(pods[f"low{i}"].node_name not in (None, "", node)
               for i in range(3))
    assert port_metrics.SOLVER_PREEMPTION_EVICTIONS.value() == evicted0 + 3
    assert [e.reason for e in op.recorder.events].count("Preempted") == 3
    assert dict(port_metrics.RECONCILE_ERRORS.values) == errors0


def test_operator_gang_binds_atomically_like_reference():
    pods = [replicated(gang_pod(f"g{i}", "job-a", cpu=1.0)) for i in range(6)]
    catalog = build_catalog(cpu_grid=[1, 2, 4, 8, 16], mem_factors=[2, 4])
    align_counters()
    ref = ref_new_operator("tpu", catalog=catalog)
    ref.kube.create(make_nodepool())
    for p in copy.deepcopy(pods):
        ref.kube.create(p)
    ref.run_until_idle()
    align_counters()
    op = _port_operator(catalog)
    op.kube.create(interop.from_reference(make_nodepool()))
    for p in interop.from_reference(pods):
        op.kube.create(p)
    op.run_until_idle()
    assert all(node for _, node in _bindings(op))
    assert _bindings(op) == _bindings(ref)
