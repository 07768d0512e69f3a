"""The port's rack-aware gangs against the JAX package.

* The level-grouped first-fit (``ClassStep.topo_rank``) of the plain scan:
  on seeded level planes (values outside [0, TOPO_LEVELS) included, which
  the step clips) over problems with existing nodes, and on the planes the
  JAX package's own rack-aware gang preparation makes, every plane of the
  port's ``ffd_solve`` / ``ffd_solve_batched`` is bit-equal to the JAX
  ``ffd_solve`` / ``ffd_solve_batched``; an all-zero plane gives the
  classic fill; at a tiny size the JAX package's Pallas step, interpreted
  on the CPU as tests/test_pallas.py runs it, gives the same planes.
* The kernel wrapper hands the level plane to the C entry (null without
  one), with the kernel library mocked; the CUDA branch itself runs on the
  card (``chip_smoke.py`` phase 10).
* Solves: tests/test_topoaware.py's off-by-default parity (a rackless
  gang problem; a racked catalog without gangs never prepares) and its
  engaged solves give byte-identical result wires
  (``codec.encode_solve_results``, solve_seconds 0.0), and the engaged
  gang lands inside its bound, ranks adjacent.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from tests.helpers import make_nodepool, make_pod
from tests.test_topoaware import (
    GANG_MAX_HOPS_ANNOTATION,
    GANG_RANK_ANNOTATION,
    MAX_HOP_DISTANCE,
    racked_existing,
    ranked_gang,
    small_catalog,
)
from tests.test_torch_batch import _FakeLib, _fake_card
from tests.test_torch_ffd import (
    assert_planes_equal,
    port_inputs,
    reference_request,
)
from tests.test_torch_provisioner import (
    _align_hostnames,
    fuzz_problem,
    to_reference,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

from karpenter_core_tpu.models import provisioner as jprov
from karpenter_core_tpu.ops import ffd as jffd
from karpenter_core_tpu.ops import pallas_ffd
from karpenter_core_tpu.solver import codec
from karpenter_core_tpu.solver import gangs as jgangs
from karpenter_core_tpu_torch import interop
from karpenter_core_tpu_torch.metrics import wiring as port_metrics
from karpenter_core_tpu_torch.models import provisioner as tprov
from karpenter_core_tpu_torch.ops import cuda_ffd
from karpenter_core_tpu_torch.ops import ffd as tffd


def _wire(results):
    return codec.encode_solve_results(results, 0.0)


def _np(tree):
    return type(tree)(*(None if x is None else np.asarray(x) for x in tree))


def _planes(state, takes, unplaced):
    out = dict(state._asdict())
    out.update(takes=takes, unplaced=unplaced)
    return out


def _with_plane(req, plane):
    """The request's numpy inputs with a [J, N] level plane on its steps."""
    init, steps, statics = (_np(req.init_state), _np(req.steps),
                            _np(req.statics))
    return init, steps._replace(topo_rank=plane), statics


def _both_scans(inputs, level_iters, solve=jffd.ffd_solve):
    ref = _planes(*solve(*inputs, level_iters=level_iters))
    t = interop.tensors_from_numpy(inputs, "cpu")
    port = _planes(*tffd.ffd_solve(*t, level_iters))
    return port, ref


# fuzz problems of tests/test_torch_provisioner.py that carry existing nodes
EXISTING_SEEDS = [s for s in range(14) if fuzz_problem(s)[2]]


@pytest.mark.parametrize("seed", EXISTING_SEEDS[:6])
def test_topo_rank_scan_bit_equal(seed):
    req = reference_request(fuzz_problem(seed))
    J, N = np.asarray(req.steps.exist_taint_ok).shape
    rng = np.random.default_rng(seed)
    plane = rng.integers(-1, tffd.TOPO_LEVELS + 2, size=(J, N)).astype(
        np.int32)
    port, ref = _both_scans(_with_plane(req, plane), req.level_iters)
    assert_planes_equal(port, ref, f"fuzz{seed} topo")


def test_zero_plane_is_the_classic_fill():
    req = reference_request(fuzz_problem(EXISTING_SEEDS[0]))
    J, N = np.asarray(req.steps.exist_taint_ok).shape
    zero = _with_plane(req, np.zeros((J, N), np.int32))
    port, ref = _both_scans(zero, req.level_iters)
    assert_planes_equal(port, ref, "zero plane")
    classic = _planes(*tffd.ffd_solve(*port_inputs(req), req.level_iters))
    assert_planes_equal(port, {k: v.numpy() for k, v in classic.items()},
                        "zero plane vs classic")


def test_level_plane_changes_the_fill():
    """The branch is not inert: reversing the slot levels moves the
    existing-node takes on a problem where several nodes can take."""
    req = engaged_request()
    steps = _np(req.steps)
    J, N = steps.topo_rank.shape
    port0, _ = _both_scans(_with_plane(req, steps.topo_rank), req.level_iters)
    rev = (tffd.TOPO_LEVELS - 1 - steps.topo_rank).astype(np.int32)
    port1, ref1 = _both_scans(_with_plane(req, rev), req.level_iters)
    assert_planes_equal(port1, ref1, "reversed levels")
    assert not np.array_equal(port0["takes"], port1["takes"])


def engaged_request(n=8, size=4, max_hops=2):
    """The JAX scheduler's first request on a racked fleet with a ranked
    gang: its steps carry the rack-aware level plane."""
    req = reference_request(([make_nodepool()],
                             {"default": list(small_catalog())},
                             racked_existing(n=n), ranked_gang(
                                 size=size, max_hops=max_hops), 64))
    assert req.steps.topo_rank is not None
    assert req.gang_of_step is not None
    return req


def test_engaged_request_scan_bit_equal():
    req = engaged_request()
    inputs = (_np(req.init_state), _np(req.steps), _np(req.statics))
    port, ref = _both_scans(inputs, req.level_iters)
    assert_planes_equal(port, ref, "engaged")
    assert np.asarray(inputs[1].topo_rank).max() > 0  # levels differ


def test_topo_rank_matches_pallas_interpret():
    req = engaged_request(n=4, size=2)
    inputs = (_np(req.init_state), _np(req.steps), _np(req.statics))
    port, ref = _both_scans(inputs, req.level_iters,
                            solve=pallas_ffd.pallas_ffd_solve)
    assert_planes_equal(port, ref, "topo vs pallas")


def _stack(trees):
    return type(trees[0])(*(
        None if xs[0] is None else np.stack([np.asarray(x) for x in xs])
        for xs in zip(*trees)))


def test_topo_rank_batched_scan_bit_equal():
    req = engaged_request()
    J, N = np.asarray(req.steps.topo_rank).shape
    rng = np.random.default_rng(5)
    rows = [_with_plane(req, np.asarray(req.steps.topo_rank)),
            _with_plane(req, rng.integers(0, 4, (J, N)).astype(np.int32)),
            _with_plane(req, np.zeros((J, N), np.int32))]
    stacked = tuple(_stack([r[i] for r in rows]) for i in range(3))
    ref = _planes(*jffd.ffd_solve_batched(*stacked,
                                          level_iters=req.level_iters))
    t = interop.tensors_from_numpy(stacked, "cpu")
    port = _planes(*tffd.ffd_solve_batched(*t, req.level_iters))
    assert_planes_equal(port, ref, "batched topo")
    for b, row in enumerate(rows):  # each row equals its solo scan
        solo = _planes(*tffd.ffd_solve(*interop.tensors_from_numpy(
            row, "cpu"), req.level_iters))
        assert torch.equal(port["takes"][b], solo["takes"]), b


def test_card_path_hands_the_level_plane_to_the_kernel(monkeypatch):
    """With the kernel library mocked, a step axis with a level plane
    passes its address to the C entry; without one the pointer is null;
    a plane of the wrong type is refused before any launch."""
    req = engaged_request()
    init, steps, statics = port_inputs(req)
    seen = []
    lib = _fake_card(monkeypatch)
    orig = _FakeLib.ffd_scan

    def spy(self, args_ref, max_blocks, stream, blocks_ref):
        seen.append(args_ref._obj.c_topo_rank)
        return orig(self, args_ref, max_blocks, stream, blocks_ref)

    monkeypatch.setattr(_FakeLib, "ffd_scan", spy)
    one = [type(t)(*(None if x is None else x[None] for x in t))
           for t in (init, steps, statics)]
    cuda_ffd._launch_batched(*one, req.level_iters)
    assert seen[-1] == one[1].topo_rank.data_ptr()
    plain = one[1]._replace(topo_rank=None)
    cuda_ffd._launch_batched(one[0], plain, one[2], req.level_iters)
    assert seen[-1] is None
    bad = one[1]._replace(topo_rank=one[1].topo_rank.to(torch.int64))
    with pytest.raises(TypeError, match="c_topo_rank"):
        cuda_ffd._launch_batched(one[0], bad, one[2], req.level_iters)
    assert len(lib.calls) == 2
    cuda_ffd.counter.reset()


# ---------------------------------------------------------------------------
# solves


def _scheduler_pair(existing, pods, backend="reference"):
    pools = [make_nodepool()]
    its = {"default": list(small_catalog())}
    port_in = interop.from_reference((pools, its, existing, pods))
    _align_hostnames()
    ref = jprov.DeviceScheduler(copy.deepcopy(pools), its,
                                existing_nodes=copy.deepcopy(existing),
                                max_slots=64)
    r_ref = ref.solve(copy.deepcopy(pods))
    port = tprov.DeviceScheduler(port_in[0], port_in[1],
                                 existing_nodes=port_in[2], max_slots=64,
                                 device="cpu", kernel_backend=backend)
    r_port = port.solve(port_in[3])
    return r_ref, r_port


def _hostile():
    pods = ranked_gang(size=4, max_hops=None)
    for i, p in enumerate(pods):
        ann = p.metadata.annotations
        ann[GANG_MAX_HOPS_ANNOTATION] = "888888888888888888888888888"
        ann[GANG_RANK_ANNOTATION] = str(10 ** 30 + i)
    neg = ranked_gang(name="neg", size=2, max_hops=None)
    for p in neg:
        p.metadata.annotations[GANG_MAX_HOPS_ANNOTATION] = "-5"
        p.metadata.annotations[GANG_RANK_ANNOTATION] = "-9999999"
    return racked_existing(with_topo=True), pods + neg


SOLVES = {
    # TestOffByDefaultTopoParity
    "rackless_gang": lambda: (racked_existing(with_topo=False),
                              ranked_gang(size=4, max_hops=2)),
    "racked_no_gangs": lambda: (racked_existing(with_topo=True),
                                [make_pod(cpu=1.0, name=f"plain-{i}")
                                 for i in range(6)]),
    # TestEngagedSolve
    "inside_bound_ranks_adjacent": lambda: (
        racked_existing(with_topo=True), ranked_gang(size=4, max_hops=2)),
    "unsatisfiable_bound": lambda: (
        racked_existing(with_topo=True, available_cpu=3.5),
        ranked_gang(size=4, max_hops=0)),
    "ceiling_bound_soft": lambda: (
        racked_existing(with_topo=True, available_cpu=3.5),
        ranked_gang(size=4, max_hops=MAX_HOP_DISTANCE)),
    "hostile_annotations": _hostile,
    # more than one gang over a bigger racked fleet
    "two_gangs_racked": lambda: (
        racked_existing(n=16, with_topo=True),
        ranked_gang(name="ga", size=4) + ranked_gang(name="gb", size=4)),
}


@pytest.mark.parametrize("name", list(SOLVES))
def test_result_wire_identical(name):
    rejected0 = dict(port_metrics.SOLVER_RESULT_REJECTED.values)
    existing, pods = SOLVES[name]()
    r_ref, r_port = _scheduler_pair(existing, pods)
    assert _wire(to_reference(r_port)) == _wire(r_ref), name
    assert dict(port_metrics.SOLVER_RESULT_REJECTED.values) == rejected0


def test_engaged_gang_lands_inside_bound_ranks_adjacent():
    existing = racked_existing(with_topo=True)
    pods = ranked_gang(size=4, max_hops=2)
    _, r_port = _scheduler_pair(existing, pods, backend="cuda")
    assert not r_port.pod_errors
    truth = {n.name: dict(n.labels) for n in existing}
    placed = {p.metadata.name: truth[s.name]
              for s in r_port.existing_nodes for p in s.pods}
    labs = [placed[f"tgang-{i}"] for i in range(4)]
    assert jgangs.placement_hop_bound(labs) <= 2
    keys = [jgangs.topo_sort_key(lab) for lab in labs]
    assert keys == sorted(keys)


def test_racked_catalog_without_gangs_never_prepares(monkeypatch):
    def boom(self, *a, **kw):
        raise AssertionError("rack-aware preparation on a gang-free solve")

    monkeypatch.setattr(tprov.DeviceScheduler, "_prepare_topoaware", boom)
    existing, pods = SOLVES["racked_no_gangs"]()
    _, r_port = _scheduler_pair(existing, pods)
    assert not r_port.pod_errors


def test_rackless_gang_never_gets_a_level_plane():
    existing, pods = SOLVES["rackless_gang"]()
    pools, its, existing, pods = interop.from_reference(
        ([make_nodepool()], {"default": list(small_catalog())}, existing,
         pods))
    gen = tprov.DeviceScheduler(pools, its, existing_nodes=existing,
                                max_slots=64, device="cpu")._solve_gen(pods)
    req = gen.send(None)
    gen.close()
    assert req.gang_of_step is not None and req.steps.topo_rank is None
