"""The frozen roofline arithmetic gives the port's smoke arithmetic's
numbers (``chip_smoke._bound_terms`` / ``_stack_bound``) on a small sweep
problem built on the CPU."""
import json
from pathlib import Path

import pytest

from kbench.lib import catalog, gen, port, roofline

KB = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def problem():
    import torch

    from karpenter_core_tpu_torch.models import consolidation as cons

    torch.set_num_threads(2)
    cfg = json.loads((KB / "configs/consol-5k.json").read_text())
    cfg["cluster"].update(nodes=40, candidates=8, max_slots=64)
    t = json.loads((KB / "traffic/sweep.json").read_text())
    rows = catalog.catalog_rows(cfg["catalog"])
    st = gen.sweep_state(cfg, t, rows, 3, 0)
    nodes = port.sim_nodes(st, "default")
    return cons.sweep_problem(
        [port.nodepool(cfg["nodepool"])],
        {"default": port.instance_types(rows)}, nodes[:8], nodes[8:], [], [],
        [port.pods(p, t) for p in st["candidate_pods"]], max_slots=64,
        device="cpu", kernel_backend="reference")


def test_stack_bound_equals_the_smoke_arithmetic(problem):
    import chip_smoke
    from karpenter_core_tpu_torch.models import consolidation as cons
    from karpenter_core_tpu_torch.ops import cuda_ffd
    from karpenter_core_tpu_torch.ops.ffd import LEVEL_ITERS

    _sched, prep, classes, kind_batch, count_batch = problem
    stack = cons.prefix_stack(cuda_ffd.pack_state(prep.init_state), classes,
                              prep.statics, kind_batch, count_batch)
    final, takes, unplaced = cuda_ffd.cuda_ffd_solve_prefixes(
        *stack, LEVEL_ITERS)
    want_ms, want_by = chip_smoke._stack_bound(stack[0], stack[1], stack[2],
                                               final, takes, unplaced)
    kind0 = (final.kind == 1).to(final.kind.dtype)
    assert bool((kind0 == (stack[0].kind > 0).to(kind0.dtype)).all())
    got_s, got_by = roofline.bound_s([roofline.stack_terms(
        kind0, stack[1], stack[2], final, takes, unplaced)])
    assert got_by == want_by
    assert got_s * 1e3 == pytest.approx(want_ms, rel=1e-12)


def test_solo_bound_equals_the_smoke_arithmetic(problem):
    import chip_smoke
    from karpenter_core_tpu_torch.ops import cuda_ffd

    _sched, prep, classes, _kb, _cb = problem
    out = cuda_ffd.cuda_ffd_solve(prep.init_state, classes, prep.statics)
    want = chip_smoke._bound_terms(prep.init_state, classes, prep.statics,
                                   *out)
    got = roofline.solo_terms(prep.init_state, classes, prep.statics, *out)
    assert got[0] == want[0]
    assert got[1] == pytest.approx(want[1], rel=1e-12)
    assert got[1] > 0
