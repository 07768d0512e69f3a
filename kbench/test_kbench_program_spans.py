"""The per-layer metrics read from the program's own spans
(``kbench/lib/program_spans.py``): a ``--trace 1`` run of the tiny cells
on the CPU reads the three host metrics as numbers and leaves out the two
device ones; the window keeps exactly the window's calls, not the warm
ones before it nor the traced ones after it; a program without the span
log, or a log that no longer reaches the window's start, reads nothing."""
import collections
import sys
import time

import pytest

from kbench import tiny
from kbench.lib import program_spans

HOST = {tiny.DIVERSE: ["decode_commit_ms.provision"],
        tiny.SWEEP: ["sweep_prepare_ms.sweep", "prepare_nodes_ms.sweep"]}
DEVICE = {tiny.DIVERSE: "device_ms.provision", tiny.SWEEP: "device_ms.sweep"}
ROOTS = {tiny.DIVERSE: "solve", tiny.SWEEP: "sweep"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("spans"))


@pytest.mark.parametrize("cell", sorted(HOST))
def test_traced_run_reads_the_host_spans(root, cell, monkeypatch):
    kept = []
    real = program_spans.window

    def spy(ctx):
        out = real(ctx)
        kept.append((len(ctx.records), out))
        return out

    monkeypatch.setattr(program_spans, "window", spy)
    out = tiny.run(root, cell, seconds=1.0, trace=True)
    assert out["correct"], out["checks"]
    for name in HOST[cell]:
        value = out["metrics"][name]["value"]
        assert isinstance(value, float) and value > 0, name
    assert DEVICE[cell] not in out["metrics"]
    assert kept
    for n_records, reqs in kept:
        # one request a window call, each rooted at the entry's own span
        assert len(reqs) == n_records
        assert all(spans[0].name == ROOTS[cell] for spans in reqs.values())


class _Ctx:
    def __init__(self, records):
        self.entry, self.records, self.trace = "provision", records, None
        self.lines = []
        self.log = self.lines.append


def _solve():
    """One fake request: a ``solve`` root over a ``decode.commit``."""
    from karpenter_core_tpu_torch import tracing

    t0 = time.perf_counter()
    with tracing.span("solve", tracing.new_request()):
        with tracing.span("decode.commit") as s:
            s.count("fresh_slots", 3)
    t1 = time.perf_counter()
    return {"t_end": t1, "dt": t1 - t0}


def test_window_leaves_out_the_calls_before_and_after(monkeypatch):
    from karpenter_core_tpu_torch import tracing

    monkeypatch.setattr(tracing, "LOG", collections.deque(maxlen=64))
    for _ in range(3):
        _solve()  # warm
    records = [_solve() for _ in range(4)]
    for _ in range(2):
        _solve()  # traced
    ctx = _Ctx(records)
    reqs = program_spans.window(ctx)
    assert len(reqs) == 4
    starts = sorted(spans[0].start for spans in reqs.values())
    assert starts[0] >= records[0]["t_end"] - records[0]["dt"]
    assert max(spans[0].end for spans in reqs.values()) <= (
        records[-1]["t_end"])
    assert program_spans.per_request(ctx, "decode.commit", "fresh_slots") == [
        3, 3, 3, 3]
    assert program_spans.per_request(ctx, "decode.commit", "device_s") is None


def test_window_needs_a_log_that_reaches_its_start(monkeypatch):
    from karpenter_core_tpu_torch import tracing

    monkeypatch.setattr(tracing, "LOG", collections.deque(maxlen=4))
    records = [_solve() for _ in range(4)]
    ctx = _Ctx(records)
    assert program_spans.window(ctx) is None
    assert any("does not reach back" in line for line in ctx.lines)


def test_a_program_without_spans_reads_nothing(monkeypatch):
    import karpenter_core_tpu_torch

    monkeypatch.delattr(karpenter_core_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "karpenter_core_tpu_torch.tracing", None)
    assert program_spans.window(_Ctx([{"t_end": 1.0, "dt": 0.5}])) is None
