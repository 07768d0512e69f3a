"""The port's spans (``karpenter_core_tpu_torch/tracing.py``) on the CPU.

* A topology solve and a topology-free solve each give ``solve`` over
  ``plan``, ``prepare``, ``dispatch``, ``fetch``, ``decode`` and
  ``verify``, all under the solve's request id (``last_phase_stats
  ["request"]``); two solves get two ids; each child lies within its
  parent; ``plan_s``, ``prepare_s``, ``decode_s`` and ``verify_s`` are
  their spans' durations summed, and ``SOLVER_PREPARE_DURATION`` and
  ``SOLVER_DECODE_DURATION`` take one observation a round, the span's
  duration.
* ``solve_batch``: the batched dispatch's span names every member's id,
  and each member's spans nest under its own ``solve`` though the
  members' generators interleave on one thread. The call's span
  ``batch`` names them too, encloses their solves and counts the call's
  stats and ``solo_retries`` (the members re-run solo after a batched
  dispatch failed, none after a sticky CUDA error); the batched
  dispatch's ``dispatch.stack`` and ``dispatch.gather`` nest under it.
* ``frontier_core``: ``sweep`` over ``sweep.problem`` over ``prepare``
  over ``prepare.nodes``, under one id.
* The log keeps its newest ``CAPACITY`` records; ``karpenter.*`` ranges
  reach a ``torch.profiler`` trace and no range is entered without one.
* ``decode.commit`` counts ``fresh_slots``, the committed fresh topology
  slots, and ``types_tested``, their viable instance types summed.
* The first ``prepare.nodes`` of a prepare counts the existing-node rows
  it built: ``rows_bulk`` from the labels in bulk, ``rows_per_node`` for
  nodes holding a key beside its deprecated alias. A solve's second
  ``prepare.nodes`` counts the ``sims`` it built, one a node; a sweep's
  decision builds none and has no second span.
* A solve's ``verify`` span counts the port's verify pass:
  ``spread_constraints`` and ``label_sets``, both 0 on a topology-free
  solve. The scheduler verifies through the pass; the sidecar client,
  a verbatim copy, through the verbatim ``ResultVerifier``.
* ``device_s`` is absent on CPU tensors; with a stand-in timer a solve's
  ``device_s`` is its dispatches' device seconds, a batched dispatch's
  split over its members, read once the solve or sweep ends, and no
  timer is left filed under a finished request.
"""
import inspect
import itertools
import time

import pytest
import torch

import bench_torch
import chip_smoke
from tests.torch_threads import one_torch_thread  # noqa: F401

from karpenter_core_tpu_torch import tracing
from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
from karpenter_core_tpu_torch.metrics import wiring as m
from karpenter_core_tpu_torch.models import consolidation as cons
from karpenter_core_tpu_torch.models import provisioner as prov

PHASES = ("plan", "prepare", "dispatch", "fetch", "decode", "verify")
STATS = {"plan": "plan_s", "prepare": "prepare_s", "decode": "decode_s",
         "verify": "verify_s"}
PROBLEMS = {
    "topology": lambda: bench_torch._topology_pods(60),
    "plain": lambda: bench_torch._plain_pods(48),
}


def _scheduler():
    return prov.DeviceScheduler(
        [bench_torch._pool()], {"default": list(bench_catalog(24))},
        max_slots=64, device="cpu", kernel_backend="reference")


def _spans_of(rid):
    return [s for s in tracing.LOG if rid in s.requests]


def _within(child, parent):
    return parent.start <= child.start and child.end <= parent.end


@pytest.fixture
def observed(monkeypatch):
    """The values each phase histogram observes."""
    seen = {"prepare": [], "decode": []}
    for name, hist in (("prepare", m.SOLVER_PREPARE_DURATION),
                       ("decode", m.SOLVER_DECODE_DURATION)):
        monkeypatch.setattr(hist, "observe",
                            lambda v, labels=None, _n=name: seen[_n].append(v))
    return seen


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_solve_spans_share_one_request(problem, observed):
    sched = _scheduler()
    sched.solve(PROBLEMS[problem]())
    stats = sched.last_phase_stats
    rid = stats["request"]
    spans = _spans_of(rid)
    (root,) = [s for s in spans if s.name == "solve"]
    assert root.parent is None and root.requests == (rid,)
    names = {s.name for s in spans if s.parent is root}
    assert set(PHASES) <= names
    for s in spans:
        assert s.requests == (rid,)
        if s is not root:
            assert s.parent is not None and _within(s, s.parent), s.name
    for name, key in STATS.items():
        assert stats[key] == sum(s.dt for s in spans if s.name == name)
    assert stats["rounds"] == 1
    for name in ("prepare", "decode"):
        assert observed[name] == [s.dt for s in spans if s.name == name]
    # the children of prepare and decode
    kids = {s.name for s in spans if s.parent is not None
            and s.parent.name in ("prepare", "decode")}
    assert {"prepare.vocab", "prepare.nodes", "prepare.classes",
            "prepare.state", "decode.commit", "decode.replay"} <= kids
    assert ({"decode.densify", "decode.sync"} <= kids) == (
        problem == "topology")
    assert ("decode.repack" in kids) == (problem == "plain")
    (commit,) = [s for s in spans if s.name == "decode.commit"]
    assert commit.counts["fresh_slots"] > 0
    assert ("types_tested" in commit.counts) == (problem == "topology")


def test_types_tested_counts_viable_types_of_fresh_slots(monkeypatch):
    """On a topology solve ``decode.commit``'s ``types_tested`` is the number
    of viable instance types summed over the committed fresh slots, and
    ``fresh_slots`` the number of those slots."""
    slots = []
    commit = prov.DeviceScheduler._commit_fresh_topo

    def spy(*args, **kw):
        a = inspect.signature(commit).bind(*args, **kw).arguments
        before = len(a["claims"])
        tested = commit(*args, **kw)
        viable = int(a["itmask"][a["n"], :len(a["prep"].catalog)].sum())
        slots.append((viable, len(a["claims"]) > before))
        assert tested == viable
        return tested

    monkeypatch.setattr(prov.DeviceScheduler, "_commit_fresh_topo", spy)
    sched = _scheduler()
    sched.solve(PROBLEMS["topology"]())
    rid = sched.last_phase_stats["request"]
    (span,) = [s for s in _spans_of(rid) if s.name == "decode.commit"]
    assert slots and all(committed for _, committed in slots)
    assert span.counts["fresh_slots"] == len(slots)
    assert span.counts["types_tested"] == sum(v for v, _ in slots) > 0


def test_two_solves_get_two_ids():
    sched = _scheduler()
    pods = bench_torch._plain_pods(16)
    sched.solve(pods)
    first = sched.last_phase_stats["request"]
    sched.solve(pods)
    second = sched.last_phase_stats["request"]
    assert first != second
    assert {s.name for s in _spans_of(first)} == {
        s.name for s in _spans_of(second)}


def test_batched_dispatch_names_every_member():
    a, b, c = _scheduler(), _scheduler(), _scheduler()
    pods = bench_torch._plain_pods(32)
    outcomes, stats = prov.solve_batch([(a, pods), (b, pods), (c, pods)])
    assert stats["batched_dispatches"] == 1
    assert all(status == "ok" for status, _ in outcomes)
    rids = [s.last_phase_stats["request"] for s in (a, b, c)]
    assert len(set(rids)) == 3
    (batched,) = [s for s in tracing.LOG if s.name == "dispatch"
                  and set(rids) <= set(s.requests)]
    assert batched.requests == tuple(rids) and batched.parent is None
    # the spans serving all three: the call, the batched dispatch and the
    # dispatch's own parts
    (call,) = [s for s in tracing.LOG if s.name == "batch"
               and set(rids) <= set(s.requests)]
    shared = {call, batched} | {s for s in tracing.LOG
                                if s.parent is batched}
    for rid in rids:
        spans = _spans_of(rid)
        (root,) = [s for s in spans if s.name == "solve"]
        for s in spans:
            if s is not root and s not in shared:
                assert s.requests == (rid,)
                assert s.parent is not None and _within(s, s.parent)
                top = s
                while top.parent is not None:
                    top = top.parent
                assert top is root, s.name


def _batch_span(rids):
    (call,) = [s for s in tracing.LOG if s.name == "batch"
               and set(rids) <= set(s.requests)]
    return call


def test_batch_span_counts_the_call():
    """``batch`` covers the call, names every member's request and counts
    what ``solve_batch`` returns, with no solo re-run; the batched
    dispatch's ``dispatch.stack`` and ``dispatch.gather`` nest under it."""
    scheds = [_scheduler() for _ in range(3)]
    wide = prov.DeviceScheduler(
        [bench_torch._pool()], {"default": list(bench_catalog(24))},
        max_slots=128, device="cpu", kernel_backend="reference")
    pods = bench_torch._plain_pods(32)
    outcomes, stats = prov.solve_batch(
        [(s, pods) for s in scheds] + [(wide, pods)])
    assert all(status == "ok" for status, _ in outcomes)
    assert stats["batched_dispatches"] == 1 and stats["dispatches"] == 2
    rids = [s.last_phase_stats["request"] for s in scheds + [wide]]
    call = _batch_span(rids)
    assert call.requests == tuple(rids) and call.parent is None
    assert call.counts == dict(stats, solo_retries=0)
    for rid in rids:
        (root,) = [s for s in _spans_of(rid) if s.name == "solve"]
        assert _within(root, call)
    (batched,) = [s for s in tracing.LOG if s.name == "dispatch"
                  and len(s.requests) == 3 and set(s.requests) <= set(rids)]
    parts = [s for s in tracing.LOG if s.parent is batched]
    assert sorted(s.name for s in parts) == ["dispatch.gather",
                                             "dispatch.stack"]
    for s in parts:
        assert s.requests == batched.requests and _within(s, batched)
    stack, gather = sorted(parts, key=lambda s: s.start)
    assert stack.name == "dispatch.stack" and stack.end <= gather.start


@pytest.mark.parametrize("error", ["plain", "sticky"])
def test_batch_span_counts_solo_retries(monkeypatch, error):
    """A batched dispatch that raises: its members re-run solo and
    ``solo_retries`` counts them, unless the error is a sticky CUDA error,
    which re-runs none."""
    sticky = "CUDA error: an illegal memory access was encountered"

    def broken(*args, **kwargs):
        raise RuntimeError(sticky if error == "sticky" else "scan failed")

    monkeypatch.setattr(prov, "ffd_solve_batched", broken)
    scheds = [_scheduler() for _ in range(3)]
    pods = bench_torch._plain_pods(32)
    outcomes, stats = prov.solve_batch([(s, pods) for s in scheds])
    retries = 3 if error == "plain" else 0
    assert [status for status, _ in outcomes] == (
        ["ok"] * 3 if error == "plain" else ["error"] * 3)
    assert stats["batched_dispatches"] == 0
    assert stats["dispatches"] == 1 + retries
    call = _batch_span([s.last_phase_stats["request"] for s in scheds])
    assert call.counts == dict(stats, solo_retries=retries)


def test_frontier_spans():
    inputs = chip_smoke.sweep_inputs(n_nodes=8, n_cand=6, n_types=16)
    t0 = time.perf_counter()
    got = cons.frontier_core(max_slots=64, device="cpu",
                             kernel_backend="reference", **inputs)
    assert len(got) == 6
    spans = [s for s in tracing.LOG if s.start >= t0]
    (root,) = [s for s in spans if s.name == "sweep"]
    rid = root.request
    assert rid is not None and root.parent is None
    assert all(s.requests == (rid,) for s in spans)
    by = {s.name: s for s in spans}
    problem = by["sweep.problem"]
    assert problem.parent is root
    assert {s.name for s in spans if s.parent is problem} == {
        "sweep.scheduler", "prepare", "sweep.batches"}
    nodes = [s for s in spans if s.name == "prepare.nodes"]
    assert nodes and all(s.parent is by["prepare"] for s in nodes)
    assert by["prepare"].parent is problem
    assert by["sweep.scan"].parent is root
    assert by["sweep.readback"].parent is root
    for s in spans:
        if s is not root:
            assert _within(s, s.parent), s.name
    # on CPU tensors no scan carries device time
    assert all(not (s.counts or {}).get("device_s") for s in spans)


def _node_spans(t0):
    return [s for s in tracing.LOG
            if s.start >= t0 and s.name == "prepare.nodes"]


def test_sweep_counts_bulk_rows_and_no_sims():
    inputs = chip_smoke.sweep_inputs(n_nodes=8, n_cand=6, n_types=16)
    E = len(inputs["cand_nodes"]) + len(inputs["keep_nodes"])
    t0 = time.perf_counter()
    cons.frontier_core(max_slots=64, device="cpu",
                       kernel_backend="reference", **inputs)
    (rows,) = _node_spans(t0)
    assert rows.counts == {"rows_bulk": E, "rows_per_node": 0}
    assert rows.counts.get("sims", 0) == 0


@pytest.mark.parametrize("alias", [False, True])
def test_solve_counts_rows_and_sims(alias):
    """A solve over existing nodes counts its rows, then one sim a node; a
    node holding a key beside its deprecated alias counts as a row built
    alone."""
    inputs = chip_smoke.sweep_inputs(n_nodes=5, n_cand=2, n_types=16)
    nodes = inputs["cand_nodes"] + inputs["keep_nodes"]
    if alias:
        zone = "topology.kubernetes.io/zone"
        nodes[1].labels["failure-domain.beta.kubernetes.io/zone"] = (
            nodes[1].labels[zone])
    sched = prov.DeviceScheduler(
        inputs["nodepools"], inputs["instance_types"], existing_nodes=nodes,
        max_slots=64, device="cpu", kernel_backend="reference")
    t0 = time.perf_counter()
    sched.solve(bench_torch._plain_pods(12))
    rows, sims = _node_spans(t0)
    assert rows.start < sims.start
    assert rows.counts == {"rows_bulk": len(nodes) - alias,
                           "rows_per_node": int(alias)}
    assert sims.counts == {"sims": len(nodes)}
    assert rows.parent is sims.parent and rows.parent.name == "prepare"


# the topology problem's 60 pods (bench_torch._topology_pods): ten zone
# spread and ten hostname spread cohorts, one hard constraint each; label
# sets {} and anti-0..9 of the pods without spread constraints, and the
# twenty cohorts' own
VERIFY_COUNTS = {"topology": {"spread_constraints": 20, "label_sets": 31},
                 "plain": {"spread_constraints": 0, "label_sets": 0}}


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_verify_span_counts_the_pass(problem):
    """A solve's ``verify`` span counts ``spread_constraints``, the distinct
    hard spread constraints its pass tallied, and ``label_sets``, the
    distinct label sets whose selector matches it computed: none on a
    topology-free solve. ``verify_s`` is still the span's duration, and the
    scheduler verifies through the port's pass."""
    from karpenter_core_tpu_torch.models.verify_pass import VerifyPass

    sched = _scheduler()
    pods = PROBLEMS[problem]()
    result = sched.solve(pods)
    assert not result.pod_errors
    stats = sched.last_phase_stats
    (span,) = [s for s in _spans_of(stats["request"]) if s.name == "verify"]
    assert span.counts == VERIFY_COUNTS[problem]
    assert stats["verify_s"] == span.dt > 0
    assert type(sched._verifier) is VerifyPass
    # a second solve counts its own call
    sched.solve(PROBLEMS[problem]())
    (again,) = [s for s in _spans_of(sched.last_phase_stats["request"])
                if s.name == "verify"]
    assert again.counts == VERIFY_COUNTS[problem]


def test_sidecar_client_keeps_the_verbatim_verifier(monkeypatch):
    """The sidecar client (``solver/remote.py``, a verbatim copy) verifies
    its answers with the verbatim ``ResultVerifier``."""
    from karpenter_core_tpu_torch.solver import remote, service
    from karpenter_core_tpu_torch.solver import verify as verifymod

    used = []
    plain = verifymod.ResultVerifier.verify

    def spy(self, results, pods):
        used.append(type(self))
        return plain(self, results, pods)

    monkeypatch.setattr(verifymod.ResultVerifier, "verify", spy)
    srv = service.serve(0, daemon=service.SolverDaemon(
        device="cpu", kernel="reference"))
    try:
        client = remote.SolverClient(
            f"127.0.0.1:{srv.server_address[1]}", timeout=120)
        result = remote.RemoteScheduler(
            client, [bench_torch._pool()],
            {"default": list(bench_catalog(24))}).solve(
                bench_torch._topology_pods(24))
    finally:
        srv.shutdown()
        srv.server_close()
    assert result.new_node_claims and not result.pod_errors
    assert used == [verifymod.ResultVerifier]


def test_log_keeps_the_newest_records():
    assert tracing.CAPACITY >= 65536
    assert tracing.LOG.maxlen == tracing.CAPACITY
    rid = tracing.new_request()
    for _ in range(tracing.CAPACITY + 10):
        with tracing.span("fill", rid):
            pass
    assert len(tracing.LOG) == tracing.CAPACITY
    assert all(s.name == "fill" for s in tracing.LOG)


def test_profiler_ranges_only_under_a_profiler(monkeypatch):
    sched = _scheduler()
    pods = bench_torch._topology_pods(30)
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    sched.solve(pods)
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sched.solve(pods)
    names = {e.name for e in prof.events()}
    for name in ("solve",) + PHASES + ("decode.commit", "prepare.nodes"):
        assert tracing.PREFIX + name in names, name
    assert set(entered) <= {tracing.PREFIX + s.name for s in tracing.LOG}
    entered.clear()
    sched.solve(pods)
    assert entered == []


def test_no_device_time_on_cpu():
    sched = _scheduler()
    sched.solve(bench_torch._plain_pods(16))
    rid = sched.last_phase_stats["request"]
    assert "device_s" not in sched.last_phase_stats
    assert all(not s.counts or "device_s" not in s.counts
               for s in _spans_of(rid))


class _FakeTimer(tracing.DeviceTimer):
    """A DeviceTimer on any device, with fixed device seconds."""

    values = itertools.count(1)

    @classmethod
    def begin(cls, device, span, members=1):
        timer = cls(device, span, members)
        timer.value = 0.001 * next(cls.values)
        return timer

    def _event(self):
        return None

    def seconds(self):
        self.span.counts = dict(self.span.counts or {}, device_s=self.value)
        return self.value


def test_device_time_is_summed_per_solve(monkeypatch):
    monkeypatch.setattr(tracing, "DeviceTimer", _FakeTimer)
    sched = _scheduler()
    sched.solve(bench_torch._plain_pods(32))
    stats = sched.last_phase_stats
    dispatches = [s for s in _spans_of(stats["request"])
                  if s.name == "dispatch"]
    assert len(dispatches) == stats["rounds"] == 1
    assert stats["device_s"] == dispatches[0].counts["device_s"] > 0

    a, b = _scheduler(), _scheduler()
    pods = bench_torch._plain_pods(32)
    prov.solve_batch([(a, pods), (b, pods)])
    (batched,) = [s for s in tracing.LOG if s.name == "dispatch"
                  and len(s.requests) == 2]
    for sched in (a, b):
        assert sched.last_phase_stats["device_s"] == pytest.approx(
            batched.counts["device_s"] / 2, rel=1e-12)
    assert not tracing._pending


def test_sweep_scan_device_time(monkeypatch):
    monkeypatch.setattr(tracing, "DeviceTimer", _FakeTimer)
    inputs = chip_smoke.sweep_inputs(n_nodes=8, n_cand=6, n_types=16)
    t0 = time.perf_counter()
    cons.frontier_core(max_slots=64, device="cpu",
                       kernel_backend="reference", **inputs)
    (scan,) = [s for s in tracing.LOG
               if s.start >= t0 and s.name == "sweep.scan"]
    assert scan.counts["device_s"] > 0
    assert not tracing._pending
