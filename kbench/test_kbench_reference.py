"""The plain reference against the port's plain scan at small sizes on
the CPU; the control and each fault a cell can have come out not
correct."""
import copy
import json
from pathlib import Path

import pytest

from kbench import tiny
from kbench.entries import provision
from kbench.lib import catalog, gen, port
from kbench.reference import check, control, pack, sweep

KB = Path(__file__).resolve().parent


def _load(kind, name):
    return json.loads((KB / kind / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("kbench"))


def _small(name, **over):
    t = json.loads((KB / "traffic" / f"{name}.json").read_text())
    t.update(over)
    return t


@pytest.mark.parametrize("traffic,n", [("diverse-5k", 150),
                                       ("generic-50k", 600)])
def test_check_passes_the_port_solve(traffic, n):
    import torch

    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler

    torch.set_num_threads(2)
    cfg = _load("configs", "fake-400t")
    t = _small(traffic, pods=n)
    rows = catalog.catalog_rows(cfg["catalog"])
    backlog = gen.backlog(t, 5, 0)
    pods = port.pods(backlog, t)
    sched = DeviceScheduler(
        [port.nodepool(cfg["nodepool"])],
        {"default": port.instance_types(rows)}, max_slots=64, device="cpu",
        kernel_backend="reference")
    answer = port.answer_rows(sched.solve(pods), pods)
    got = check.check(backlog, rows, t, answer)
    assert got["violations"] == 0, got
    assert got["unplaced"] == 0
    assert got["options_wrong"] <= provision.LIMITS["options_wrong"][0]
    assert got["nodeclaims"] >= got["nodeclaims_lower_bound"]
    want = check.check(backlog, rows, t, pack.pack(backlog, rows, t))
    assert (want["violations"], want["options_wrong"]) == (0, 0), want
    assert got["nodeclaims"] == want["nodeclaims"]
    assert got["price"] / want["price"] <= provision.LIMITS["price_ratio"][0]


def test_sweep_reference_equals_the_port_frontier():
    import torch

    from karpenter_core_tpu_torch.models import consolidation as cons

    torch.set_num_threads(2)
    cfg = _load("configs", "consol-5k")
    cfg["cluster"].update(nodes=60, candidates=10, max_slots=128)
    t = _load("traffic", "sweep")
    rows = catalog.catalog_rows(cfg["catalog"])
    its = {"default": port.instance_types(rows)}
    pool = port.nodepool(cfg["nodepool"])
    for seed in (1, 2):
        st = gen.sweep_state(cfg, t, rows, seed, seed)
        nodes = port.sim_nodes(st, "default")
        got = cons.frontier_core(
            [pool], its, nodes[:10], nodes[10:], [], [],
            [port.pods(p, t) for p in st["candidate_pods"]],
            max_slots=128, device="cpu", kernel_backend="reference")
        want = sweep.verdicts(st, rows, 128)
        assert [(g[0], g[1]) for g in got] == [(w[0], w[1]) for w in want]
        assert any(w[1] > 0 for w in want)
        for g, w in zip(got, want):
            assert g[2] == pytest.approx(w[2], rel=1e-6)


@pytest.mark.parametrize("traffic,broken", [
    ("diverse-5k", "topology"), ("diverse-5k", "memory"),
    ("generic-50k", "memory")])
def test_control_is_not_correct(traffic, broken):
    cfg = _load("configs", "fake-400t")
    t = _small(traffic, pods=600)
    rows = catalog.catalog_rows(cfg["catalog"])
    for seed in (1, 2, 3):
        backlog = gen.backlog(t, seed, 0)
        got = check.check(backlog, rows, t,
                          control.solve(backlog, rows, t, broken))
        assert got["violations"] > 0, got


def test_sweep_control_is_not_correct():
    cfg = _load("configs", "consol-5k")
    t = _load("traffic", "sweep")
    rows = catalog.catalog_rows(cfg["catalog"])
    for seed in (1, 2, 3):
        st = gen.sweep_state(cfg, t, rows, seed, 0)
        want = sweep.verdicts(st, rows, 2560)
        got = control.sweep(st, rows, 2560)
        assert [g[:2] for g in got] != [w[:2] for w in want]


def _provision_fault(monkeypatch, fault):
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler

    solve = DeviceScheduler.solve
    last = {}

    def broken(self, pods):
        if fault == "half":
            return solve(self, pods[: len(pods) // 2])
        res = solve(self, pods)
        if fault == "stale":
            prev, last["res"] = last.get("res"), res
            return prev if prev is not None else res
        if fault == "altered":  # the first NodeClaim's type: the smallest
            small = min(self.instance_types["default"],
                        key=lambda it: it.capacity["cpu"])
            res.new_node_claims[0].instance_type_options = [small]
        if fault == "costliest":  # each NodeClaim keeps its costliest type
            for c in res.new_node_claims:
                c.instance_type_options = [max(
                    c.instance_type_options,
                    key=lambda it: it.offerings.cheapest().price)]
        if fault == "one_per_claim":  # every pod on a NodeClaim of its own
            claims = []
            for c in res.new_node_claims:
                for p in c.pods:
                    one = copy.copy(c)
                    one.pods = [p]
                    claims.append(one)
            res.new_node_claims = claims
        return res

    monkeypatch.setattr(DeviceScheduler, "solve", broken)


def _sweep_fault(monkeypatch, fault):
    from karpenter_core_tpu_torch.models import consolidation as cons

    core = cons.frontier_core
    last = {}

    def broken(pools, types, cand, keep, ds, base, cand_pods, **kw):
        if fault == "half":
            cand_pods = [p[: len(p) // 2] for p in cand_pods]
        got = core(pools, types, cand, keep, ds, base, cand_pods, **kw)
        if fault == "stale":
            prev, last["got"] = last.get("got"), got
            return prev if prev is not None else got
        if fault == "altered":
            s, n, b = got[-1]
            got[-1] = (s, n + 1, b)
        return got

    monkeypatch.setattr(cons, "frontier_core", broken)


@pytest.mark.parametrize("workload", [tiny.DIVERSE, tiny.GENERIC])
@pytest.mark.parametrize("fault", ["stale", "half", "altered", "costliest",
                                   "one_per_claim"])
def test_provision_fault_is_not_correct(root, monkeypatch, fault, workload):
    _provision_fault(monkeypatch, fault)
    out = tiny.run(root, workload, seconds=2.5)
    assert out["attempted"] >= 1
    assert out["correct"] is False, out["checks"]
    if fault == "costliest":
        assert out["checks"]["price_ratio"]["value"] > (
            out["checks"]["price_ratio"]["limit"])
    if fault == "one_per_claim":
        assert out["checks"]["nodeclaims_ratio"]["value"] > (
            out["checks"]["nodeclaims_ratio"]["limit"])


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_sweep_fault_is_not_correct(root, monkeypatch, fault):
    _sweep_fault(monkeypatch, fault)
    out = tiny.run(root, tiny.SWEEP, seconds=3.0)
    assert out["attempted"] >= 1
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", [tiny.DIVERSE, tiny.GENERIC, tiny.SWEEP])
def test_sound_run_is_correct(root, workload):
    out = tiny.run(root, workload, seconds=1.0)
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"
