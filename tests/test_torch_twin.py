"""The port's digital twin against the JAX package's twin.

Each scenario is built once with the reference's recipe
(tests/test_twin.py), carried to the port as its JSON (a scenario is
data: the codec and fingerprint must be the reference's byte for byte),
and run by both twins in this process: the JAX twin as its own tests run
it, the port's with ``device="cpu", kernel="reference"``. With no tier
fault, the port must give the JAX twin's event trace and ledger JSON byte
for byte. The invariant monitor's and the scenario codec's unit cases of
tests/test_twin.py run on the port's copies (tests/torch_ported.py), and
the committed shrinker fixtures replay to their verdicts.
"""
import functools
from pathlib import Path

import pytest
import torch

import chip_smoke
from tests import test_twin as jt
from tests.torch_ported import ported
from tests.torch_threads import one_torch_thread  # noqa: F401

from karpenter_core_tpu.metrics import wiring as jwiring
from karpenter_core_tpu.twin import harness as jharness
from karpenter_core_tpu.twin import scenario as jscenario
from karpenter_core_tpu.twin import replay as jreplay
from karpenter_core_tpu_torch import twin as ptwin
from karpenter_core_tpu_torch.metrics import wiring as pwiring
from karpenter_core_tpu_torch.twin import harness as pharness

CPU = dict(device="cpu", kernel="reference")
FIXTURES = Path(__file__).parent / "twin_fixtures"

# tests/test_twin.py on the port, its twin runs on the CPU
_ref = ported("test_twin")
_ref.run_scenario = functools.partial(pharness.run_scenario, **CPU)
_ref.replay = functools.partial(ptwin.replay, **CPU)
_ref.shrink = functools.partial(ptwin.shrink, **CPU)
_ref.fuzz = functools.partial(ptwin.fuzz, **CPU)
TestScenarioCodec = _ref.TestScenarioCodec
TestVirtualClock = _ref.TestVirtualClock
TestTwinSmoke = _ref.TestTwinSmoke
TestInvariantMonitor = _ref.TestInvariantMonitor
TestGangDistanceMonitor = _ref.TestGangDistanceMonitor
TestTopoAwareTwin = _ref.TestTopoAwareTwin
TestShrinker = _ref.TestShrinker


def to_port(scenario):
    return ptwin.scenario_from_json(jscenario.scenario_to_json(scenario))


RECIPES = {
    "clean": jt._clean_scenario,
    "clean_tpu": lambda: jt._clean_scenario(solver="tpu"),
    "storm": jt._storm_fleet_scenario,
    "elastic": jt._elastic_scenario,
    "topo": jt._topo_scenario,
    "buggy": jt._buggy_scenario,
}


@pytest.mark.parametrize("name", list(RECIPES))
def test_scenario_codec_and_fingerprint_equal_reference(name):
    ref = RECIPES[name]()
    port = to_port(ref)
    assert ptwin.scenario_to_json(port) == jscenario.scenario_to_json(ref)
    assert ptwin.scenario_fingerprint(port) == (
        jscenario.scenario_fingerprint(ref))
    assert ptwin.encode_scenario(port) == jscenario.encode_scenario(ref)
    assert ptwin.scenario_from_json(ptwin.scenario_to_json(port)) == port


@pytest.mark.parametrize("name,ref", [
    ("clean", jt._clean_scenario),
    ("storm", jt._storm_fleet_scenario),
    ("elastic", jt._elastic_scenario),
])
def test_chip_smoke_recipes_are_the_reference_scenarios(name, ref):
    port = chip_smoke.twin_scenarios()[name]()
    assert ptwin.scenario_to_json(port) == jscenario.scenario_to_json(ref())


def test_chip_smoke_macro_is_the_reference_macro_with_the_tpu_solver():
    """TestTwinSoak.test_macro_run_ledger_sane's scenario, built as that
    test builds it, with solver="tpu"."""
    ref = jt._clean_scenario(
        solver="tpu", duration=3600.0 * 8, tick=600.0,
        waves=tuple(
            jt.WorkloadWave(
                at=600.0 * i, cluster=i % 2, kind=kind, count=count,
                lifetime=7200.0 if kind != "serving" else 0.0,
                min_available=2 if kind == "serving" else 0,
                gang_size=8 if kind == "training" else 0,
                priority=100 if kind == "training" else 0,
            )
            for i, (kind, count) in enumerate(
                [("serving", 200), ("training", 160), ("batch", 400),
                 ("batch", 300), ("serving", 150), ("training", 80),
                 ("batch", 500), ("serving", 100)]
            )
        ),
    )
    port = chip_smoke.twin_scenarios()["macro"]()
    assert ptwin.scenario_to_json(port) == jscenario.scenario_to_json(ref)
    assert sum(w.count for w in port.waves) == 1890


def both(scenario):
    """(JAX twin's result, port twin's result) on one scenario, each run
    with its package's ledger counters as a fresh process has them
    (``chip_smoke.fresh_counters``: other tests in this process may have
    counted)."""
    with chip_smoke.fresh_counters(jwiring):
        ref = jharness.run_scenario(scenario)
    with chip_smoke.fresh_counters(pwiring):
        port = pharness.run_scenario(to_port(scenario), **CPU)
    return ref, port


def replay_both(path):
    with chip_smoke.fresh_counters(jwiring):
        ref = jreplay(path)
    with chip_smoke.fresh_counters(pwiring):
        port = ptwin.replay(path, **CPU)
    return ref, port


def assert_same(ref, port):
    assert port.trace_json() == ref.trace_json()
    assert port.ledger_json() == ref.ledger_json()
    assert [(v.invariant, v.detail) for v in port.violations] == [
        (v.invariant, v.detail) for v in ref.violations]


@pytest.mark.parametrize("solver", ["greedy", "tpu"])
def test_clean_smoke_equals_reference(solver):
    ref, port = both(jt._clean_scenario(solver=solver))
    assert_same(ref, port)
    assert port.violations == []
    assert port.counters["rpc_fallbacks"] == 0
    assert port.counters["result_rejected"] == 0
    ledger = port.ledger.encode()
    assert sum(c["n"] for c in ledger["slo"].values()) == 312


def test_chaotic_smoke_equals_reference():
    """tests/test_twin.py's determinism scenario: kube and cloud chaos and
    an ICE storm, the greedy solver; the faults fire at the same calls."""
    scenario = jt._clean_scenario(rates={
        "kube.create.conflict": 0.08,
        "kube.update.conflict": 0.05,
        "kube.bind.conflict": 0.05,
        "cloud.create.insufficient_capacity": 0.04,
    }, storms=(jt.Storm(start=30.0, duration=90.0, head=4),))
    ref, port = both(scenario)
    assert_same(ref, port)
    assert port.ledger.utilization["chaos_injected"]["0"] > 0


def test_racked_run_equals_reference():
    ref, port = both(jt._topo_scenario())
    assert_same(ref, port)
    ledger = port.ledger.encode()
    assert port.violations == [] and ledger["slo"]["training"]["n"] == 6
    assert ledger["gang_max_hops"]["0"] <= 1


def test_committed_lost_pod_repro_replays_its_violation():
    path = str(FIXTURES / "shrunk_lost_pod.json")
    ref, port = replay_both(path)
    assert [v.invariant for v in port.violations] == ["pod_conservation"]
    assert_same(ref, port)
    again = ptwin.replay(path, **CPU)
    assert again.trace_json() == port.trace_json()


def test_nomination_overcommit_repro_stays_fixed():
    ref, port = replay_both(
        str(FIXTURES / "shrunk_nomination_overcommit.json"))
    assert port.violations == []
    assert_same(ref, port)


def test_shrinker_refuses_a_healthy_scenario():
    with pytest.raises(ValueError, match="does not violate"):
        ptwin.shrink(to_port(jt._clean_scenario(duration=60.0, waves=(
            jt.WorkloadWave(at=0.0, cluster=0, kind="batch", count=2),
        ), clusters=1)), **CPU)


def test_twin_needs_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        pharness.run_scenario(to_port(jt._clean_scenario()))
    with pytest.raises(RuntimeError, match="cuda"):
        ptwin.DigitalTwin(to_port(jt._clean_scenario()))
    with pytest.raises(ValueError, match="kernel"):
        ptwin.DigitalTwin(to_port(jt._clean_scenario()), device="cpu",
                          kernel="pallas")
