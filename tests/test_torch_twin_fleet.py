"""The port's twin over its in-thread solverd tier.

Every member is the port's ``SolverDaemon(device="cpu",
kernel="reference")`` in this process, behind real HTTP. Without a tier
transport fault (the clean fleet run, the elastic runs without a murder)
the port must give the JAX twin's trace and ledger JSON byte for byte.

The storm scenario (tests/test_twin.py ``_storm_fleet_scenario``: an ICE
storm, kube and cloud chaos, amnesia, the murder of a member and a
partition) is not compared with the JAX twin: there the reference's
client re-solves a failed RPC on the host greedy Scheduler, and the
port's fails the solve by design (its sidecar client has no fallback).
It is held to the invariants instead: no violation, no greedy fallback,
failed RPCs counted (the faults bit), every pod bound by the end, and
two runs byte-identical.
"""
import functools

import pytest

from tests import test_twin as jt
from tests.test_torch_twin import CPU, assert_same, both, to_port
from tests.torch_ported import ported
from tests.torch_threads import one_torch_thread  # noqa: F401

from karpenter_core_tpu_torch.twin import harness as pharness

_ref = ported("test_twin")
_ref.run_scenario = functools.partial(pharness.run_scenario, **CPU)
TestTwinElastic = _ref.TestTwinElastic


def test_storm_fleet_holds_the_invariants_without_fallback():
    scenario = to_port(jt._storm_fleet_scenario())
    a = pharness.run_scenario(scenario, **CPU)
    assert a.violations == []
    c = a.counters
    assert c["rpc_fallbacks"] == 0 and c["host_fallback_pods"] == 0
    assert c["result_rejected"] == 0
    # the murder and the partition bit: solves failed, none fell back
    assert c["rpc_failures"] > 0
    util = a.ledger.utilization
    assert util["rpc_fallbacks"] == 0 and util["host_fallback_pods"] == 0
    assert sum(util["member_solves"].values()) > 0
    # every pod of every wave bound by the end, each within max_pending
    ledger = a.ledger.encode()
    assert sum(c["n"] for c in ledger["slo"].values()) == sum(
        w.count for w in scenario.waves)
    assert ledger["slo_misses"] == 0
    # the partition and the murder show in the trace
    kinds = {e[3] for e in a.trace}
    assert {"murder", "respawn", "amnesia", "partition_start",
            "partition_end"} <= kinds
    b = pharness.run_scenario(scenario, **CPU)
    assert a.trace_json() == b.trace_json()
    assert a.ledger_json() == b.ledger_json()
    assert b.counters == a.counters


def test_clean_fleet_run_equals_reference():
    scenario = jt._storm_fleet_scenario(
        rates={}, storms=(), fleet_faults=(), duration=120.0,
        waves=(
            jt.WorkloadWave(at=0.0, cluster=0, kind="serving", count=10,
                            min_available=2),
            jt.WorkloadWave(at=30.0, cluster=1, kind="batch", count=10),
        ),
    )
    ref, port = both(scenario)
    assert_same(ref, port)
    assert port.violations == [] and port.counters["rpc_failures"] == 0
    assert sum(port.ledger.utilization["member_solves"].values()) > 0


@pytest.mark.parametrize("name,overrides", [
    ("surge", {}),
    ("fixed", dict(autoscale=False, fleet_min=0, fleet_max=0, fleet=2)),
])
def test_elastic_run_equals_reference(name, overrides):
    ref, port = both(jt._elastic_scenario(**overrides))
    assert_same(ref, port)
    assert port.violations == [] and port.counters["rpc_failures"] == 0
