"""The port's twin over its in-thread solverd tier.

Every member is the port's ``SolverDaemon(device="cpu",
kernel="reference")`` in this process, behind real HTTP. The port must
give the JAX twin's trace and ledger JSON byte for byte: on the clean
fleet run, the elastic runs, and the storm scenario (tests/test_twin.py
``_storm_fleet_scenario``: an ICE storm, kube and cloud chaos, amnesia,
the murder of a member and a partition). Under the storm's tier faults
the port's sidecar client, the reference's, degrades the solves it gets
no verified answer for to the host greedy Scheduler, as the JAX twin's
does, so the two runs count the same ``rpc_fallbacks``.
"""
import functools

import pytest

import chip_smoke
from tests import test_twin as jt
from tests.test_torch_twin import CPU, assert_same, both, to_port
from tests.torch_ported import ported
from tests.torch_threads import one_torch_thread  # noqa: F401

from karpenter_core_tpu_torch.metrics import wiring as pwiring
from karpenter_core_tpu_torch.twin import harness as pharness

_ref = ported("test_twin")
_ref.run_scenario = functools.partial(pharness.run_scenario, **CPU)
TestTwinElastic = _ref.TestTwinElastic


def test_storm_fleet_run_equals_reference():
    scenario = jt._storm_fleet_scenario()
    ref, port = both(scenario)
    assert_same(ref, port)
    assert port.violations == []
    c = port.counters
    # the murder and the partition bit: RPCs failed and solves degraded,
    # as many as the JAX twin's
    assert c["rpc_fallbacks"] == ref.counters["rpc_fallbacks"] > 0
    assert c["rpc_failures"] > 0 and c["result_rejected"] == 0
    assert sum(port.ledger.utilization["member_solves"].values()) > 0
    kinds = {e[3] for e in port.trace}
    assert {"murder", "respawn", "amnesia", "partition_start",
            "partition_end"} <= kinds
    # two port runs are byte-identical
    with chip_smoke.fresh_counters(pwiring):
        again = pharness.run_scenario(to_port(scenario), **CPU)
    assert again.trace_json() == port.trace_json()
    assert again.ledger_json() == port.ledger_json()


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
