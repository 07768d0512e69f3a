"""Chaos on the port (``chaos.py``, a verbatim copy).

tests/test_chaos.py's schedule-determinism, seam-stream, reconcile
isolation, ICE-cache and HTTP-retry cases, read onto the port
(tests/torch_ported.py), and port/JAX parity: the same seed and rates
draw the same fault sequence on every seam, and the seeded chaos scenario
(greedy solver) leaves the same event trace and nodes in both packages.
"""
import itertools

import pytest

from tests.torch_ported import ported
from tests.torch_threads import one_torch_thread  # noqa: F401

from karpenter_core_tpu import chaos as jchaos
from karpenter_core_tpu.api import objects as jobjects
from karpenter_core_tpu_torch import chaos as pchaos
from karpenter_core_tpu_torch.api import objects as pobjects

import tests.test_chaos as _jax

_ref = ported("test_chaos")
assert _ref.ChaosSchedule is pchaos.ChaosSchedule

TestUnavailableOfferings = _ref.TestUnavailableOfferings
TestReconcileIsolation = _ref.TestReconcileIsolation
TestTerminationConflict = _ref.TestTerminationConflict
TestHttpClientRetry = _ref.TestHttpClientRetry
TestChaosSmoke = _ref.TestChaosSmoke
TestSeamStreams = _ref.TestSeamStreams

RATES = {
    "kube.create.conflict": 0.08,
    "kube.update.conflict": 0.05,
    "kube.update.too_many_requests": 0.03,
    "kube.bind.conflict": 0.05,
    "kube.delete.too_many_requests": 0.04,
    "kube.evict.latency": 0.10,
    "cloud.create.create_error": 0.06,
    "cloud.create.insufficient_capacity": 0.04,
    "cloud.delete.delete_error": 0.06,
}
SEAMS = (
    ("kube.create", jchaos.ChaosKubeClient.WRITE_FAULTS),
    ("kube.update", jchaos.ChaosKubeClient.WRITE_FAULTS),
    ("kube.bind", jchaos.ChaosKubeClient.WRITE_FAULTS),
    ("kube.delete", jchaos.ChaosKubeClient.WRITE_FAULTS),
    ("kube.evict", jchaos.ChaosKubeClient.WRITE_FAULTS),
    ("cloud.create", ("create_error", "insufficient_capacity")),
    ("cloud.delete", ("delete_error",)),
)


def test_fault_classes_equal_reference():
    assert (pchaos.ChaosKubeClient.WRITE_FAULTS
            == jchaos.ChaosKubeClient.WRITE_FAULTS)


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_same_seed_and_rates_draw_the_same_faults(seed):
    j = jchaos.ChaosSchedule(seed=seed, rates=dict(RATES))
    p = pchaos.ChaosSchedule(seed=seed, rates=dict(RATES))
    for i in range(400):
        seam, faults = SEAMS[(i * 5 + i // 7) % len(SEAMS)]
        assert p.next_fault(seam, faults) == j.next_fault(seam, faults), i
    assert p.seam_draws == j.seam_draws and p.draws == j.draws


@pytest.mark.parametrize("name", ["cluster0", "cluster1", "wave-3"])
def test_fold_seed_equals_reference(name):
    for seed in (0, 3, 11, 2**31 - 1):
        assert pchaos.fold_seed(seed, name) == jchaos.fold_seed(seed, name)


def test_scripted_faults_equal_reference():
    script = {"kube.create": ["conflict", "ok", "too_many_requests"],
              "cloud.create": ["insufficient_capacity"]}
    j = jchaos.ChaosSchedule(seed=1, script={k: list(v)
                                             for k, v in script.items()})
    p = pchaos.ChaosSchedule(seed=1, script={k: list(v)
                                             for k, v in script.items()})
    for seam, faults in SEAMS[:1] * 4 + SEAMS[5:6] * 2:
        assert p.next_fault(seam, faults) == j.next_fault(seam, faults)


def _trace(op):
    return [(e.involved_object, e.reason, e.message, e.timestamp)
            for e in op.recorder.events]


def test_chaos_scenario_matches_reference():
    """The seeded ICE-storm chaos scenario (greedy) in both packages: the
    same faults fire at the same calls, so the event traces and the nodes
    are equal."""
    # each scenario restarts its claim counter; uids restart here
    jobjects._uid_counter = itertools.count(1)
    op_j, s_j = _jax._run_chaos_scenario(seed=7)
    pobjects._uid_counter = itertools.count(1)
    op_p, s_p = _ref._run_chaos_scenario(seed=7)
    assert s_p.draws == s_j.draws > 0
    assert s_p.seam_draws == s_j.seam_draws
    assert _trace(op_p) == _trace(op_j)
    assert ({n.name for n in op_p.kube.list_nodes()}
            == {n.name for n in op_j.kube.list_nodes()})
    assert sorted((p.name, p.node_name) for p in op_p.kube.list_pods()) == (
        sorted((p.name, p.node_name) for p in op_j.kube.list_pods()))
