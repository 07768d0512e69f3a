"""The port's HTTP kube client (``kube/client.py`` and
``kube/httpclient.py``, verbatim copies) against the port's apiserver.

tests/test_client_conformance.py, tests/test_client_seam.py and
tests/test_e2e_http.py run on the port (tests/torch_ported.py): the
conformance battery over the port's ``KubeStore`` and over
``HttpKubeClient`` talking to ``python -m
karpenter_core_tpu_torch.kube.httpserver`` in a child process, the client
seam, and the greedy operator over HTTP. Beside them, the operator over
HTTP with ``solver="tpu"`` on the CPU: the port's and the JAX package's
operators, each over its own apiserver process, must bind the same pods
to the same nodes and end with the same node count and cpu, read back by
a second, independent client.
"""
import pytest

import chip_smoke
from fleet_expected import ref_http_run, to_reference
from tests.test_torch_consolidation import align_counters
from tests.torch_ported import ported
from tests.torch_threads import one_torch_thread  # noqa: F401

from karpenter_core_tpu.cloudprovider.kwok import bench_catalog, build_catalog
from karpenter_core_tpu_torch import interop
from karpenter_core_tpu_torch.kube.client import KubeClient
from karpenter_core_tpu_torch.kube.httpclient import HttpKubeClient
from karpenter_core_tpu_torch.metrics import wiring as m
from karpenter_core_tpu_torch.operator import Options

_conformance = ported("test_client_conformance")
http_server = _conformance.http_server
client = _conformance.client
TestCrud = _conformance.TestCrud
TestWatch = _conformance.TestWatch
TestListings = _conformance.TestListings
TestPodSubresources = _conformance.TestPodSubresources
TestWireFidelity = _conformance.TestWireFidelity
TestCodecIdempotence = _conformance.TestCodecIdempotence

_seam = ported("test_client_seam")
TestKubeClientProtocol = _seam.TestKubeClientProtocol
TestSerialContainers = _seam.TestSerialContainers
TestSnapshotCodec = _seam.TestSnapshotCodec

_e2e = ported("test_e2e_http")
http_port = _e2e.http_port
TestProvisioningOverHttp = _e2e.TestProvisioningOverHttp
TestTypedErrorRoundTrip = _e2e.TestTypedErrorRoundTrip


def test_http_client_satisfies_the_protocol():
    assert isinstance(HttpKubeClient("127.0.0.1", 1), KubeClient)


PROBLEMS = {
    # tests/test_e2e_http.py's five 3-cpu pods
    "e2e": lambda: (
        [chip_smoke._replicated_pod(f"h{i}", 3.0) for i in range(5)],
        build_catalog(cpu_grid=[1, 2, 4, 8, 16], mem_factors=[2, 4])),
    # plain_5k_400's pod mix, cut to 120 pods over 40 types
    "plain": lambda: (chip_smoke._plain_pods(120), list(bench_catalog(40))),
}


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_tpu_operator_over_http_equals_reference(name):
    pods, catalog = PROBLEMS[name]()
    align_counters()
    ref, ref_bindings = ref_http_run(to_reference(pods), catalog,
                                      to_reference(chip_smoke._pool()))
    align_counters()
    errors0 = dict(m.RECONCILE_ERRORS.values)
    rejected0 = dict(m.SOLVER_RESULT_REJECTED.values)
    with chip_smoke.http_apiserver() as port:
        op, log, _passes, _wall, readback = chip_smoke.http_operator_run(
            port, Options(solver="tpu", batch_max_duration=0.0,
                          batch_idle_duration=0.0,
                          device_scheduler_opts={
                              "device": "cpu",
                              "kernel_backend": "reference"}),
            pods, interop.from_reference(catalog))
        try:
            chip_smoke.check_operator_run(op, log, name, errors0, rejected0,
                                          0, launched=False)
        finally:
            op.shutdown()
        bindings = sorted((p.name, p.node_name) for p in
                          HttpKubeClient("127.0.0.1", port).list_pods())
    assert log["solves"] and sum(s["scans"] for s in log["solves"]) >= 1
    assert readback == ref and readback[2] and readback[3] == len(pods)
    assert bindings == ref_bindings
