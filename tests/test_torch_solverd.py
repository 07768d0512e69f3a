"""The port's solverd sidecar against the JAX package's.

A port daemon (``SolverDaemon(device="cpu", kernel="reference")``, in
this process or served on a loopback port) answers the requests of
tests/test_solverd.py, tests/test_segments.py's fleet cases,
tests/test_relaxsolve.py's daemon cases and tests/test_incremental.py's
replay cases. Every answer is held to the JAX daemon's answer on the same
request bytes: the result wire without its ``solve_seconds`` field must be
identical (hostname placeholders aligned first). Three cases spawn a real
child process (``python -m karpenter_core_tpu_torch.solver.service
--device cpu --kernel reference``): the supervised operator end to end, a
fleet member's kill and respawn, and a sticky CUDA error (faked at the
kernel seam) that must take the crash-only exit and be charged by the
respawned child's quarantine journal.
"""
from __future__ import annotations

import copy
import json
import sys
import time

import pytest

from tests.helpers import make_nodepool, make_pod
from tests.test_fuzz_parity import fuzz_scenario
from tests.test_relaxsolve import two_pool_world
from tests.test_solverd import (
    TestWireCodec,
    _fixed_server,
    _solve_problem,
    _valid_result_header,
)
from tests.test_torch_provisioner import _align_hostnames
from tests.torch_threads import one_torch_thread  # noqa: F401

from karpenter_core_tpu.chaos import ChaosSchedule, SolverChaos
from karpenter_core_tpu.cloudprovider.fake import fake_instance_types
from karpenter_core_tpu.cloudprovider.kwok import KwokCloudProvider as RefKwok
from karpenter_core_tpu.cloudprovider.kwok import build_catalog
from karpenter_core_tpu.kube.store import KubeStore as RefKubeStore
from karpenter_core_tpu.models.provisioner import (
    DeviceScheduler as RefScheduler,
)
from karpenter_core_tpu.operator import Operator as RefOperator
from karpenter_core_tpu.operator import Options as RefOptions
from karpenter_core_tpu.solver import service as jservice
from karpenter_core_tpu.solver import incremental as jincsolve
from karpenter_core_tpu.solver.gangs import GANG_ANNOTATION
from karpenter_core_tpu.utils.clock import FakeClock as RefFakeClock
from karpenter_core_tpu_torch import interop
from karpenter_core_tpu_torch.api.objects import OwnerReference, Pod
from karpenter_core_tpu_torch.cloudprovider.kwok import KwokCloudProvider
from karpenter_core_tpu_torch.kube.store import KubeStore
from karpenter_core_tpu_torch.metrics import wiring as m
from karpenter_core_tpu_torch.models import provisioner as tprov
from karpenter_core_tpu_torch.operator import Operator, Options
from karpenter_core_tpu_torch.solver import (
    codec,
    fleet,
    incremental as incsolve,
    remote,
    segments,
    service,
)
from karpenter_core_tpu_torch.solver.supervisor import (
    DRAIN_EXIT_CODE,
    WATCHDOG_EXIT_CODE,
    SolverSupervisor,
    default_command,
)
from karpenter_core_tpu_torch.utils.clock import FakeClock

CATALOG = build_catalog(cpu_grid=[1, 2, 4, 8], mem_factors=[2, 4])
CPU = dict(device="cpu", kernel="reference")
STICKY = "CUDA error: an illegal memory access was encountered"


def pdaemon(**kw):
    """A port daemon on the CPU through the plain scan."""
    return service.SolverDaemon(**CPU, **kw)


def served(daemon=None):
    srv = service.serve(0, daemon=daemon or pdaemon())
    return srv, f"127.0.0.1:{srv.server_address[1]}"


def stop(srv):
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def sidecar():
    srv, addr = served()
    yield srv, addr
    stop(srv)


def view(out: bytes) -> dict:
    """The result wire minus its timing field."""
    h = codec.decode_solve_results(out)
    h.pop("solve_seconds", None)
    return h


def both(body: bytes, ref=None, port=None, **kw):
    """The same request bytes through a JAX daemon and a port daemon: the
    result wires must be identical. Returns the port's answer."""
    ref = ref or jservice.SolverDaemon()
    port = port or pdaemon()
    _align_hostnames()
    out_ref, _ = ref.solve(body, **kw)
    _align_hostnames()
    out_port, _ = port.solve(body, **kw)
    assert view(out_port) == view(out_ref)
    return out_port


def _encode(pools, its, existing, ds, pods, **kw) -> bytes:
    return codec.encode_solve_request(
        *interop.from_reference((copy.deepcopy(pools), its,
                                 copy.deepcopy(existing),
                                 copy.deepcopy(ds), copy.deepcopy(pods))),
        **kw)


def _fp(body: bytes) -> str:
    return codec.problem_fingerprint(codec._json_header(body))


def replicated(pod):
    pod.metadata.owner_references.append(
        OwnerReference(kind="ReplicaSet", name="rs", uid="rs-uid"))
    return pod


def new_operator(mode, addr="", catalog=CATALOG, **kw):
    clock = FakeClock()
    kube = KubeStore(clock)
    return Operator(
        kube=kube,
        cloud_provider=KwokCloudProvider(kube, interop.from_reference(
            catalog)),
        clock=clock,
        options=Options(solver="tpu", solver_mode=mode, solver_addr=addr,
                        solver_kernel="reference",
                        device_scheduler_opts={"device": "cpu"}, **kw),
    )


# ---------------------------------------------------------------------------
# the wire codec (the port's verbatim copy) on the port's objects


class TestPortCodec:
    def test_solve_request_roundtrip(self):
        pools, its, nodes, pods, topo = interop.from_reference(
            TestWireCodec()._problem())
        back = codec.decode_solve_request(codec.encode_solve_request(
            pools, its, nodes, [], pods, topology=topo, max_slots=512))
        assert sorted(p.name for p in back["nodepools"]) == [
            "batch", "default"]
        assert back["max_slots"] == 512
        assert back["instance_types"]["default"][0] is (
            back["instance_types"]["batch"][0])
        (node,) = back["existing_nodes"]
        assert node.volume_usage.volumes == {"ebs.csi": {"default/pvc-a"}}
        assert back["topology"].excluded_pods == {"uid-x"}
        assert [p.uid for p in back["pods"]] == [p.uid for p in pods]
        assert type(back["pods"][0]).__module__.startswith(
            "karpenter_core_tpu_torch.")

    def test_requirements_decode_preserves_semantics(self):
        from karpenter_core_tpu_torch.scheduling import (
            Requirement,
            Requirements,
        )

        reqs = Requirements([
            Requirement.new("zone", "In", ["a", "b"]),
            Requirement.new("tier", "NotIn", ["gpu"]),
            Requirement.new("gen", "Gt", ["3"]),
        ])
        back = codec._decode_reqs(codec._encode_reqs(reqs))
        for key in reqs:
            assert back[key].complement == reqs[key].complement
            assert back[key].values == reqs[key].values
            assert back[key].greater_than == reqs[key].greater_than

    def test_frontier_response_roundtrip(self):
        frontier = [(True, 0, 0.0), (False, 2, 1.5), (True, 1, 0.25)]
        assert codec.decode_frontier_response(
            codec.encode_frontier_response(frontier)) == frontier
        assert codec.decode_frontier_response(
            codec.encode_frontier_response(None)) is None


# ---------------------------------------------------------------------------
# the port daemon's answers against the JAX daemon's


@pytest.mark.parametrize("seed", range(14))
def test_daemon_answers_fuzz_seed_as_jax_full_and_manifest(seed):
    """Each fuzz seed through both daemons, and the manifest (delta) form
    of the same request through a fresh port daemon."""
    pods, existing, pools, its = fuzz_scenario(seed)
    args = interop.from_reference((pools, its, existing, [], pods))
    body = codec.encode_solve_request(*args, max_slots=128)
    out = both(body)
    plan = segments.split_solve_header(
        codec._encode_solve_header(*args, max_slots=128))
    _align_hostnames()
    out_man, _ = pdaemon().solve(codec.encode_manifest_request(plan))
    assert view(out_man) == view(out)


def test_daemon_answers_topology_gang_and_relax_as_jax():
    from karpenter_core_tpu.controllers.provisioning.scheduling.topology import (  # noqa: E501
        Topology,
    )

    pools, its = [make_nodepool()], {"default": fake_instance_types(4)}
    topo = Topology(domains={"topology.kubernetes.io/zone": {
        "zone-a": 0, "zone-b": 0}})
    spread = [make_pod(cpu=0.5, name=f"sp{i}", spread_zone=True)
              for i in range(6)]
    both(_encode(pools, its, [], [], spread, topology=interop.from_reference(
        topo)))
    gang = []
    for i in range(4):
        p = make_pod(cpu=1.0, name=f"g{i}")
        p.metadata.annotations[GANG_ANNOTATION] = "job-1"
        gang.append(p)
    both(_encode(pools, its, [], [], gang))
    pools2, its2 = two_pool_world()
    rpods = [make_pod(cpu=0.5, name=f"r-{i}") for i in range(24)]
    out = both(_encode(pools2, its2, [], [], rpods, solver_mode="relax"))
    assert codec.decode_solve_results(out)["claims"]


class TestConformance:
    def test_battery_identical_inproc_vs_sidecar(self, sidecar):
        from tests.test_solverd import _run_battery as ref_battery

        srv, addr = sidecar
        clock = RefFakeClock()
        kube = RefKubeStore(clock)
        expected = ref_battery(RefOperator(
            kube=kube, cloud_provider=RefKwok(kube, CATALOG), clock=clock,
            options=RefOptions(solver="tpu")))
        inproc = _battery(new_operator("inproc"))
        solves_before = srv.daemon_.solves
        fallbacks = m.SOLVER_RPC_FALLBACKS.value({"endpoint": "solve"})
        over_wire = _battery(new_operator("sidecar", addr=addr))
        assert inproc == expected
        assert over_wire == expected
        assert srv.daemon_.solves > solves_before
        assert m.SOLVER_RPC_FALLBACKS.value(
            {"endpoint": "solve"}) == fallbacks

    def test_direct_results_parity(self, sidecar):
        _srv, addr = sidecar
        pools = [make_nodepool()]
        catalog = fake_instance_types(5)
        pods = [make_pod(cpu=1.0, name=f"p{i}") for i in range(10)]
        pods += [make_pod(cpu=64.0, name="whale")]
        ref = RefScheduler(pools, {"default": catalog}).solve(
            copy.deepcopy(pods))
        ppools, pcat, ppods = interop.from_reference((pools, catalog, pods))
        client = remote.SolverClient(addr, timeout=120)
        over_wire = remote.RemoteScheduler(
            client, ppools, {"default": pcat}).solve(ppods)

        def shape(results):
            return {
                "groups": sorted(
                    tuple(sorted(p.metadata.name for p in c.pods))
                    for c in results.new_node_claims),
                "options": sorted(
                    tuple(sorted(it.name for it in c.instance_type_options))
                    for c in results.new_node_claims),
                "errors": set(results.pod_errors),
            }

        assert shape(over_wire) == shape(ref)
        claim = over_wire.new_node_claims[0]
        assert all(it in pcat for it in claim.instance_type_options)
        assert all(p in ppods for p in claim.pods)

    def test_consolidation_sweep_over_sidecar(self, sidecar):
        _srv, addr = sidecar

        def run(mode, addr=""):
            op = new_operator(mode, addr=addr)
            op.kube.create(interop.from_reference(make_nodepool()))
            for i in range(4):
                op.kube.create(replicated(interop.from_reference(
                    make_pod(cpu=1.2, name=f"c{i}"))))
            op.run_until_idle(disrupt=False)
            for i in range(2):
                pod = op.kube.get(Pod, f"c{i}")
                pod.metadata.owner_references = []
                op.kube.delete(pod)
            op.clock.step(1.0)
            op.run_until_idle()
            return {"nodes": len(op.kube.list_nodes()),
                    "bound": all(p.node_name for p in op.kube.list_pods())}

        assert run("sidecar", addr=addr) == run("inproc")

    def test_e2e_operator_over_spawned_sidecar(self, monkeypatch):
        """The operator spawns and supervises a real CPU child."""
        monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the child's torch
        op = new_operator("sidecar")
        try:
            sup = op.solver_supervisor
            assert sup is not None and sup.alive()
            assert sup.command[2] == "karpenter_core_tpu_torch.solver.service"
            assert sup.command[-4:] == ["--kernel", "reference",
                                        "--device", "cpu"]
            fallbacks = m.SOLVER_RPC_FALLBACKS.value({"endpoint": "solve"})
            op.kube.create(interop.from_reference(make_nodepool()))
            for i in range(3):
                op.kube.create(replicated(interop.from_reference(
                    make_pod(cpu=2.0, name=f"e{i}"))))
            op.run_until_idle(disrupt=False)
            assert all(p.node_name for p in op.kube.list_pods())
            assert op.kube.list_nodes()
            assert m.SOLVER_RPC_FALLBACKS.value(
                {"endpoint": "solve"}) == fallbacks
            assert op.readyz()
        finally:
            op.shutdown()
        assert not op.solver_supervisor.alive()


def _dead_addr() -> str:
    """A loopback address nothing listens on."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    return addr


def test_pods_wait_while_no_sidecar_answers():
    """With no sidecar answering, the provisioning reconcile fails: its
    pods stay pending, no node is launched and nothing is solved on the
    host. Once a sidecar answers, the next passes bind them."""
    client = remote.SolverClient(
        _dead_addr(), timeout=5, max_retries=0, sleep=lambda s: None,
        breaker=remote.CircuitBreaker(failure_threshold=10_000),
        quarantine=fleet.PoisonQuarantine(strikes=10_000))
    clock = FakeClock()
    kube = KubeStore(clock)
    op = Operator(kube=kube, clock=clock, solver_client=client,
                  cloud_provider=KwokCloudProvider(
                      kube, interop.from_reference(CATALOG)),
                  options=Options(solver="tpu", solver_mode="sidecar"))
    op.kube.create(interop.from_reference(make_nodepool()))
    for i in range(3):
        op.kube.create(replicated(interop.from_reference(
            make_pod(cpu=2.0, name=f"w{i}"))))
    errors0 = sum(m.RECONCILE_ERRORS.values.values())
    fallbacks = m.SOLVER_RPC_FALLBACKS.value({"endpoint": "solve"})
    op.run_until_idle(max_iters=8, disrupt=False)
    assert sum(m.RECONCILE_ERRORS.values.values()) > errors0
    assert not any(p.node_name for p in op.kube.list_pods())
    assert not op.kube.list_nodes()
    srv, addr = served()
    try:
        client.set_addr(addr)
        op.clock.step(600.0)  # past the reconcile backoff
        op.run_until_idle(disrupt=False)
        assert all(p.node_name for p in op.kube.list_pods())
        assert op.kube.list_nodes()
    finally:
        stop(srv)
    assert m.SOLVER_RPC_FALLBACKS.value({"endpoint": "solve"}) == fallbacks


def test_quarantined_problem_fails_without_an_rpc():
    """A problem the client's quarantine holds fails at once, with no RPC
    and no host solve."""
    pools, its, pods = _port_problem(2)
    client = remote.SolverClient(
        _dead_addr(), timeout=5, max_retries=0, sleep=lambda s: None,
        wire_mode="full", quarantine=fleet.PoisonQuarantine(strikes=1))
    with pytest.raises(remote.RemoteSolverError) as exc:
        remote.RemoteScheduler(client, pools, its).solve(pods)
    assert exc.value.cause == "error"
    failures = m.SOLVER_RPC_FAILURES.value({"cause": "error"})
    with pytest.raises(remote.RemoteSolverError) as exc:
        remote.RemoteScheduler(client, pools, its).solve(pods)
    assert exc.value.cause == "poisoned"
    assert m.SOLVER_RPC_FAILURES.value({"cause": "error"}) == failures
    assert client.quarantine.size() == 1


def _battery(op) -> dict:
    """tests/test_solverd.py's solve battery on a port operator."""
    op.kube.create(interop.from_reference(make_nodepool()))
    for i in range(6):
        op.kube.create(replicated(interop.from_reference(
            make_pod(cpu=1.5, name=f"plain{i}"))))
    for i in range(2):
        op.kube.create(replicated(interop.from_reference(make_pod(
            cpu=0.5, name=f"zonal{i}", zone_in=["zone-b"]))))
    op.run_until_idle(disrupt=False)
    first_nodes = len(op.kube.list_nodes())
    for i in range(2):
        op.kube.create(replicated(interop.from_reference(
            make_pod(cpu=0.25, name=f"late{i}"))))
    op.run_until_idle(disrupt=False)
    pods = op.kube.list_pods()
    nodes = op.kube.list_nodes()
    return {
        "bound": sorted(p.metadata.name for p in pods if p.node_name),
        "unbound": sorted(p.metadata.name for p in pods if not p.node_name),
        "first_nodes": first_nodes,
        "nodes": len(nodes),
        "zonal_zone": sorted({
            n.metadata.labels.get("topology.kubernetes.io/zone")
            for n in nodes for p in pods
            if p.node_name == n.name and p.metadata.name.startswith("zonal")
        }),
    }


# ---------------------------------------------------------------------------
# the scheduler cache (tests/test_solverd.py TestSchedulerReuse)


class TestSchedulerReuse:
    POOLS = [make_nodepool()]
    CATALOG = fake_instance_types(5)
    ALT_CATALOG = fake_instance_types(3)

    def _request(self, pods, catalog=None, max_slots=64):
        return _encode(self.POOLS, {"default": list(catalog or self.CATALOG)},
                       [], [], pods, max_slots=max_slots)

    def test_cached_and_fresh_solves_identical(self):
        ref, port = jservice.SolverDaemon(), pdaemon()
        body = self._request([make_pod(cpu=1.0, name=f"c{i}")
                              for i in range(12)])
        out1 = both(body, ref, port)
        assert len(port._sched_cache) == 1
        out2 = both(body, ref, port)
        assert len(port._sched_cache) == 1
        assert view(out1) == view(out2) == view(both(body))

    def test_pod_derived_topology_exclusions_do_not_churn_cache(self):
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (  # noqa: E501
            Topology,
        )

        ref, port = jservice.SolverDaemon(), pdaemon()
        for r in range(3):
            pods = interop.from_reference(
                [make_pod(cpu=1.0, name=f"x{r}-{i}") for i in range(3 + r)])
            topo = Topology(domains={},
                            excluded_pod_uids={p.uid for p in pods})
            body = codec.encode_solve_request(
                interop.from_reference(self.POOLS),
                {"default": interop.from_reference(list(self.CATALOG))},
                [], [], pods, topology=topo, max_slots=32)
            out = both(body, ref, port)
            assert codec.decode_solve_results(out)["errors"] == {}
        assert len(port._sched_cache) == 1
        ctx = next(iter(port._sched_cache.values()))._topology_context
        assert all(uid.startswith("uid-") for uid in ctx.excluded_pods)

    def test_problem_change_misses_cache(self):
        ref, port = jservice.SolverDaemon(), pdaemon()
        pods = [make_pod(cpu=1.0, name=f"m{i}") for i in range(4)]
        both(self._request(pods), ref, port)
        both(self._request([make_pod(cpu=2.0, name=f"m2{i}")
                            for i in range(6)]), ref, port)
        assert len(port._sched_cache) == 1
        both(self._request(pods, catalog=self.ALT_CATALOG), ref, port)
        assert len(port._sched_cache) == 2


# ---------------------------------------------------------------------------
# corrupt and refused wires: the port's client (tests/test_solverd.py)


def _no_quarantine_client(addr, **kwargs):
    kwargs.setdefault("quarantine", fleet.PoisonQuarantine(strikes=10_000))
    return remote.SolverClient(addr, **kwargs)


def _port_problem(n=4):
    return interop.from_reference(_solve_problem(n))


CORRUPTIONS = {
    "pod_uids_as_string": lambda w: w["claims"][0].__setitem__(
        "pod_uids", "uid-v0"),
    "requests_as_list": lambda w: w["claims"][0].__setitem__(
        "requests", [1, 2]),
    "errors_as_list": lambda w: w.__setitem__("errors", []),
    "claims_as_dict": lambda w: w.__setitem__("claims", {}),
    "instance_types_as_ints": lambda w: w["claims"][0].__setitem__(
        "instance_types", [1]),
    "raw_requirements": lambda w: w["claims"][0].__setitem__(
        "requirements", [{"key": "zone"}]),
    "existing_entry_malformed": lambda w: w.__setitem__(
        "existing", [{"node": 7, "pod_uids": []}]),
    "nonlist_existing": lambda w: w.__setitem__("existing", 3),
}


@pytest.mark.parametrize("name", list(CORRUPTIONS))
def test_corrupt_wire_is_corrupt(name):
    pools, its, pods = _port_problem()
    res = tprov.DeviceScheduler(pools, dict(its), max_slots=32,
                                device="cpu").solve(pods)
    wire = codec.decode_solve_results(codec.encode_solve_results(res, 0.01))
    assert wire["claims"]
    CORRUPTIONS[name](wire)
    client = _no_quarantine_client("127.0.0.1:1", timeout=5, max_retries=0,
                                   sleep=lambda s: None)
    with pytest.raises(remote.RemoteSolverError) as exc:
        remote.RemoteScheduler(client, pools, its)._materialize(wire, pods)
    assert exc.value.cause == "corrupt", exc.value


@pytest.mark.parametrize("damage,cause", [("content", "corrupt"),
                                          ("truncated", "decode")])
def test_damaged_wire_degrades_to_greedy(damage, cause):
    """A damaged result wire fails the solve with its cause counted; the
    port re-solves nothing on the host (no greedy fallback)."""
    wire = _valid_result_header(*_solve_problem())
    if damage == "content":
        wire["claims"][0]["pod_uids"] = 12345
        payload = codec._json_payload(wire)
    else:
        payload = SolverChaos(ChaosSchedule()).corrupt(
            codec._json_payload(wire))
    srv = _fixed_server(200, payload)
    try:
        pools, its, pods = _port_problem()
        client = _no_quarantine_client(
            f"127.0.0.1:{srv.server_address[1]}", timeout=5, max_retries=0,
            sleep=lambda s: None)
        failures = m.SOLVER_RPC_FAILURES.value({"cause": cause})
        fallbacks = m.SOLVER_RPC_FALLBACKS.value({"endpoint": "solve"})
        with pytest.raises(remote.RemoteSolverError) as exc:
            remote.RemoteScheduler(client, pools, its).solve(pods)
        assert exc.value.cause == cause
        assert m.SOLVER_RPC_FAILURES.value({"cause": cause}) == failures + 1
        assert m.SOLVER_RPC_FALLBACKS.value(
            {"endpoint": "solve"}) == fallbacks
    finally:
        stop(srv)


def test_bad_result_rejected_and_degraded():
    """The client's verifier catches a sidecar result that drops a pod:
    that solve fails (nothing is re-solved on the host), and the next one
    is answered by the sidecar."""
    chaos = SolverChaos(ChaosSchedule(
        script={"solverd.solve": ["bad_result"]}))
    srv, addr = served(pdaemon(chaos=chaos))
    try:
        pools, its, pods = _port_problem(6)
        client = _no_quarantine_client(addr, timeout=120)
        rs = remote.RemoteScheduler(client, pools, its)
        key = {"reason": "conservation", "path": "sidecar"}
        rejected = m.SOLVER_RESULT_REJECTED.value(key)
        with pytest.raises(remote.RemoteSolverError) as exc:
            rs.solve(pods)
        assert exc.value.cause == "rejected"
        assert chaos.injected.get("bad_result") == 1
        assert m.SOLVER_RESULT_REJECTED.value(key) == rejected + 1
        assert rs.solve(pods).all_pods_scheduled()
        assert m.SOLVER_RESULT_REJECTED.value(key) == rejected + 1
    finally:
        stop(srv)


class TestDrainContract:
    def test_client_treats_503_as_degrade_not_fault(self):
        """A draining sidecar fails the solve without charging the
        breaker: a drain is an answer from a live process."""
        srv = _fixed_server(503, b'{"error": "draining"}')
        try:
            pools, its, pods = _port_problem()
            client = _no_quarantine_client(
                f"127.0.0.1:{srv.server_address[1]}", timeout=5,
                max_retries=2, sleep=lambda s: None)
            with pytest.raises(remote.RemoteSolverError) as exc:
                remote.RemoteScheduler(client, pools, its).solve(pods)
            assert exc.value.cause == "drain"
            assert client.breaker.failures == 0
            assert client.breaker.state == remote.STATE_CLOSED
        finally:
            stop(srv)

    def test_drain_endpoint_and_healthz(self):
        daemon = pdaemon()
        assert daemon.drain() == {"draining": True, "flushed": 0,
                                  "exiting": False}
        health = daemon.health()
        assert health["draining"] is True and health["ready"] is False
        assert health["kernel"] == "reference"
        with pytest.raises(fleet.DrainError):
            daemon.solve(b"irrelevant")
        daemon.gateway.resume()
        assert daemon.health()["draining"] is False

    def test_drain_exit_fn_fires_after_idle(self):
        exits = []
        daemon = pdaemon(exit_fn=exits.append)
        assert daemon.drain()["exiting"] is True
        for _ in range(200):
            if exits:
                break
            time.sleep(0.02)
        assert exits == [DRAIN_EXIT_CODE]

    def test_wedged_device_step_trips_watchdog_and_drains(self):
        """A wedged device step trips the watchdog; a healthy one, even a
        slow CPU solve on a loaded box, stays inside the 2-s budget."""
        exits = []
        chaos = SolverChaos(ChaosSchedule(
            script={"solverd.solve": ["wedge:3.0"]}))
        daemon = pdaemon(watchdog_seconds=2.0, chaos=chaos,
                         exit_fn=exits.append)
        pools, its, pods = _port_problem(2)
        body = codec.encode_solve_request(pools, its, [], [], pods,
                                          max_slots=16)
        out, _ = daemon.solve(body)
        assert codec.decode_solve_results(out)["errors"] == {}
        assert daemon.watchdog.trips == 1
        assert exits == [WATCHDOG_EXIT_CODE]
        with pytest.raises(fleet.DrainError):
            daemon.solve(body)
        daemon.gateway.resume()
        daemon.solve(body)
        assert daemon.watchdog.trips == 1

    def test_daemon_quarantines_crashing_problem(self):
        daemon = pdaemon(
            quarantine=fleet.PoisonQuarantine(strikes=2, site="gateway"))
        pools, its, pods = _port_problem(2)
        body = codec.encode_solve_request(pools, its, [], [], pods,
                                          max_slots=16)
        fp = codec.decode_solve_request(body)["fingerprint"] + "+mffd"

        class _Bomb:
            def update_topology_context(self, topo):
                pass

            def solve(self, pods):
                raise RuntimeError("chaos: poisoned problem")

        daemon._sched_cache.put(fp, _Bomb(), 64)
        for _ in range(2):
            with pytest.raises(RuntimeError):
                daemon.solve(body)
        with pytest.raises(fleet.QuarantinedError):
            daemon.solve(body)
        assert daemon.health()["quarantine_entries"] == 1


def test_profile_endpoint_toggles_and_writes_a_torch_trace(tmp_path):
    assert pdaemon().toggle_profile(True) == {
        "profiling": False, "profile_dir": None, "configured": False}
    daemon = pdaemon(profile_dir=str(tmp_path))
    srv, addr = served(daemon)
    try:
        from urllib.request import Request, urlopen

        st = json.loads(urlopen(Request(f"http://{addr}/profile",
                                        method="POST", data=b""),
                                timeout=10).read())
        assert st["profiling"] is True
        pools, its, pods = _port_problem(1)
        out, _ = daemon.solve(codec.encode_solve_request(
            pools, its, [], [], pods, max_slots=16))
        assert codec.decode_solve_results(out)["errors"] == {}
        (trace,) = tmp_path.iterdir()
        assert trace.name == "solve-1-torch.json"
        assert json.loads(trace.read_text())["traceEvents"]
    finally:
        stop(srv)


# ---------------------------------------------------------------------------
# the relax backend behind the daemon (tests/test_relaxsolve.py:397-443)


def test_daemon_header_overrides_wire_mode():
    pools, its = two_pool_world()
    pods = [make_pod(cpu=1.0, name=f"p{i}") for i in range(48)]
    body = _encode(pools, its, [], [], pods, solver_mode="ffd")
    ref, port = jservice.SolverDaemon(), pdaemon()
    claims_f = len(codec.decode_solve_results(both(body, ref, port))[
        "claims"])
    claims_r = len(codec.decode_solve_results(
        both(body, ref, port, solver_mode="relax"))["claims"])
    assert claims_r < claims_f


def test_daemon_default_mode_applies_to_modeless_wire():
    pools, its = two_pool_world()
    pods = [make_pod(cpu=1.0, name=f"p{i}") for i in range(48)]
    h = codec._json_header(_encode(pools, its, [], [], pods))
    h.pop("solver_mode")
    modeless = codec._json_payload(h)
    claims = {}
    for mode in ("ffd", "relax"):
        out = both(modeless, jservice.SolverDaemon(default_mode=mode),
                   pdaemon(default_mode=mode))
        claims[mode] = len(codec.decode_solve_results(out)["claims"])
    assert claims["relax"] < claims["ffd"]


def test_supervisor_spawn_argv_carries_mode_kernel_and_device():
    cmd = default_command(0, solve_mode="relax", kernel="reference",
                          device="cpu")
    assert cmd[1:3] == ["-m", "karpenter_core_tpu_torch.solver.service"]
    for flag, value in (("--solver-mode", "relax"),
                        ("--kernel", "reference"), ("--device", "cpu")):
        assert cmd[cmd.index(flag) + 1] == value
    plain = default_command(0)
    assert not {"--solver-mode", "--kernel", "--device"} & set(plain)


def test_daemon_refuses_other_device_counts_and_kernels(monkeypatch):
    from karpenter_core_tpu_torch.parallel import mesh as pmesh

    # devices=2 clamps to the CPU's one device, as in the JAX package; on
    # an 8-device virtual CPU mesh it solves on a 2-device mesh with the
    # JAX daemon's answer at devices=2
    assert pdaemon(devices=2).devices == 2
    body = _encode([make_nodepool()], {"default": fake_instance_types(5)},
                   [], [], [make_pod(cpu=1.0, name=f"d{i}")
                            for i in range(12)], max_slots=64)
    pmesh.force_virtual_mesh(8, "cpu")
    try:
        daemon = pdaemon(devices=2)
        both(body, ref=jservice.SolverDaemon(devices=2), port=daemon)
    finally:
        pmesh.force_virtual_mesh(0, "cpu")
    cached = next(iter(daemon._sched_cache._entries.values()))[0]
    assert cached.devices == 2
    with pytest.raises(ValueError, match="unknown kernel"):
        service.SolverDaemon(device="cpu", kernel="pallas")


def test_daemon_needs_a_gpu_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        service.SolverDaemon()


# ---------------------------------------------------------------------------
# the incremental engine (tests/test_incremental.py:64-170)


def _warm_pair(body_of, mode_suffix=None):
    """(JAX, port) daemons each solving the incremental request twice:
    the miss solves fully, the replay warm, both wires equal the JAX
    daemon's."""
    ref, port = jservice.SolverDaemon(), pdaemon()
    body = body_of(None)
    inc = body_of(_fp(body))
    rejected = dict(m.SOLVER_RESULT_REJECTED.values)
    out1 = both(inc, ref, port)
    assert port.incremental.last["outcome"] == "full"
    assert port.incremental.last["reason"] == "miss"
    out2 = both(inc, ref, port)
    assert port.incremental.last["outcome"] == "warm", port.incremental.last
    assert ref.incremental.last["outcome"] == "warm"
    assert view(out1) == view(out2)
    assert dict(m.SOLVER_RESULT_REJECTED.values) == rejected
    return port


@pytest.mark.parametrize("seed", range(14))
def test_fuzz_seed_warm_parity(seed):
    pods, existing, pools, its = fuzz_scenario(seed)
    _warm_pair(lambda prev: _encode(pools, its, existing, [], pods,
                                    max_slots=128, prev_fingerprint=prev))


def test_gang_problem_warm_parity():
    pools, its = [make_nodepool()], {"default": fake_instance_types(4)}
    pods = []
    for i in range(4):
        p = make_pod(cpu=1.0, name=f"g{i}")
        p.metadata.annotations[GANG_ANNOTATION] = "job-1"
        pods.append(p)
    _warm_pair(lambda prev: _encode(pools, its, [], [], pods,
                                    prev_fingerprint=prev))


def test_relax_problem_warm_parity_and_mode_keyed_ledger():
    pools, its = [make_nodepool()], {"default": fake_instance_types(4)}
    pods = [make_pod(cpu=1.0, name=f"r{i}") for i in range(8)]
    ref, port = jservice.SolverDaemon(), pdaemon()
    for mode in ("ffd", "relax"):
        body = _encode(pools, its, [], [], pods, solver_mode=mode)
        inc = _encode(pools, its, [], [], pods, solver_mode=mode,
                      prev_fingerprint=_fp(body))
        out1 = both(inc, ref, port)
        assert port.incremental.last["outcome"] == "full"
        out2 = both(inc, ref, port)
        assert port.incremental.last["outcome"] == "warm"
        assert view(out1) == view(out2)
    assert port.incremental.ledger.stats()["entries"] == 2


def test_relax_warm_start_plane_reaches_the_scheduler():
    """A relax replay that needs a fresh solve hands the ledger's prior
    template choice to the port's DeviceScheduler (``_relax_warm``), which
    lowers it to the warm_template plane: the warm classes are counted in
    the relax stats, as in the JAX package."""
    pools, its = two_pool_world()
    pods = [make_pod(cpu=1.0, name=f"w{i}") for i in range(24)]
    ref, port = jservice.SolverDaemon(), pdaemon()
    engine = incsolve.IncrementalEngine(full_interval=1)
    port.incremental = engine
    ref.incremental = jincsolve.IncrementalEngine(full_interval=1)
    body = _encode(pools, its, [], [], pods, solver_mode="relax")
    inc = _encode(pools, its, [], [], pods, solver_mode="relax",
                  prev_fingerprint=_fp(body))
    for _ in range(3):
        both(inc, ref, port)
    scheds = list(port._sched_cache.values())
    assert scheds and scheds[0]._relax_warm
    ref_sched = next(iter(ref._sched_cache.values()))
    assert scheds[0].last_phase_stats.get("relax") == (
        ref_sched.last_phase_stats.get("relax"))


# ---------------------------------------------------------------------------
# the fleet tier (tests/test_segments.py's fleet cases)


def _fake_members(n):
    return [remote.SolverClient(f"127.0.0.1:{9000 + i}", member=str(i))
            for i in range(n)]


class TestFleetRouter:
    def test_affinity_is_deterministic_per_key(self):
        router = remote.FleetRouter(_fake_members(4))
        keys = [f"catalog-{i}" for i in range(32)]
        first = {k: router._pick(k) for k in keys}
        for _ in range(3):
            assert {k: router._pick(k) for k in keys} == first
        assert set(router.snapshot()["routed"]) == {"affinity"}

    def test_member_churn_remaps_only_the_dead_members_keys(self):
        router = remote.FleetRouter(_fake_members(4))
        keys = [f"catalog-{i}" for i in range(64)]
        before = {k: router._pick(k) for k in keys}
        dead = before[keys[0]]
        b = router.members[dead].breaker
        b.state = remote.STATE_OPEN
        b.opened_at = b.time_fn() + 10_000
        after = {k: router._pick(k) for k in keys}
        for k in keys:
            if before[k] == dead:
                assert after[k] != dead
            else:
                assert after[k] == before[k]

    def test_affinity_off_routes_least_loaded(self):
        router = remote.FleetRouter(_fake_members(3), affinity=False)
        picks = {router._pick("same-key") for _ in range(6)}
        assert router.snapshot()["routed"] == {"spill": 6}
        assert picks == {0}

    def test_spill_over_under_forced_drain(self):
        pools, its = interop.from_reference(
            ([make_nodepool()], {"default": list(build_catalog(
                cpu_grid=[1, 2, 4], mem_factors=[2]))}))
        pods = interop.from_reference(
            [make_pod(cpu=0.5, name=f"p-{i}") for i in range(12)])
        srvs = [served()[0] for _ in range(2)]
        try:
            members = [
                remote.SolverClient(f"127.0.0.1:{s.server_address[1]}",
                                    timeout=120, member=str(i))
                for i, s in enumerate(srvs)]
            router = remote.FleetRouter(members)
            rs = remote.RemoteScheduler(router, pools, its)
            assert rs.solve(pods).all_pods_scheduled()
            served_by = next(i for i, c in enumerate(members)
                             if len(c.segcache) > 0)
            srvs[served_by].daemon_.gateway.drain()
            fallbacks = m.SOLVER_RPC_FALLBACKS.value({"endpoint": "solve"})
            assert rs.solve(pods).all_pods_scheduled()
            assert router.snapshot()["routed"].get("spill", 0) >= 1
            assert m.SOLVER_RPC_FALLBACKS.value(
                {"endpoint": "solve"}) == fallbacks
            assert router.health()["ready_members"] >= 1
        finally:
            for s in srvs:
                stop(s)

    def test_member_kill_respawn_costs_one_reupload_not_greedy(
            self, monkeypatch):
        """A real CPU child dies and respawns: the next solve pays one
        segment re-upload, no greedy fallback, the breaker closed."""
        pools, its = interop.from_reference(
            ([make_nodepool()], {"default": list(build_catalog(
                cpu_grid=[1, 2, 4], mem_factors=[2]))}))
        pods = interop.from_reference(
            [make_pod(cpu=0.5, name=f"p-{i}") for i in range(12)])
        monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the child's torch
        sup = SolverSupervisor(port=0, backoff_initial=0.05, device="cpu",
                               kernel="reference")
        addr = sup.start()
        try:
            member = remote.SolverClient(addr, timeout=120, member="0")
            router = remote.FleetRouter([member])
            rs = remote.RemoteScheduler(router, pools, its)
            assert rs.solve(pods).all_pods_scheduled()
            inst_before = member.segcache.instance()
            sup.proc.kill()
            sup.proc.wait(timeout=15)
            assert _wait_respawn(sup, router)
            fallbacks = m.SOLVER_RPC_FALLBACKS.value({"endpoint": "solve"})
            before = dict(m.SOLVER_SEGMENT_WIRE_BYTES.values)
            assert rs.solve(pods).all_pods_scheduled()
            after = dict(m.SOLVER_SEGMENT_WIRE_BYTES.values)
            assert m.SOLVER_RPC_FALLBACKS.value(
                {"endpoint": "solve"}) == fallbacks
            assert member.breaker.state == remote.STATE_CLOSED
            assert after.get((("kind", "segment"),), 0) > before.get(
                (("kind", "segment"),), 0)
            assert member.segcache.instance() not in ("", inst_before)
        finally:
            sup.stop()


def _wait_respawn(sup, client_or_router, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if sup.poll():
            client_or_router.set_addr(sup.addr)
            return True
        time.sleep(0.1)
    return False


# ---------------------------------------------------------------------------
# a sticky CUDA error takes the crash-only exit (ROADMAP C.1)


def test_sticky_cuda_error_exits_and_keeps_the_digest_in_flight(
        monkeypatch, tmp_path):
    """The kernel seam raises the CUDA runtime's illegal-address error:
    the daemon drains, calls its exit hook with WATCHDOG_EXIT_CODE, and
    leaves the digest in flight in the journal, so the next process's
    quarantine charges it a strike. A plain error does neither."""
    from karpenter_core_tpu_torch.utils.device import is_sticky_cuda_error

    def faulting_scan(*args, **kwargs):
        raise RuntimeError(f"ffd_scan launch failed: {STICKY}")

    journal = str(tmp_path / "poison.json")
    exits = []
    daemon = pdaemon(exit_fn=exits.append, quarantine=fleet.PoisonQuarantine(
        strikes=1, site="gateway", journal_path=journal))
    pools, its, pods = _port_problem(2)
    body = codec.encode_solve_request(pools, its, [], [], pods, max_slots=16)
    digest = codec.request_digest(body)
    monkeypatch.setattr(tprov, "_run_kernel_solo", faulting_scan)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        daemon.solve(body)
    assert exits == [WATCHDOG_EXIT_CODE]
    assert daemon.health()["draining"] is True
    assert json.loads(open(journal).read())["inflight"] == [digest]
    respawned = fleet.PoisonQuarantine(strikes=1, site="gateway",
                                       journal_path=journal)
    assert respawned.quarantined(digest)
    # a host-side error is an ordinary strike, no exit
    assert not is_sticky_cuda_error(RuntimeError("chaos: poisoned"))
    assert not is_sticky_cuda_error(ValueError(STICKY))
    try:
        raise RuntimeError("decode failed") from RuntimeError(STICKY)
    except RuntimeError as e:
        assert is_sticky_cuda_error(e)


_FAULTING_CHILD = """
import os, sys
from karpenter_core_tpu_torch.models import provisioner
from karpenter_core_tpu_torch.solver import service

MARK = sys.argv.pop(1)
real_scan = provisioner._run_kernel_solo

def faulting_scan(*args, **kwargs):
    # the first child faults once; its respawned successor finds the mark
    if not os.path.exists(MARK):
        open(MARK, "w").close()
        raise RuntimeError(
            "CUDA error: an illegal memory access was encountered")
    return real_scan(*args, **kwargs)

provisioner._run_kernel_solo = faulting_scan
sys.argv = ["solverd"] + sys.argv[1:]
raise SystemExit(service.main())
"""


def test_sticky_cuda_error_in_a_child_respawns_it(tmp_path, monkeypatch):
    """End to end with a real child whose kernel seam faults once: the
    child exits WATCHDOG_EXIT_CODE, the solve in flight fails (no greedy
    fallback: the reconcile errs and its pods wait), the supervisor
    respawns the child, whose quarantine journal charges the crash one
    strike, and the respawned child answers the re-solve."""
    journal = str(tmp_path / "poison.json")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the child's torch
    sup = SolverSupervisor(
        command=[sys.executable, "-c", _FAULTING_CHILD,
                 str(tmp_path / "faulted"), "--port", "0",
                 "--device", "cpu", "--kernel", "reference",
                 "--quarantine-journal", journal,
                 "--quarantine-strikes", "2"],
        backoff_initial=0.05)
    addr = sup.start()
    try:
        pools, its, pods = _port_problem(2)
        client = remote.SolverClient(addr, timeout=60, max_retries=0,
                                     sleep=lambda s: None)
        crash_before = m.SOLVERD_RESTARTS.value({"cause": "crash"})
        fallbacks = m.SOLVER_RPC_FALLBACKS.value({"endpoint": "solve"})
        with pytest.raises(remote.RemoteSolverError):
            remote.RemoteScheduler(client, pools, its).solve(pods)
        assert sup.proc.wait(timeout=30) == WATCHDOG_EXIT_CODE
        assert _wait_respawn(sup, client)
        assert m.SOLVERD_RESTARTS.value(
            {"cause": "crash"}) == crash_before + 1
        from urllib.request import urlopen

        health = json.loads(urlopen(f"http://{sup.addr}/healthz",
                                    timeout=10).read())
        assert health["quarantine_entries"] == 0  # one strike of two
        recovered = json.loads(open(journal).read())
        assert recovered["inflight"] == []
        assert list(recovered["strikes"].values()) == [1]
        # the next pass: the respawned child (a fresh context) answers
        assert remote.RemoteScheduler(client, pools, its).solve(
            pods).all_pods_scheduled()
        assert m.SOLVER_RPC_FALLBACKS.value(
            {"endpoint": "solve"}) == fallbacks
    finally:
        sup.stop()
