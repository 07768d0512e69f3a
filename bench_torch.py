"""The port's answer check: bench.py's configs through ``karpenter_core_tpu_torch``.

Run from the root of a checkout:

    python3 bench_torch.py [--configs cfgA,cfgB]   # on the GPU
    python3 bench_torch.py --device cpu            # plain scan

Each config of bench.py runs its problem through the port once (and, where
bench.py reads its answer after warm solves, one warm solve more, so the
answer comes from the same state: the prepared cache and the slot hint in
play) and is held to the JAX package's answer. Nothing is timed here: the
port's speed is measured by ``kbench/``. It prints ONE JSON line:
``configs`` (the ``--configs`` selection), ``device``, ``torch``, ``cuda``,
``source_digest`` (``chip_smoke.source_digest``), ``correct`` and
``detail`` (one dict a config, the primary first). The config names,
``--configs`` prefix matching and the ``BENCH_PODS`` / ``BENCH_TYPES`` /
``BENCH_FAST`` knobs are bench.py's; see its docstring for what each config
exercises. Every solve verifies its result, as the production default does.

* ``--device cuda|cpu`` (default ``cuda``). Without a GPU ``cuda`` raises
  (``utils/device.resolve_device``); nothing falls back to the CPU. On the
  card every solve runs the CUDA FFD kernel (``kernel_backend="cuda"``); on
  the CPU the plain scan (``"reference"``). Every ``phases`` block names the
  backend that answered.
* On the card each config records ``kernel_launches`` (in ``phases`` where
  the config has them, else in ``readings``): the growth of
  ``cuda_ffd.counter`` over the config's last call, the evidence that the
  kernel answered. A CPU run carries none.
* Each config records ``answers`` (``ANSWERS``: its node counts and, where
  it has them, evictions, gangs, $-cost, relax outcome, frontier, wire
  parity and the twin's ledger), ``expected`` (the JAX package's answer at
  this run's sizes, pinned in ``EXPECTED`` / ``EXPECTED_FAST`` with the
  command that produced it; null at sizes with no pinned answer) and
  ``correct``: the answers equal ``expected``, the config's structural
  ``GATES`` hold and the verifier's rejection counter
  (``SOLVER_RESULT_REJECTED``) did not move. The host ``Scheduler`` stays
  the independent greedy oracle (``parity_nodes_delta``).
* ``cfg17_pallas`` keeps its name: it holds the ``cuda`` and ``reference``
  backends to one result wire and one fetch-window byte count.
* A sidecar solve that is not answered degrades to the host greedy
  ``Scheduler`` as in bench.py: cfg7 counts ``greedy_fallbacks`` and its
  forced-shed probe checks ``shed_parity_ok``.
* ``--restart-probe`` and ``--multidev-probe`` are the child modes of the
  ``restart`` and ``cfg8_multidev`` configs.

Exit codes: 0 when every config is ``correct``, 4 when one is not (the
JSON line is printed first). A config that raises is not caught.
"""
from __future__ import annotations

import json
import os
import sys

N_PODS = int(os.environ.get("BENCH_PODS", "50000"))
N_TYPES = int(os.environ.get("BENCH_TYPES", "800"))
FAST = os.environ.get("BENCH_FAST", "") == "1"
GIB = 2.0**30


def _flag(name, default):
    if name in sys.argv:
        i = sys.argv.index(name)
        if i + 1 >= len(sys.argv):
            raise SystemExit(f"{name} needs a value")
        return sys.argv[i + 1]
    return default


DEVICE = _flag("--device", "cuda")
# the kernel backend every solve runs: the CUDA kernel on the card, the
# plain scan on the CPU
KERNEL = "cuda" if DEVICE == "cuda" else "reference"


def _pool(name="default", taints=None, requirements=None):
    from karpenter_core_tpu_torch.api.nodepool import NodePool, NodePoolSpec
    from karpenter_core_tpu_torch.api.objects import ObjectMeta

    pool = NodePool(metadata=ObjectMeta(name=name))
    pool.spec = NodePoolSpec()
    if taints:
        pool.spec.template.taints = list(taints)
    if requirements:
        pool.spec.template.requirements = list(requirements)
    return pool


def _plain_pods(n, shapes=(16, 12)):
    """Diverse cpu/mem shapes -> many pod equivalence classes (the FFD scan
    length); mirrors the benchmark's diverse pod mix minus topology."""
    from karpenter_core_tpu_torch.api.objects import ObjectMeta, Pod

    a, b = shapes
    return [
        Pod(
            metadata=ObjectMeta(name=f"p{i}"),
            resource_requests={
                "cpu": 0.1 * (1 + i % a),
                "memory": 0.25 * GIB * (1 + (i // a) % b),
            },
        )
        for i in range(n)
    ]


def _masked_pods(n):
    """BASELINE config 2: 1/3 plain, 1/3 nodeSelector+zone-affinity, 1/3
    toleration-gated onto a tainted pool (requirement/taint mask paths)."""
    from karpenter_core_tpu_torch.api import labels as L
    from karpenter_core_tpu_torch.api.objects import (
        Affinity,
        NodeAffinity,
        NodeSelectorRequirement,
        NodeSelectorTerm,
        ObjectMeta,
        Pod,
        Toleration,
    )

    pods = []
    for i in range(n):
        kind = i % 3
        requests = {
            "cpu": 0.1 * (1 + i % 8),
            "memory": 0.25 * GIB * (1 + (i // 8) % 6),
        }
        if kind == 0:
            pods.append(
                Pod(metadata=ObjectMeta(name=f"m{i}"), resource_requests=requests)
            )
        elif kind == 1:
            pods.append(
                Pod(
                    metadata=ObjectMeta(name=f"m{i}"),
                    resource_requests=requests,
                    node_selector={L.LABEL_OS: "linux"},
                    affinity=Affinity(
                        node_affinity=NodeAffinity(
                            required=[
                                NodeSelectorTerm(
                                    match_expressions=(
                                        NodeSelectorRequirement(
                                            L.LABEL_TOPOLOGY_ZONE,
                                            "In",
                                            ("zone-a", "zone-b"),
                                        ),
                                    )
                                )
                            ]
                        )
                    ),
                )
            )
        else:
            pods.append(
                Pod(
                    metadata=ObjectMeta(name=f"m{i}"),
                    resource_requests=requests,
                    node_selector={"pool": "batch"},
                    tolerations=[
                        Toleration(key="batch", operator="Exists", effect="NoSchedule")
                    ],
                )
            )
    return pods


def _topology_pods(n, n_deploys=10):
    """BASELINE cfg3: the reference benchmark's diverse mix
    (scheduling_benchmark_test.go:233-247) — 1/6 each generic, zonal
    node-affinity, nodeSelector, zone spread, hostname spread, hostname
    anti-affinity — in deployment-style cohorts (shared labels/selectors)
    so classes collapse the way real workloads do."""
    from karpenter_core_tpu_torch.api import labels as L
    from karpenter_core_tpu_torch.api.objects import (
        Affinity,
        LabelSelector,
        NodeAffinity,
        NodeSelectorRequirement,
        NodeSelectorTerm,
        ObjectMeta,
        Pod,
        PodAffinity,
        PodAffinityTerm,
        TopologySpreadConstraint,
    )

    def selector(labels):
        return LabelSelector(match_labels=tuple(sorted(labels.items())))

    pods = []
    for i in range(n):
        kind = i % 6
        dep = (i // 6) % n_deploys
        requests = {
            "cpu": 0.1 * (1 + i % 8),
            "memory": 0.25 * GIB * (1 + (i // 8) % 6),
        }
        name = f"t{i}"
        if kind == 0:
            pods.append(Pod(metadata=ObjectMeta(name=name),
                            resource_requests=requests))
        elif kind == 1:
            pods.append(Pod(
                metadata=ObjectMeta(name=name),
                resource_requests=requests,
                affinity=Affinity(node_affinity=NodeAffinity(required=[
                    NodeSelectorTerm(match_expressions=(
                        NodeSelectorRequirement(
                            L.LABEL_TOPOLOGY_ZONE, "In",
                            ("zone-a", "zone-b")),
                    ))
                ])),
            ))
        elif kind == 2:
            pods.append(Pod(
                metadata=ObjectMeta(name=name),
                resource_requests=requests,
                node_selector={L.LABEL_OS: "linux"},
            ))
        elif kind == 3:
            labels = {"app": f"spread-z-{dep}"}
            pods.append(Pod(
                metadata=ObjectMeta(name=name, labels=labels),
                resource_requests=requests,
                topology_spread_constraints=[TopologySpreadConstraint(
                    max_skew=1,
                    topology_key=L.LABEL_TOPOLOGY_ZONE,
                    when_unsatisfiable="DoNotSchedule",
                    label_selector=selector(labels),
                )],
            ))
        elif kind == 4:
            labels = {"app": f"spread-h-{dep}"}
            pods.append(Pod(
                metadata=ObjectMeta(name=name, labels=labels),
                resource_requests=requests,
                topology_spread_constraints=[TopologySpreadConstraint(
                    max_skew=1,
                    topology_key=L.LABEL_HOSTNAME,
                    when_unsatisfiable="DoNotSchedule",
                    label_selector=selector(labels),
                )],
            ))
        else:
            labels = {"app": f"anti-{dep}"}
            pods.append(Pod(
                metadata=ObjectMeta(name=name, labels=labels),
                resource_requests=requests,
                affinity=Affinity(pod_anti_affinity=PodAffinity(required=[
                    PodAffinityTerm(
                        topology_key=L.LABEL_HOSTNAME,
                        label_selector=selector(labels),
                    )
                ])),
            ))
    return pods


def _greedy_nodes(pods, nodepools, catalog):
    """The greedy oracle's node count on the identical inputs."""
    import copy

    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.scheduler import (
        Scheduler,
    )

    its = {p.name: list(catalog) for p in nodepools}
    s = Scheduler(copy.deepcopy(nodepools), its)
    res = s.solve(copy.deepcopy(pods))
    assert res.all_pods_scheduled(), list(res.pod_errors.items())[:3]
    return res.node_count()


def _phase_breakdown(sched) -> dict:
    """What the LAST solve did (DeviceScheduler.last_phase_stats): the
    device<->host bytes moved, the slot usage, the prepared-cache hits, the
    solve backend (``solver_mode``, with relax's verdict block) and the
    kernel backend that answered (``kernel_backend``: ``cuda`` or
    ``reference``)."""
    st = sched.last_phase_stats or {}
    out = {}
    for k in ("fetch_bytes", "h2d_bytes", "rounds", "slots", "used_slots",
              "prep_cache_hits", "prep_cache_misses",
              "n_devices", "h2d_dev_bytes", "fetch_dev_bytes"):
        if k in st:
            out[k] = int(st[k])
    out["solver_mode"] = st.get(
        "solver_mode", getattr(sched, "solver_mode", "ffd")
    )
    out["kernel_backend"] = st.get(
        "kernel_backend", getattr(sched, "kernel_backend", KERNEL)
    )
    if "relax" in st:
        out["relax"] = dict(st["relax"])
    return out


def _platform() -> str:
    """The device block's platform: ``gpu`` or ``cpu``."""
    return "gpu" if DEVICE == "cuda" else "cpu"


def _launches() -> int:
    """Kernel launches so far (the wrappers count only launches on the
    card)."""
    from karpenter_core_tpu_torch.ops import cuda_ffd

    return cuda_ffd.counter.total()


def _counted(fn):
    """One call of ``fn``: (its result, the kernel launches it made)."""
    n0 = _launches()
    res = fn()
    return res, _launches() - n0


def _readings(launches) -> dict:
    """The card's reading of a config (empty on the CPU, where no kernel
    runs): the kernel launches of its last call."""
    return {"kernel_launches": int(launches)} if DEVICE == "cuda" else {}


def _warm(fn):
    """A cold call of ``fn`` and one warm call, the warm one's (result,
    launches): the answer read with the prepared cache and the slot hint
    in play, as bench.py reads it."""
    fn()
    return _counted(fn)


def _solve_bench(pods, nodepools, catalog, max_slots=1024, parity=True,
                 devices=1, kernel=None):
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler

    kernel = KERNEL if kernel is None else kernel
    its = {p.name: list(catalog) for p in nodepools}
    sched = DeviceScheduler(
        nodepools, its, max_slots=max_slots, devices=devices,
        kernel_backend=kernel, device=DEVICE,
    )
    res = sched.solve(pods)
    assert res.all_pods_scheduled(), list(res.pod_errors.items())[:3]
    res, launches = _counted(lambda: sched.solve(pods))
    out = {
        "nodes": res.node_count(),
        "phases": {**_phase_breakdown(sched), **_readings(launches)},
    }
    if parity:
        out["greedy_nodes"] = _greedy_nodes(pods, nodepools, catalog)
        out["parity_nodes_delta"] = res.node_count() - out["greedy_nodes"]
    return out


def _ice_storm_bench(n_pods=5000, n_types=400, fractions=(0.0, 0.25, 0.5)):
    """Solves under an ICE storm: a growing fraction of the catalog's
    offerings — CHEAPEST first, exactly the rows the packer wants — marked
    unavailable through the same snapshot the provisioner passes (the
    UnavailableOfferings cache populated by lifecycle on
    InsufficientCapacityError): the stockout mask (apply_unavailable
    catalog projection + the off_avail tensor mask) and the repack around
    dead capacity."""
    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.cloudprovider.types import OfferingKey
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler

    catalog = bench_catalog(n_types)
    pools = [_pool()]
    by_price = sorted(
        (off.price, OfferingKey(it.name, off.zone, off.capacity_type))
        for it in catalog
        for off in it.offerings
    )
    out = {}
    for frac in fractions:
        k = int(len(by_price) * frac)
        unavail = frozenset(key for _, key in by_price[:k])
        sched = DeviceScheduler(
            pools,
            {p.name: list(catalog) for p in pools},
            max_slots=1024,
            unavailable_offerings=unavail,
            kernel_backend=KERNEL,
            device=DEVICE,
        )
        pods = _plain_pods(n_pods)
        res, launches = _warm(lambda: sched.solve(pods))
        entry = {
            "unavailable_offerings": k,
            "nodes": res.node_count(),
            "all_scheduled": res.all_pods_scheduled(),
        }
        readings = _readings(launches)
        if readings:
            entry["readings"] = readings
        out[f"storm_{int(frac * 100)}pct"] = entry
    return out


def _shape_churn_bench(n=20000, types=800, rounds=6):
    """Every solve mutates the pod mix — different pod counts AND a
    different shape grid, so class counts drift round to round through one
    scheduler, whose bucketed device shapes (models/provisioner._bucket)
    keep the prepared planes in a few buckets. ``nodes_by_round`` is each
    round's answer."""
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler
    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog

    catalog = bench_catalog(types)
    sched = DeviceScheduler(
        [_pool()], {"default": list(catalog)}, max_slots=1024,
        kernel_backend=KERNEL, device=DEVICE,
    )
    nodes = []
    launches = 0
    for r in range(rounds):
        pods = _plain_pods(n + 53 * r, shapes=(14 + r % 3, 11 + r % 2))
        res, launches = _counted(lambda: sched.solve(pods))
        assert res.all_pods_scheduled(), list(res.pod_errors.items())[:3]
        nodes.append(res.node_count())
    out = {"rounds": rounds, "nodes_by_round": nodes}
    readings = _readings(launches)
    if readings:
        out["readings"] = readings
    return out


def _consolidation_bench(n_nodes=2000, n_candidates=100):
    """BASELINE config 4: the multi-node consolidation frontier over a
    2k-node cluster — all `n_candidates` prefixes in one batched scan
    (models/consolidation.py; one kernel launch on the card) instead of the
    reference's binary search of full scheduling simulations
    (multinodeconsolidation.go:110-162)."""
    import numpy as np
    import torch

    from karpenter_core_tpu_torch.api import labels as L
    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (
        SimNode,
    )
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (
        Topology,
    )
    from karpenter_core_tpu_torch.models.consolidation import (
        _it_price_vector,
        _prefix_scan,
        prefix_batches,
    )
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler

    catalog = bench_catalog(400)
    nodes = [
        SimNode(
            name=f"n{i}",
            labels={
                L.LABEL_ARCH: "amd64",
                L.LABEL_OS: "linux",
                L.LABEL_TOPOLOGY_ZONE: f"zone-{'abcd'[i % 4]}",
                L.NODEPOOL_LABEL_KEY: "default",
                L.LABEL_INSTANCE_TYPE: "s-8x-amd64-linux",
            },
            taints=[],
            # candidates (the first n_candidates) are under-utilized
            available={"cpu": 7.0 if i < n_candidates else 1.0,
                       "memory": 14 * GIB if i < n_candidates else 2 * GIB,
                       "pods": 200.0},
            capacity={"cpu": 8.0, "memory": 16 * GIB, "pods": 210.0},
        )
        for i in range(n_nodes)
    ]
    # each candidate carries 2 small reschedulable pods
    resched = _plain_pods(2 * n_candidates, shapes=(4, 3))

    sched = DeviceScheduler(
        [_pool()], {"default": catalog}, existing_nodes=nodes,
        max_slots=2560, kernel_backend=KERNEL, device=DEVICE,
    )
    sched.existing_nodes = nodes  # candidate-first order
    prep = sched._prepare(resched, 2560, Topology())
    classes = sched._class_steps(prep)

    kind_batch, count_batch = prefix_batches(
        prep,
        base_pods=[],
        candidate_pods=[resched[2 * i : 2 * i + 2] for i in range(n_candidates)],
    )
    Jp = int(classes.count.shape[0])
    if count_batch.shape[1] < Jp:  # steps pad to a bucketed count
        count_batch = np.pad(
            count_batch, ((0, 0), (0, Jp - count_batch.shape[1]))
        )

    args = (
        prep.init_state,
        classes,
        prep.statics,
        kind_batch,
        count_batch,
        torch.as_tensor(_it_price_vector(prep), device=DEVICE),
        len(sched.existing_nodes),
        KERNEL,
    )

    out, launches = _counted(lambda: _prefix_scan(*args))
    unplaced = out[1].cpu().numpy()
    result = {
        "prefixes": n_candidates,
        "cluster_nodes": n_nodes,
        "schedulable_prefixes": int((unplaced == 0).sum()),
    }
    readings = _readings(launches)
    if readings:
        result["readings"] = readings
    return result


def _sidecar_bench(n_pods=5000, n_types=400):
    """solverd: the same solve through the in-proc DeviceScheduler and
    through a sidecar (in-thread server — the codec, HTTP framing and
    result rematerialization are on the path); the two must give one node
    count."""
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler
    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.solver import remote, service

    pods = _plain_pods(n_pods)
    catalog = bench_catalog(n_types)
    pools = [_pool()]
    its = {"default": list(catalog)}

    sched = DeviceScheduler(pools, dict(its), max_slots=1024,
                            kernel_backend=KERNEL, device=DEVICE)
    res, _ = _warm(lambda: sched.solve(pods))
    assert res.all_pods_scheduled()
    inproc_nodes = res.node_count()

    srv = service.serve(0, daemon=service.SolverDaemon(
        device=DEVICE, kernel=KERNEL))
    try:
        client = remote.SolverClient(
            f"127.0.0.1:{srv.server_address[1]}", timeout=600
        )
        rs = remote.RemoteScheduler(
            client, pools, dict(its),
            device_scheduler_opts={"max_slots": 1024},
        )
        res, launches = _warm(lambda: rs.solve(pods))
        assert res.all_pods_scheduled()
        # mode parity: the sidecar is the SAME solver behind a wire — any
        # node-count delta vs in-proc means the codec/rebind leaked
        assert res.node_count() == inproc_nodes, (
            res.node_count(), inproc_nodes,
        )
        readings = _readings(launches)
    finally:
        srv.shutdown()
        srv.server_close()

    out = {
        "pods": n_pods,
        "nodes": inproc_nodes,
        "mode_parity_nodes_delta": 0,  # asserted equal above
    }
    if readings:
        out["readings"] = readings
    return out


def _fleet_bench(n_tenants=8, n_pods=1000, n_types=200):
    """cfg7_fleet: N synthetic tenants hammering ONE sidecar through the
    fleet gateway (solver/fleet.py). Every tenant owns a distinct problem
    fingerprint (tenant-named pool; identical catalog shapes) and the
    scheduler cache is deliberately smaller than the tenant count, so the
    heterogeneous mix churns it — the eviction counter must move.

    Phases: (1) solo — each tenant alone, a cold and a warm solve, the warm
    one's node count its answer; (2) concurrent — all tenants at once
    through their own RemoteSchedulers with a queue bound low enough that
    bursts shed; a solve still shed after its retries degrades to the host
    greedy Scheduler and is counted in ``greedy_fallbacks``; (3) a
    forced-shed parity probe — one solve against a saturated gateway takes
    the client's greedy path, and ``shed_parity_ok`` checks that its answer
    is the host ``Scheduler``'s (every pod placed, the same node count)."""
    import copy
    import threading

    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.scheduler import (
        Scheduler,
    )
    from karpenter_core_tpu_torch.metrics import wiring as m
    from karpenter_core_tpu_torch.solver import fleet, remote, service

    catalog = bench_catalog(n_types)
    tenants = [f"tenant{i}" for i in range(n_tenants)]
    problems = {}
    for i, tenant in enumerate(tenants):
        # the pod mix drifts per tenant (pods are fingerprint-exempt, but
        # the distinct pool name makes each tenant its own problem half)
        problems[tenant] = {
            "pools": [_pool(tenant)],
            "its": {tenant: list(catalog)},
            "pods": _plain_pods(n_pods, shapes=(8 + i % 3, 6)),
        }

    gateway = fleet.FleetGateway(max_depth=max(n_tenants - 2, 2))
    cache = fleet.BoundedSchedulerCache(max_entries=max(n_tenants // 2, 2))
    daemon = service.SolverDaemon(gateway=gateway, sched_cache=cache,
                                  device=DEVICE, kernel=KERNEL)
    srv = service.serve(0, daemon=daemon)
    try:
        addr = f"127.0.0.1:{srv.server_address[1]}"

        def scheduler_for(tenant):
            p = problems[tenant]
            client = remote.SolverClient(addr, timeout=600, tenant=tenant)
            return remote.RemoteScheduler(
                client, p["pools"], p["its"],
                device_scheduler_opts={"max_slots": 1024},
            )

        # -- solo -----------------------------------------------------------
        solo = {}
        for tenant in tenants:
            rs = scheduler_for(tenant)
            res, _ = _warm(lambda: rs.solve(problems[tenant]["pods"]))
            assert res.all_pods_scheduled()
            solo[tenant] = res.node_count()

        # -- concurrent -------------------------------------------------------
        fallbacks_before = m.SOLVER_RPC_FALLBACKS.value(
            {"endpoint": "solve"}
        )
        errors = []

        def hammer(tenant):
            try:
                res = scheduler_for(tenant).solve(problems[tenant]["pods"])
                assert res.all_pods_scheduled()
            except Exception as e:  # surfaced after join
                errors.append((tenant, repr(e)))

        threads = [
            threading.Thread(target=hammer, args=(t,), daemon=True)
            for t in tenants
        ]
        n0 = _launches()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        launches = _launches() - n0
        assert not errors, errors
        snap = gateway.snapshot()
        fallbacks = m.SOLVER_RPC_FALLBACKS.value(
            {"endpoint": "solve"}
        ) - fallbacks_before

        # -- forced-shed parity probe -------------------------------------
        parked = [
            gateway.submit("parked", fleet.LANE_SOLVE)
            for _ in range(gateway.max_depth - gateway.depth())
        ]
        probe = problems[tenants[0]]
        rs = scheduler_for(tenants[0])
        shed_res = rs.solve(probe["pods"])  # 429 -> client greedy path
        for ticket in parked:
            gateway.abandon(ticket)
        greedy = Scheduler(
            copy.deepcopy(probe["pools"]),
            {tenants[0]: list(catalog)},
        ).solve(copy.deepcopy(probe["pods"]))
        parity_ok = (
            shed_res.all_pods_scheduled()
            and shed_res.node_count() == greedy.node_count()
        )

        out = {
            "tenants": n_tenants,
            "pods_per_tenant": n_pods,
            "shed_total": sum(snap["sheds"].values()),
            "sheds_by_reason": snap["sheds"],
            "greedy_fallbacks": fallbacks,
            "cache_evictions": dict(cache.evictions),
            "cache_entries": len(cache),
            "cache_entry_bound": cache.max_entries,
            "shed_parity_ok": parity_ok,
            "per_tenant": {t: {"nodes": solo[t]} for t in tenants},
        }
        readings = _readings(launches)
        if readings:
            out["readings"] = readings
        return out
    finally:
        srv.shutdown()
        srv.server_close()


def _batch_bench(n_tenants=32, n_pods=120, n_types=60):
    """cfg10_batch: continuous cross-tenant solve batching.

    The many-small-solves traffic shape: N tenants, each with a SMALL
    problem (distinct fingerprint — tenant-named pool — but identical
    catalog/pod SHAPES, so every tenant lands in the same shape
    bucket), hammering one sidecar concurrently, one solve each. Two
    phases over the same problems:

    * serialized — max_batch=1: the cfg7-shaped baseline, one exclusive
      device grant per request;
    * batched — the production defaults (max_batch=8, a few-ms window):
      a granted leader coalesces compatible queued problems into one
      batched multi-problem device dispatch (one kernel launch).

    Records every node count any solve returned (``nodes``), and the mean
    batch size and batch-axis padding ratio the gateway achieved."""
    import threading

    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.metrics import wiring as m
    from karpenter_core_tpu_torch.solver import fleet, remote, service

    catalog = bench_catalog(n_types)
    tenants = [f"bt{i:02d}" for i in range(n_tenants)]
    problems = {
        tenant: {
            "pools": [_pool(tenant)],
            "its": {tenant: list(catalog)},
            # identical shape grid for every tenant: same pod-count bucket
            # and catalog cardinality -> same problem_bucket, which is
            # exactly the production fleet shape batching targets
            "pods": _plain_pods(n_pods, shapes=(6, 4)),
        }
        for tenant in tenants
    }

    def run_phase(max_batch, window_s):
        gateway = fleet.FleetGateway(
            # deep enough that nothing sheds: cfg7 owns overload behavior
            max_depth=2 * n_tenants + 4,
            max_batch=max_batch,
            batch_window=window_s,
        )
        cache = fleet.BoundedSchedulerCache(max_entries=n_tenants + 2)
        daemon = service.SolverDaemon(gateway=gateway, sched_cache=cache,
                                      device=DEVICE, kernel=KERNEL)
        srv = service.serve(0, daemon=daemon)
        try:
            addr = f"127.0.0.1:{srv.server_address[1]}"
            errors = []

            def solve(tenant):
                try:
                    p = problems[tenant]
                    client = remote.SolverClient(addr, timeout=600,
                                                 tenant=tenant)
                    res = remote.RemoteScheduler(
                        client, p["pools"], p["its"],
                        device_scheduler_opts={"max_slots": 256},
                    ).solve(p["pods"])
                    assert res.all_pods_scheduled(), res.pod_errors
                    nodes_seen.add(res.node_count())
                except Exception as e:  # surfaced after join
                    errors.append((tenant, repr(e)))

            threads = [
                threading.Thread(target=solve, args=(t,), daemon=True)
                for t in tenants
            ]
            pad_sum0 = sum(m.SOLVERD_BATCH_PADDING.sums.values())
            pad_n0 = sum(m.SOLVERD_BATCH_PADDING.totals.values())
            n0 = _launches()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            launches = _launches() - n0
            assert not errors, errors[:3]
            snap = gateway.snapshot()
            pad_n = sum(m.SOLVERD_BATCH_PADDING.totals.values()) - pad_n0
            pad_sum = sum(m.SOLVERD_BATCH_PADDING.sums.values()) - pad_sum0
            readings = _readings(launches)
            return {
                "solves": len(tenants),
                "grants": snap["grants"],
                "mean_batch_size": snap["batch"]["mean_size"],
                "coalesced": snap["batch"]["coalesced"],
                "padding_ratio": round(pad_sum / pad_n, 4) if pad_n else 0.0,
                **({"readings": readings} if readings else {}),
            }
        finally:
            srv.shutdown()
            srv.server_close()

    # every tenant's problem is the same shape: one node count answers
    # them all (``nodes``, every count any solve returned)
    nodes_seen = set()
    serialized = run_phase(1, 0.0)
    batched = run_phase(
        fleet.DEFAULT_MAX_BATCH, fleet.DEFAULT_BATCH_WINDOW_MS / 1000.0
    )
    return {
        "tenants": n_tenants,
        "pods_per_tenant": n_pods,
        "backend": _platform(),
        "nodes": sorted(nodes_seen),
        "serialized": serialized,
        "batched": batched,
        # the coalescer engages: grants served >1 problem on average
        # under contention
        "coalesce_ok": batched["mean_batch_size"] >= 1.5,
        "mean_batch_size": batched["mean_batch_size"],
        "padding_ratio": batched["padding_ratio"],
    }


def _multidev_bench() -> dict:
    """cfg8_multidev: the primary config over every local GPU
    (``DeviceScheduler(devices=n)``, parallel/mesh.py: solo scans on the
    mesh's lead device, batched problems and the sweep's prefixes split
    over it) against one device. On a host without two GPUs it records
    `throughput_skipped` (bench.py's name) and runs the sharded-vs-single
    parity battery in a CHILD process on an 8-device virtual CPU mesh
    (``force_virtual_mesh(8, "cpu")``) instead."""
    import torch

    n_avail = torch.cuda.device_count() if DEVICE == "cuda" else 1
    if DEVICE == "cpu" or n_avail < 2:
        out = _run_multidev_probe()
        out.setdefault("throughput_skipped", True)
        out["reason"] = (
            f"{_platform()} backend with {n_avail} device(s);"
            " the multi-device run needs a real >=2-device slice"
        )
        return out

    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog

    catalog = bench_catalog(N_TYPES)
    pods = _plain_pods(N_PODS)
    single = _solve_bench(pods, [_pool()], catalog, parity=False, devices=1)
    multi = _solve_bench(
        pods, [_pool()], catalog, parity=False, devices=n_avail,
    )
    return {
        "n_devices": n_avail,
        "throughput_skipped": False,
        "single": single,
        "multi": multi,
        "parity_nodes_delta_multi_vs_single": (
            multi["nodes"] - single["nodes"]
        ),
    }


def _multidev_probe() -> None:
    """Child mode: an 8-device virtual CPU mesh runs the
    sharded-vs-single-device parity battery at small sizes — identical
    node counts and identical result wire bytes across an even split, a
    slot axis that needs padding (n_slots % n_devices != 0), and a
    3-device mesh, every solve on the plain scan; prints one JSON line
    for the parent."""
    from karpenter_core_tpu_torch.parallel.mesh import force_virtual_mesh

    force_virtual_mesh(8, "cpu")
    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler
    from karpenter_core_tpu_torch.solver import codec

    catalog = bench_catalog(100)
    parity = {}
    ok = True
    cases = (
        ("even_8dev", 256, 8),
        ("padded_slots_8dev", 100, 8),  # 100 -> 104 on the mesh
        ("uneven_3dev", 64, 3),
    )
    for name, max_slots, devices in cases:
        pods = _plain_pods(1000)
        its = {"default": list(catalog)}
        r1 = DeviceScheduler(
            [_pool()], dict(its), max_slots=max_slots, devices=1,
            device="cpu", kernel_backend="reference",
        ).solve(pods)
        rn = DeviceScheduler(
            [_pool()], dict(its), max_slots=max_slots, devices=devices,
            device="cpu", kernel_backend="reference",
        ).solve(pods)
        wire_ok = codec.encode_solve_results(
            rn, 0.0
        ) == codec.encode_solve_results(r1, 0.0)
        case_ok = (
            r1.all_pods_scheduled()
            and rn.all_pods_scheduled()
            and r1.node_count() == rn.node_count()
            and wire_ok
        )
        parity[name] = {
            "devices": devices,
            "max_slots": max_slots,
            "nodes_single": r1.node_count(),
            "nodes_sharded": rn.node_count(),
            "wire_parity": wire_ok,
            "ok": case_ok,
        }
        ok = ok and case_ok
    print(json.dumps({
        "n_devices": 8,
        "throughput_skipped": True,
        "parity_ok": ok,
        "parity": parity,
    }))


def _run_multidev_probe() -> dict:
    import subprocess

    try:
        proc = subprocess.run(
            [sys.executable, __file__, "--multidev-probe"],
            capture_output=True, text=True, timeout=600,
            env=dict(os.environ),
        )
    except subprocess.TimeoutExpired:
        return {"error": "multidev probe exceeded 600s"}
    for line in reversed(proc.stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except (ValueError, TypeError):
            continue
    return {"error": proc.stderr.strip()[-300:] or "no output"}


def _pallas_bench(n_pods=None, n_types=None, topo_pods=None,
                  topo_types=None, max_slots=1024, topo_slots=2048) -> dict:
    """cfg17_pallas (name kept so ``--configs`` matches bench.py's): the
    CUDA FFD kernel (``kernel_backend="cuda"``) against the plain scan
    (``"reference"``), its oracle, on the primary shape and the cfg3
    topology mix. The gates are parity: each shape solves once more under
    both backends through fresh schedulers and compares the encoded
    result wire, and the used-slot fetch window (host-side, post-kernel)
    must move the same ``fetch_dev_bytes`` on both. On the CPU both
    backends run the plain scan (the kernel wrapper's CPU route)."""
    import copy

    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler
    from karpenter_core_tpu_torch.solver import codec

    backend = _platform()
    n_pods = N_PODS if n_pods is None else n_pods
    n_types = N_TYPES if n_types is None else n_types
    # topology shape rides the round's pod knob on small runs (the cfg12
    # pattern): a default 50k-pod round keeps the classic cfg3 5k x 400
    topo_pods = min(5000, max(n_pods // 4, 400)) if topo_pods is None \
        else topo_pods
    topo_types = min(400, n_types) if topo_types is None else topo_types

    def wire_parity(pods, pools, catalog, slots):
        # one fresh solve per backend: byte compare the decision content
        # (solve_seconds pinned — timing is not packing)
        its = {p.name: list(catalog) for p in pools}
        wires = []
        for kb in ("reference", "cuda"):
            sched = DeviceScheduler(
                copy.deepcopy(pools), its, max_slots=slots,
                kernel_backend=kb, device=DEVICE,
            )
            wires.append(
                codec.encode_solve_results(
                    sched.solve(copy.deepcopy(pods)), 0.0
                )
            )
        return wires[0] == wires[1]

    def shape(pods, pools, catalog, slots):
        ref = _solve_bench(pods, pools, catalog, max_slots=slots,
                           parity=False, kernel="reference")
        cud = _solve_bench(pods, pools, catalog, max_slots=slots,
                           parity=False, kernel="cuda")
        return {
            "reference": ref,
            "cuda": cud,
            "wire_parity_ok": wire_parity(pods, pools, catalog, slots),
            # identical device fetch bytes: the used-slot window is
            # backend-agnostic host logic
            "fetch_dev_bytes_parity_ok": (
                ref["phases"].get("fetch_dev_bytes")
                == cud["phases"].get("fetch_dev_bytes")
            ),
            "nodes_delta_cuda_vs_reference": cud["nodes"] - ref["nodes"],
        }

    catalog = bench_catalog(n_types)
    primary = shape(_plain_pods(n_pods), [_pool()], catalog, max_slots)
    topology = shape(
        _topology_pods(topo_pods), [_pool()], bench_catalog(topo_types),
        topo_slots,
    )
    return {
        "backend": backend,
        "pods": n_pods,
        "topo_pods": topo_pods,
        "primary": primary,
        "topology": topology,
        "parity_ok": (
            primary["wire_parity_ok"] and topology["wire_parity_ok"]
            and primary["fetch_dev_bytes_parity_ok"]
            and topology["fetch_dev_bytes_parity_ok"]
        ),
    }


def _gangs_problem(n_pods, n_existing=None, pool="default"):
    """cfg11_gangs' problem: ~75% tier-0 plain pods, 10% system-critical
    pods of 6 cpu (past the 4-cpu fresh ceiling: they admit only by
    evicting strictly-lower-tier bound pods on the existing fleet), 15% of
    pods in 8-pod gangs, over ``n_existing`` (default n_pods / 250, at
    least 4) existing nodes with four 3-cpu tier-0 victims each, on a
    ``cpu_grid=[1, 2, 4]`` catalog. Returns (catalog, existing, pods)."""
    from karpenter_core_tpu_torch.api.objects import ObjectMeta, Pod
    from karpenter_core_tpu_torch.cloudprovider.kwok import build_catalog
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (
        EvictablePod,
        SimNode,
    )
    from karpenter_core_tpu_torch.solver.gangs import GANG_ANNOTATION

    catalog = build_catalog(cpu_grid=[1, 2, 4])  # fresh tops out at 4 cpu
    if n_existing is None:
        n_existing = max(4, n_pods // 250)
    existing = [
        SimNode(
            name=f"exist-{i}",
            labels={
                "topology.kubernetes.io/zone": "zone-a",
                "kubernetes.io/hostname": f"exist-{i}",
                "kubernetes.io/os": "linux",
                "kubernetes.io/arch": "amd64",
                "karpenter.sh/capacity-type": "on-demand",
                "karpenter.sh/nodepool": pool,
            },
            taints=[],
            available={"cpu": 0.5, "memory": 8 * GIB, "pods": 100.0},
            capacity={"cpu": 16.0, "memory": 16 * GIB, "pods": 110.0},
            initialized=True,
            evictable=tuple(
                EvictablePod(
                    uid=f"victim-{i}-{j}", priority=0,
                    requests={"cpu": 3.0, "memory": 0.5 * GIB},
                    cost=1.0 + 0.01 * j,
                )
                for j in range(4)
            ),
        )
        for i in range(n_existing)
    ]

    n_gang = int(n_pods * 0.15) // 8 * 8
    n_crit = int(n_pods * 0.10)
    pods = []
    for i in range(n_gang):
        p = Pod(
            metadata=ObjectMeta(
                name=f"g{i}",
                annotations={GANG_ANNOTATION: f"gang-{i // 8}"},
            ),
            resource_requests={
                "cpu": 0.5 * (1 + (i // 8) % 3),
                "memory": 0.25 * GIB * (1 + (i // 8) % 4),
            },
        )
        pods.append(p)
    for i in range(n_crit):
        # past the 4-cpu fresh ceiling: admits only via preemption; 16
        # memory shapes split the demand into classes so the bounded
        # per-class node fan-out (ops/gangsched.NODE_ROUNDS) spreads over
        # the fleet instead of serializing on one class
        p = Pod(
            metadata=ObjectMeta(name=f"c{i}"),
            resource_requests={
                "cpu": 6.0,
                "memory": 0.25 * GIB * (1 + i % 16),
            },
            priority=2_000_000_000,
        )
        pods.append(p)
    plain = _plain_pods(n_pods - len(pods))
    for p in plain:
        p.metadata.name = f"pl-{p.metadata.name}"
    pods.extend(plain)
    return catalog, existing, pods


def _gangs_bench(n_pods=20000, n_existing=None) -> dict:
    """cfg11_gangs: mixed-priority churn with gangs (``_gangs_problem``).

    Records:

    * preemption_count — victims named by the final solve's eviction
      claims (the drain-before-bind work the operator would execute);
    * eviction_minimality — evicted-cpu per admitted-cpu on preempted
      nodes, the minimality proxy: the kernel claims the cheapest
      sufficient PREFIX per node, so the ratio must stay near 1 (bounded
      by one victim's worth of overshoot per node, never a whole node's
      population for one pod);
    * gang_atomicity_violations — gangs left partially materialized
      (placed count in (0, min)); MUST be 0, and verification is ON so a
      forged packing would already have degraded;
    * nodes — the final solve's node count.
    """
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler
    from karpenter_core_tpu_torch.solver.gangs import (
        gang_min_count,
        pod_gang_sig,
    )
    from karpenter_core_tpu_torch.utils.disruption import priority_tier

    catalog, existing, pods = _gangs_problem(n_pods, n_existing)
    sched = DeviceScheduler(
        [_pool()], {"default": list(catalog)},
        existing_nodes=existing, max_slots=4096,
        kernel_backend=KERNEL, device=DEVICE,
    )
    res, launches = _warm(lambda: sched.solve(pods))
    phases = {**_phase_breakdown(sched), **_readings(launches)}

    preemption_count = sum(len(uids) for uids in res.evictions.values())
    # minimality proxy: evicted cpu per admitted cpu on preempted nodes,
    # resolved from the claimed uids' actual requests so re-sizing the
    # synthetic victims keeps the gate honest
    victim_cpu = {
        e.uid: e.requests.get("cpu", 0.0)
        for n in existing
        for e in n.evictable
    }
    evicted_cpu = sum(
        victim_cpu.get(uid, 0.0)
        for uids in res.evictions.values()
        for uid in uids
    )
    # denominator: preemption-ADMITTED cpu only. The preempt pass serves
    # positive tiers exclusively, so tier-0 plain pods that the main scan
    # packed into a claimed node's ordinary free capacity must not
    # inflate the ratio and mask an over-evicting regression.
    admitted_cpu = 0.0
    for sim in res.existing_nodes:
        if sim.name in res.evictions:
            admitted_cpu += sum(
                p.resource_requests.get("cpu", 0.0)
                for p in sim.pods
                if priority_tier(p.priority) > 0
            )
    minimality = (
        round(evicted_cpu / admitted_cpu, 3) if admitted_cpu else None
    )
    # gang atomicity over the final results: placed in (0, min) = violation
    placed_uids = {
        p.uid
        for c in res.new_node_claims
        for p in c.pods
    } | {p.uid for s in res.existing_nodes for p in s.pods}
    by_gang = {}
    for p in pods:
        g = pod_gang_sig(p)
        if g is not None:
            by_gang.setdefault(g[0], []).append(p)
    violations = 0
    gangs_placed = 0
    for name, mpods in by_gang.items():
        n_placed = sum(1 for p in mpods if p.uid in placed_uids)
        if n_placed >= gang_min_count(mpods):
            gangs_placed += 1
        elif n_placed > 0:
            violations += 1

    return {
        "pods": len(pods),
        "preemption_count": preemption_count,
        "eviction_minimality": minimality,
        # one 6-cpu admit needs 5.5 freed = 2 victims (6.0): per-node
        # overshoot is bounded by one victim, so the fleet-wide ratio must
        # stay under ~1.2 when anything preempted at all
        "eviction_minimality_ok": minimality is None or minimality <= 1.2,
        "gangs": len(by_gang),
        "gangs_placed": gangs_placed,
        "gang_atomicity_violations": violations,
        "gang_atomicity_ok": violations == 0,
        "unschedulable": len(res.pod_errors),
        "nodes": res.node_count(),
        "phases": phases,
    }


TOPO_GANG_SIZE, TOPO_MAX_HOPS, TOPO_MEMBER_CPU = 8, 2, 3.0


def _racked_nodes(n_existing, with_topo_labels, pool="default"):
    """cfg18's racked 2-zone fleet: zones interleaved in slot order (the
    adversarial order for a distance-blind first-fit), racks of two nodes,
    superpods of two racks; each node has room for two gang members. The
    rack and superpod labels only ``with_topo_labels``."""
    from karpenter_core_tpu_torch.api import labels as apilabels
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (
        SimNode,
    )

    nodes = []
    for i in range(n_existing):
        zone = "zone-a" if i % 2 == 0 else "zone-b"
        zi = i // 2  # creation order within the zone
        labels = {
            "topology.kubernetes.io/zone": zone,
            "kubernetes.io/hostname": f"exist-{i}",
            "kubernetes.io/os": "linux",
            "kubernetes.io/arch": "amd64",
            "karpenter.sh/capacity-type": "on-demand",
            "karpenter.sh/nodepool": pool,
        }
        if with_topo_labels:
            labels[apilabels.LABEL_TOPOLOGY_RACK] = f"{zone}-r{zi // 2}"
            labels[apilabels.LABEL_TOPOLOGY_SUPERPOD] = (
                f"{zone}-s{zi // 4}"
            )
        nodes.append(SimNode(
            name=f"exist-{i}",
            labels=labels,
            taints=[],
            available={
                "cpu": 2 * TOPO_MEMBER_CPU + 0.5,
                "memory": 8 * GIB,
                "pods": 100.0,
            },
            capacity={"cpu": 16.0, "memory": 16 * GIB, "pods": 110.0},
            initialized=True,
        ))
    return nodes


def _topoaware_pods(n_gangs, n_plain):
    """cfg18's pods: ``n_gangs`` comms-sensitive gangs of 8 members of 3
    cpu (past the 2-cpu fresh ceiling, so they live on the fleet), each
    declaring ``pod-group-max-hops: 2`` (same zone) and its rank, then
    ``n_plain`` plain filler pods."""
    from karpenter_core_tpu_torch.api.objects import ObjectMeta, Pod
    from karpenter_core_tpu_torch.solver.gangs import (
        GANG_ANNOTATION,
        GANG_MAX_HOPS_ANNOTATION,
        GANG_MIN_SIZE_ANNOTATION,
        GANG_RANK_ANNOTATION,
    )

    pods = []
    for g in range(n_gangs):
        for i in range(TOPO_GANG_SIZE):
            pods.append(Pod(
                metadata=ObjectMeta(
                    name=f"tg{g}-{i}",
                    annotations={
                        GANG_ANNOTATION: f"tgang-{g}",
                        GANG_MIN_SIZE_ANNOTATION: str(TOPO_GANG_SIZE),
                        GANG_MAX_HOPS_ANNOTATION: str(TOPO_MAX_HOPS),
                        GANG_RANK_ANNOTATION: str(i),
                    },
                ),
                resource_requests={
                    "cpu": TOPO_MEMBER_CPU, "memory": 0.25 * GIB,
                },
            ))
    plain = _plain_pods(n_plain)
    for p in plain:
        p.metadata.name = f"pl-{p.metadata.name}"
    pods.extend(plain)
    return pods


def _result_cost(res):
    """$-cost of a result: the cheapest available offering of each new
    claim's instance-type options."""
    total = 0.0
    for c in res.new_node_claims:
        total += min(
            off.price
            for it_ in c.instance_type_options
            for off in it_.offerings
            if off.available
        )
    return total


def _topoaware_bench(n_gangs=40, n_plain=2000) -> dict:
    """cfg18_topoaware: rank/topology-aware gang placement.

    A racked 2-zone fleet (``_racked_nodes``) hosting comms-sensitive
    8-pod gangs with a hard ``pod-group-max-hops: 2`` bound and
    per-member ranks, plus plain filler pods on fresh capacity
    (``_topoaware_pods``). Two runs of the IDENTICAL problem:

    * **aware** — nodes carry their rack/superpod labels, so the
      topology catalog engages: per-gang anchor planes steer the FFD
      level fill toward network-near slots;
    * **blind** — the same nodes with topology labels STRIPPED: the
      solver first-fits across the interleaved zones; hops are then
      measured against the TRUE racked labels the run couldn't see.

    Gates: ``topo_hops_ok`` — the aware run's worst intra-gang hop
    distance is STRICTLY below the blind control's at equal-or-better
    node count; ``hard_bound_ok`` — no accepted aware placement provably
    exceeds its declared bound (the verifier's sound re-derivation);
    ``gangs_placed_ok`` — every gang actually bound.
    """
    from karpenter_core_tpu_torch.cloudprovider.kwok import build_catalog
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler
    from karpenter_core_tpu_torch.solver.gangs import (
        hop_distance,
        placement_hop_bound,
    )

    catalog = build_catalog(cpu_grid=[1, 2])  # fresh tops out at 2 cpu
    max_hops = TOPO_MAX_HOPS  # hard bound: same zone
    gang_size = TOPO_GANG_SIZE
    # 2 members per node -> 4 nodes per gang, plus slack
    n_existing = 4 * n_gangs + 8

    # the TRUE topology, for judging both runs (the blind run never saw it)
    truth = {
        n.name: dict(n.labels)
        for n in _racked_nodes(n_existing, with_topo_labels=True)
    }
    pods = _topoaware_pods(n_gangs, n_plain)

    out = {"pods": len(pods), "gangs": n_gangs, "max_hops_bound": max_hops}
    for mode in ("aware", "blind"):
        existing = _racked_nodes(n_existing,
                                 with_topo_labels=(mode == "aware"))
        sched = DeviceScheduler(
            [_pool()], {"default": list(catalog)},
            existing_nodes=existing, max_slots=4096,
            kernel_backend=KERNEL, device=DEVICE,
        )
        res, launches = _warm(lambda: sched.solve(pods))
        phases = {**_phase_breakdown(sched), **_readings(launches)}
        # judge each gang's placement against the TRUE racked labels
        node_of = {}
        for sim in res.existing_nodes:
            for p in sim.pods:
                node_of[p.metadata.name] = sim.name
        worst_hops = 0
        worst_bound = 0
        gangs_placed = 0
        for g in range(n_gangs):
            placed = [
                truth[node_of[f"tg{g}-{i}"]]
                for i in range(gang_size)
                if f"tg{g}-{i}" in node_of
            ]
            if len(placed) < gang_size:
                continue
            gangs_placed += 1
            worst_hops = max(worst_hops, max(
                hop_distance(a, b)
                for i, a in enumerate(placed)
                for b in placed[i + 1:]
            ))
            worst_bound = max(worst_bound, placement_hop_bound(placed))
        out[mode] = {
            "max_intra_gang_hops": worst_hops,
            "provable_hop_bound": worst_bound,
            "gangs_placed": gangs_placed,
            "node_count": len(res.new_node_claims) + sum(
                1 for s in res.existing_nodes if s.pods
            ),
            "new_claims": len(res.new_node_claims),
            "cost_dollars_per_hour": round(_result_cost(res), 3),
            "unschedulable": len(res.pod_errors),
            "phases": phases,
        }
    aware, blind = out["aware"], out["blind"]
    out.update({
        "gangs_placed_ok": (
            aware["gangs_placed"] == n_gangs
            and blind["gangs_placed"] == n_gangs
        ),
        # strictly fewer hops at equal-or-better node count: the topo
        # steering pays in placement order, never in nodes
        "topo_hops_ok": (
            aware["max_intra_gang_hops"] < blind["max_intra_gang_hops"]
            and aware["node_count"] <= blind["node_count"]
        ),
        # the hard annotation bound holds on every ACCEPTED aware
        # placement, by the verifier's own sound re-derivation
        "hard_bound_ok": aware["provable_hop_bound"] <= max_hops,
    })
    return out


def _relax_world():
    """cfg12's two pools: ``a-first`` (first by name) offers only 4-cpu
    nodes, ``b-dense`` 16-cpu nodes at 0.75x the kwok price (a
    committed-use/spot-shaped discount: its per-pod $ is structurally lower
    for any class that can fill it — the cost surface the relaxation
    optimizes and first-template-wins is blind to). Returns (pools,
    instance types)."""
    from karpenter_core_tpu_torch.cloudprovider.kwok import build_catalog

    cat_a = build_catalog(cpu_grid=[4], mem_factors=[4], oses=["linux"],
                          arches=["amd64"])
    cat_b = build_catalog(cpu_grid=[16], mem_factors=[4], oses=["linux"],
                          arches=["amd64"])
    for it in cat_b:
        for off in it.offerings:
            off.price *= 0.75
    return ([_pool("a-first"), _pool("b-dense")],
            {"a-first": list(cat_a), "b-dense": list(cat_b)})


def _gang_tier_pods(n):
    """cfg12's cfg11-shaped traffic sans preemption fleet: 15% in 8-pod
    all-or-nothing gangs, 10% high-priority, the rest plain — the
    relaxation must compose gang atomicity and tier ordering."""
    from karpenter_core_tpu_torch.api.objects import ObjectMeta, Pod
    from karpenter_core_tpu_torch.solver.gangs import GANG_ANNOTATION

    n_gang = int(n * 0.15) // 8 * 8
    n_crit = int(n * 0.10)
    pods = []
    for i in range(n_gang):
        pods.append(Pod(
            metadata=ObjectMeta(
                name=f"g{i}",
                annotations={GANG_ANNOTATION: f"gang-{i // 8}"},
            ),
            resource_requests={
                "cpu": 0.5 * (1 + (i // 8) % 3),
                "memory": 0.25 * GIB * (1 + (i // 8) % 4),
            },
        ))
    for i in range(n_crit):
        pods.append(Pod(
            metadata=ObjectMeta(name=f"c{i}"),
            resource_requests={
                "cpu": 1.0, "memory": 0.25 * GIB * (1 + i % 4),
            },
            priority=1_000_000,
        ))
    plain = _plain_pods(n - len(pods), shapes=(4, 3))
    for p in plain:
        p.metadata.name = f"pl-{p.metadata.name}"
    return pods + plain


def _relax_bench(n_pods=5000):
    """cfg12_relax: the relaxsolve backend vs FFD on the two marquee
    shapes — cfg3-shaped (the diverse topology mix) and cfg11-shaped
    (gang/tier mix, ``_gang_tier_pods``) problems — over a two-pool
    catalog where first-template-wins is provably suboptimal
    (``_relax_world``). Both modes solve the IDENTICAL pod sets; the
    record is the node-count and $-cost delta — the gate is relax strictly
    fewer nodes AND dollars. Each mode's answer is read from a warm solve
    after the settle solve (relax's verdict-cached single dispatch)."""
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler

    pools, its = _relax_world()

    problems = {
        "cfg3_shape": _topology_pods(n_pods, n_deploys=max(n_pods // 500, 2)),
        "cfg11_shape": _gang_tier_pods(n_pods),
    }
    out = {"pods": n_pods, "pools": 2}
    for pname, pods in problems.items():
        entry = {}
        for mode in ("ffd", "relax"):
            sched = DeviceScheduler(
                pools, its, max_slots=4096,
                solver_mode=mode, kernel_backend=KERNEL, device=DEVICE,
            )
            sched.solve(pods)
            # settle solve: the adaptive slot axis shrinks after the cold
            # solve, which re-keys the class batch — this one pays the
            # re-evaluation at the settled shape, so the warm solve after
            # it is the steady state for BOTH modes (relax's is the
            # verdict-cached single dispatch)
            res, launches = _warm(lambda: sched.solve(pods))
            entry[mode] = {
                "nodes": res.node_count(),
                "cost": round(_result_cost(res), 3),
                "unschedulable": len(res.pod_errors),
                "phases": {**_phase_breakdown(sched), **_readings(launches)},
            }
        f, r = entry["ffd"], entry["relax"]
        entry["nodes_delta"] = r["nodes"] - f["nodes"]  # negative = win
        entry["cost_delta"] = round(r["cost"] - f["cost"], 3)
        entry["node_improved"] = r["nodes"] < f["nodes"]
        entry["cost_improved"] = r["cost"] < f["cost"]
        out[pname] = entry
    return out


def _delta_bench(
    n_pods=2000,
    n_nodes=600,
    n_types=300,
    churn=0.01,
    rounds=5,
    fleet_tenants=6,
    fleet_rounds=3,
    fleet_sizes=(1, 2, 4),
):
    """cfg13_delta: the delta wire + solver fleet.

    Phase 1 (wire): an operator-shaped problem — existing nodes carrying
    a topology context, a real catalog, a pending-pod batch sized at the
    churn fraction — re-solved across `rounds` snapshots that each
    replace ``churn`` of the nodes and mint a fresh pending batch.
    Both wire forms are driven against their own daemon (transport-free,
    so the bytes ARE the payloads): the full path re-encodes and ships
    everything; the delta path ships a digest manifest plus exactly the
    segments the far side has not seen (the client-side sent-set the
    real SolverClient keeps). Records per-re-solve bytes on both paths,
    the delta/full byte ratio (acceptance: <= 0.10 at scale), and
    node-count + result-wire parity per round (the manifest path may never
    change a packing).

    Phase 2 (fleet): N tenants with distinct catalogs (distinct problem
    fingerprints — warm scheduler caches are the prize) hammer 1 / 2 / 4
    in-thread sidecars through the client-side FleetRouter; at the
    largest size, affinity on vs off. Records the scheduler-cache hit rate
    per topology (affinity must keep re-solves hitting the member whose
    caches are warm)."""
    import copy
    import threading

    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.metrics import wiring as m
    from karpenter_core_tpu_torch.solver import codec, remote, segments, service

    catalog = bench_catalog(n_types)
    pools = [_pool()]
    its = {"default": list(catalog)}
    from karpenter_core_tpu_torch.api import labels as L
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (
        SimNode,
    )
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (
        Topology,
    )

    def make_node(name, i):
        return SimNode(
            name=name,
            labels={
                L.LABEL_ARCH: "amd64",
                L.LABEL_OS: "linux",
                L.LABEL_TOPOLOGY_ZONE: f"zone-{'abcd'[i % 4]}",
                L.LABEL_HOSTNAME: name,
                L.NODEPOOL_LABEL_KEY: "default",
            },
            taints=[],
            available={"cpu": 2.0, "memory": 4 * GIB, "pods": 200.0},
            capacity={"cpu": 8.0, "memory": 16 * GIB, "pods": 210.0},
            initialized=True,
        )

    nodes = [make_node(f"node-{i:05d}", i) for i in range(n_nodes)]
    # a topology context shaped like the provisioner's: a few bound pods
    # per node ride the wire as (pod, labels, node) triples
    ctx_pods = _plain_pods(2 * n_nodes, shapes=(4, 3))
    existing_pods = [
        (p, {"app": f"ctx-{i % 7}"}, nodes[i // 2].name)
        for i, p in enumerate(ctx_pods)
    ]
    domains = {
        L.LABEL_TOPOLOGY_ZONE: {f"zone-{z}" for z in "abcd"},
        L.LABEL_HOSTNAME: {n.name for n in nodes},
    }
    batch = max(int(n_pods * churn), 4)

    def snapshot(round_no):
        """Round r's churned snapshot: `churn` of the nodes replaced,
        a fresh pending batch (new pods ALWAYS ship — they are new)."""
        ns = list(nodes)
        k = max(int(n_nodes * churn), 1)
        for j in range(k):
            i = (round_no * 31 + j * 97) % n_nodes
            ns[i] = make_node(f"node-r{round_no}-{i:05d}", i)
        pending = _plain_pods(batch)
        for p in pending:
            p.metadata.name = f"r{round_no}-{p.metadata.name}"
        topo = Topology(
            domains={k_: set(v) for k_, v in domains.items()},
            existing_pods=[
                t for t in existing_pods
                if any(n.name == t[2] for n in ns)
            ],
            excluded_pod_uids={p.uid for p in pending},
        )
        return ns, pending, topo

    def result_view(out):
        h = codec._json_header(out)
        h.pop("solve_seconds", None)
        return h

    d_full = service.SolverDaemon(device=DEVICE, kernel=KERNEL)
    d_delta = service.SolverDaemon(device=DEVICE, kernel=KERNEL)
    # the client-side ledger (SolverClient.segcache shape): sent digests
    # + the last confirmed listing, so steady-state manifests ship
    # base+edits instead of the full digest listing
    sent = set()
    base = None
    full_bytes, delta_bytes = [], []
    parity_ok = True
    launches = 0
    for r in range(rounds + 1):  # round 0 is the cold start
        ns, pending, topo = snapshot(r)
        header = codec._encode_solve_header(
            pools, its, ns, [], pending, topology=topo, max_slots=1024,
        )
        body_full = codec._json_payload(header)
        out_full, _ = d_full.solve(body_full)

        plan = segments.split_solve_header(header)
        include = [dg for dg in plan.segments if dg not in sent]
        body_delta = codec.encode_manifest_request(plan, include, base=base)
        (out_delta, _), launches = _counted(lambda: d_delta.solve(body_delta))
        sent |= set(plan.segments)
        base = (plan.listing_digest, plan.listing)

        parity_ok = parity_ok and (
            result_view(out_full) == result_view(out_delta)
        )
        if r > 0:  # the cold round is the catalog upload, not the regime
            full_bytes.append(len(body_full))
            delta_bytes.append(len(body_delta))

    ratio = (
        sum(delta_bytes) / sum(full_bytes) if sum(full_bytes) else 1.0
    )
    nodes_full = len(codec._json_header(out_full)["claims"])
    nodes_delta = len(codec._json_header(out_delta)["claims"])
    readings = _readings(launches)

    wire = {
        "nodes": n_nodes,
        "ctx_pods": len(existing_pods),
        "pending_per_round": batch,
        "churn": churn,
        "rounds": rounds,
        "full_wire_bytes_per_resolve": int(
            sum(full_bytes) / max(len(full_bytes), 1)
        ),
        "delta_wire_bytes_per_resolve": int(
            sum(delta_bytes) / max(len(delta_bytes), 1)
        ),
        "delta_ratio": round(ratio, 4),
        # the acceptance gate: a 1%-churn re-solve ships <=10% of the
        # full wire (judged at the full-scale round; a BENCH_FAST run
        # has too little stable snapshot for 10% and records the ratio)
        "delta_ok": bool(ratio <= 0.10),
        "parity_ok": bool(parity_ok),
        "result_nodes_delta": nodes_delta - nodes_full,
        **({"readings": readings} if readings else {}),
    }

    # -- phase 2: 1 vs 2 vs 4 sidecars through the fleet router ------------

    tenant_problems = []
    for t in range(fleet_tenants):
        tcat = bench_catalog(max(n_types // 2 + 7 * t, 20))
        tenant_problems.append((
            f"tenant{t}",
            [_pool()],
            {"default": list(tcat)},
            _plain_pods(max(batch, 24)),
        ))

    def run_fleet(n_sidecars, affinity):
        srvs = [
            service.serve(0, daemon=service.SolverDaemon(
                device=DEVICE, kernel=KERNEL))
            for _ in range(n_sidecars)
        ]
        try:
            members = [
                remote.SolverClient(
                    f"127.0.0.1:{s.server_address[1]}",
                    timeout=600, member=str(i),
                )
                for i, s in enumerate(srvs)
            ]
            router = remote.FleetRouter(members, affinity=affinity)
            scheds = {
                tenant: remote.RemoteScheduler(
                    router, tpools, tits,
                    device_scheduler_opts={"max_slots": 256},
                )
                for tenant, tpools, tits, _ in tenant_problems
            }
            hits0 = m.SOLVERD_SCHED_CACHE.value({"outcome": "hit"})
            miss0 = m.SOLVERD_SCHED_CACHE.value({"outcome": "miss"})

            def hammer(tenant, tpods):
                for _ in range(fleet_rounds):
                    res = scheds[tenant].solve(copy.deepcopy(tpods))
                    assert res.all_pods_scheduled()

            threads = [
                threading.Thread(
                    target=hammer, args=(tenant, tpods), daemon=True
                )
                for tenant, _tp, _ti, tpods in tenant_problems
            ]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            hits = m.SOLVERD_SCHED_CACHE.value({"outcome": "hit"}) - hits0
            misses = (
                m.SOLVERD_SCHED_CACHE.value({"outcome": "miss"}) - miss0
            )
            return {
                "sidecars": n_sidecars,
                "affinity": affinity,
                "sched_cache_hit_rate": round(
                    hits / max(hits + misses, 1), 3
                ),
                "routed": router.snapshot()["routed"],
            }
        finally:
            for s in srvs:
                s.shutdown()
                s.server_close()

    fleet = {}
    for k in fleet_sizes:
        fleet[f"x{k}"] = run_fleet(k, affinity=True)
    fleet["x%d_no_affinity" % fleet_sizes[-1]] = run_fleet(
        fleet_sizes[-1], affinity=False
    )
    on = fleet[f"x{fleet_sizes[-1]}"]["sched_cache_hit_rate"]
    off = fleet[
        "x%d_no_affinity" % fleet_sizes[-1]
    ]["sched_cache_hit_rate"]
    return {
        "wire": wire,
        "fleet": fleet,
        "tenants": fleet_tenants,
        "rounds_per_tenant": fleet_rounds,
        # affinity's whole point: re-solves keep hitting the member whose
        # caches are warm, so the hit rate must not degrade vs no-affinity
        "affinity_hit_rate": on,
        "no_affinity_hit_rate": off,
        "affinity_cache_ok": bool(on >= off),
    }


def _incremental_bench(
    n_pods=2000,
    n_nodes=600,
    n_types=300,
    churn=0.01,
    rounds=8,
):
    """cfg15_incremental: the churn-proportional incremental re-solve
    engine.

    A 600-node operator snapshot with a standing pod set, re-solved over
    1%-churn rounds: each round one small-pod class shrinks by the churn
    fraction while another grows by the same amount (pods replaced, net
    demand steady — the regime the PackingLedger exists for). The mix is
    operator-shaped: an anchor class of node-sized pods that can only
    land on fresh claims (the stable packing the ledger pins), plus
    small classes that fit the existing nodes' headroom (where real
    churn lands). Two daemons see the identical round sequence: one
    driven with prev_fingerprint chaining (the engine's path — round r
    names round r-1's fingerprint, as the real SolverClient does), one
    always fresh.
    Records the per-round node-count delta vs fresh (node quality must not
    rot as replays compound) and the engine's outcome mix
    (warm/partial/drift_reset). Gates: some rounds replayed, zero
    self-verify rejections, and the client-facing
    solver_result_rejected_total unmoved."""
    from karpenter_core_tpu_torch.api import labels as L
    from karpenter_core_tpu_torch.api.objects import ObjectMeta, Pod
    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (  # noqa: E501
        SimNode,
    )
    from karpenter_core_tpu_torch.metrics import wiring as m
    from karpenter_core_tpu_torch.solver import codec, service

    catalog = bench_catalog(n_types)
    pools = [_pool()]
    its = {"default": list(catalog)}
    nodes = [
        SimNode(
            name=f"node-{i:05d}",
            labels={
                L.LABEL_ARCH: "amd64",
                L.LABEL_OS: "linux",
                L.LABEL_TOPOLOGY_ZONE: f"zone-{'abcd'[i % 4]}",
                L.LABEL_HOSTNAME: f"node-{i:05d}",
                L.NODEPOOL_LABEL_KEY: "default",
            },
            taints=[],
            available={"cpu": 2.0, "memory": 4 * GIB, "pods": 200.0},
            capacity={"cpu": 8.0, "memory": 16 * GIB, "pods": 210.0},
            initialized=True,
        )
        for i in range(n_nodes)
    ]

    # explicit per-class counts so one round's churn is attributable to
    # exactly two equivalence classes (one drains, one fills). Anchors
    # are node-sized (cpu 4.0 > the existing nodes' 2.0 headroom) so
    # they always mint claims; the small classes stay well inside the
    # snapshot's aggregate headroom so churn re-packs onto existing
    # capacity instead of fragmenting the pinned claims
    n_anchor = max(n_pods // 10, 4)
    n_classes = max(min(36, (n_pods - n_anchor) // 8), 2)
    counts = {
        c: (n_pods - n_anchor) // n_classes for c in range(n_classes)
    }

    def make_pods():
        out = [
            Pod(
                metadata=ObjectMeta(name=f"anchor-{i:04d}"),
                resource_requests={"cpu": 4.0, "memory": 2 * GIB},
            )
            for i in range(n_anchor)
        ]
        for c in range(n_classes):
            for i in range(counts[c]):
                out.append(Pod(
                    metadata=ObjectMeta(name=f"c{c:02d}-{i:04d}"),
                    resource_requests={
                        "cpu": 0.1 * (1 + c % 4),
                        # per-class-unique memory: each counts-class IS
                        # one pod equivalence class (group_pods keys on
                        # the request shape), so one round's churn
                        # dirties exactly two classes, not a merged blob
                        "memory": 0.05 * GIB * (1 + c),
                    },
                ))
        return out

    def body_for(pods, prev=""):
        return codec.encode_solve_request(
            pools, its, nodes, [], pods, max_slots=1024,
            prev_fingerprint=prev,
        )

    d_inc = service.SolverDaemon(device=DEVICE, kernel=KERNEL)
    d_fresh = service.SolverDaemon(device=DEVICE, kernel=KERNEL)
    out_base = dict(m.SOLVER_INCREMENTAL.values)
    rej_base = sum(m.SOLVER_RESULT_REJECTED.values.values())

    def claims_of(out):
        return len(codec._json_header(out)["claims"])

    # round 0: the cold start, twice on the incremental daemon — the
    # first request names no predecessor (bypasses the engine), the
    # second names it and records the packing (outcome full/miss). The
    # steady-state regime starts at round 1.
    pods0 = make_pods()
    base_body = body_for(pods0)
    prev = codec.problem_fingerprint(codec._json_header(base_body))
    d_fresh.solve(base_body)
    d_inc.solve(base_body)
    d_inc.solve(body_for(pods0, prev=prev))

    k = max(int(n_pods * churn), 2)
    node_delta_pct = 0.0
    launches = 0
    for r in range(1, rounds + 1):
        # 1% of the fleet's pods replaced: small class A drains k,
        # small class B fills k (distinct classes each round)
        a, b = (2 * r) % n_classes, (2 * r + 1) % n_classes
        if a == b:
            b = (a + 1) % n_classes
        counts[a] = max(counts[a] - k, 0)
        counts[b] += k
        pods = make_pods()
        body = body_for(pods)
        out_f, _ = d_fresh.solve(body)
        inc_body = body_for(pods, prev=prev)
        (out_i, _), grew = _counted(lambda: d_inc.solve(inc_body))
        launches += grew
        prev = codec.problem_fingerprint(codec._json_header(body))

        nf, ni = claims_of(out_f), claims_of(out_i)
        node_delta_pct = max(
            node_delta_pct, abs(ni - nf) / max(nf, 1)
        )

    outcomes = {
        key[0][1]: int(
            m.SOLVER_INCREMENTAL.values[key] - out_base.get(key, 0)
        )
        for key in m.SOLVER_INCREMENTAL.values
        if m.SOLVER_INCREMENTAL.values[key] != out_base.get(key, 0)
    }
    rejections = int(
        sum(m.SOLVER_RESULT_REJECTED.values.values()) - rej_base
    )
    replayed = outcomes.get("warm", 0) + outcomes.get("partial", 0)
    ledger = d_inc.incremental.ledger.stats()
    # launches over every incremental round (a replayed round may launch
    # none)
    readings = _readings(launches)
    out = {
        "pods": n_anchor + sum(counts.values()),
        "nodes": n_nodes,
        "types": n_types,
        "churn": churn,
        "rounds": rounds,
        "node_delta_pct_max": round(100.0 * node_delta_pct, 3),
        "outcomes": outcomes,
        "replayed_rounds": replayed,
        # the self-verify gate is structural: ANY rejected outcome means
        # the replay machinery built a packing the trust anchor refused
        "incremental_rejected": outcomes.get("rejected", 0),
        # ... and the client-facing counter must never move for replays
        "verifier_rejections": rejections,
        "ledger": ledger,
    }
    if readings:
        out["readings"] = readings
    return out


def _elastic_bench(
    n_tenants=6,
    n_types=48,
    n_pods=36,
    surge_ticks=6,
    quiet_ticks=8,
    tick_s=30.0,
    max_members=4,
):
    """cfg16_elastic: the closed-loop elastic solver tier.

    Phase 1 (economics): N tenants with distinct catalogs drive a
    surge-then-quiet load trace against two tiers serving the identical
    workload — one autoscaled (starts at 1 member, TierAutoscaler grows
    it through the real spawn path and retires through the faultless
    drain path), one pinned at max size (the control). Member-seconds
    are charged on a virtual tick clock (live size x tick), so the
    economics are deterministic. Resize cost is audited the way the
    contract states it:
    rendezvous re-keys only the retired/granted member's digests, so a
    resize costs at most one upload round per remapped lineage and
    NOTHING else — zero segment-miss repair rounds, zero greedy
    fallbacks, every surviving breaker closed.

    Phase 2 (ladder): a tier pinned at max size is driven over budget;
    the brownout rungs must fire 1 -> 2 -> 3 strictly in order (relax
    served as FFD, batch window widened, admission halved), then clear
    3 -> 2 -> 1 -> 0 restoring the gateway shape, with the verifier
    rejection counter unmoved throughout.

    Gates: `saving_ok` (autoscaled member-seconds >= 30% below the
    fixed-size control — structural, the sizes ride the deterministic
    policy), `resize_cost_ok` (miss rounds 0, fallbacks 0, breakers
    closed), `brownout_order_ok` (rungs fire and clear in order, shape
    restored, rejections unmoved)."""
    import copy
    import threading

    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.metrics import wiring as m
    from karpenter_core_tpu_torch.solver import fleet as fleetmod
    from karpenter_core_tpu_torch.solver import remote, service
    from karpenter_core_tpu_torch.solver.autoscale import (
        MemberSignal,
        TierAutoscaler,
        TierSignals,
    )

    tenant_problems = []
    for t in range(n_tenants):
        # floor 20: below that bench_catalog lacks the shapes
        # _plain_pods needs (the cfg13 fleet-phase floor)
        tcat = bench_catalog(max(n_types // 2 + 5 * t, 20))
        tenant_problems.append((
            f"tenant{t}",
            [_pool()],
            {"default": list(tcat)},
            _plain_pods(n_pods),
        ))
    vnow = [0.0]

    # per-member capacity (solves per tick) chosen so the surge at full
    # tenant fan-in is under budget ONLY at max size — the autoscaled
    # tier must ramp all the way — while a single quiet tenant sits in
    # the scale-down band even at max size
    member_capacity = n_tenants / (max_members - 0.5)

    class BenchTier:
        """The autoscaler's tier surface over in-thread daemons: the
        pressure signal is offered load per live member (deterministic —
        the resize trace must not ride CPU timing), everything else is
        the production path (real spawn, real drain, real routers)."""

        def __init__(self, start):
            self.daemons, self.servers = [], []
            self.addrs, self.ids = [], []
            self.routers, self.tenants = [], []
            self._next = 0
            self.offered = 0.0
            self.remapped = 0
            for _ in range(start):
                self._spawn()

        def _spawn(self):
            daemon = service.SolverDaemon(gateway=fleetmod.FleetGateway(
                max_depth=8, max_batch=4, batch_window=0.002,
            ), device=DEVICE, kernel=KERNEL)
            srv = service.serve(0, daemon=daemon)
            self.daemons.append(daemon)
            self.servers.append(srv)
            self.addrs.append(f"127.0.0.1:{srv.server_address[1]}")
            self.ids.append(str(self._next))
            self._next += 1
            return len(self.ids) - 1

        def client(self, addr, mid, tenant):
            return remote.SolverClient(
                addr, timeout=600, member=mid, tenant=tenant,
                wire_mode="delta",
            )

        def observe(self):
            members = [MemberSignal(member=mid) for mid in self.ids]
            pressure = self.offered / (len(self.ids) * member_capacity)
            return TierSignals(
                members=members, pressure=pressure, storm=False
            )

        def _winners(self):
            out = {}
            for router in self.routers:
                with router._lock:
                    if router._lineage_key is not None:
                        out[router] = router._lineage_winner_locked()
            return out

        def _count_remaps(self, before):
            for router, winner in before.items():
                with router._lock:
                    if router._lineage_winner_locked() != winner:
                        self.remapped += 1

        def scale_up(self):
            before = self._winners()
            idx = self._spawn()
            for tenant, router in zip(self.tenants, self.routers):
                router.add_member(
                    self.client(self.addrs[idx], self.ids[idx], tenant),
                    member_id=self.ids[idx],
                )
            self._count_remaps(before)

        def scale_down(self, index):
            before = self._winners()
            for router in self.routers:
                router.remove_member(index)
            daemon = self.daemons.pop(index)
            srv = self.servers.pop(index)
            self.addrs.pop(index)
            self.ids.pop(index)
            # the faultless retirement path: flush queued tickets (503,
            # degrade-without-charge on the client), then the socket
            daemon.drain()
            srv.shutdown()
            srv.server_close()
            self._count_remaps(before)

        def set_rung(self, rung):
            for daemon in self.daemons:
                daemon.set_brownout(rung)

        def stop(self):
            for srv in self.servers:
                srv.shutdown()
                srv.server_close()

    def counter_total(counter):
        return sum(counter.values.values())

    def run_tier(autoscale):
        fall0 = counter_total(m.SOLVER_RPC_FALLBACKS)
        miss0 = m.SOLVER_RPC_FAILURES.value({"cause": "segment_miss"})
        tier = BenchTier(1 if autoscale else max_members)
        scheds = {}
        try:
            for tenant, tpools, tits, _tp in tenant_problems:
                members = [
                    tier.client(addr, mid, tenant)
                    for addr, mid in zip(tier.addrs, tier.ids)
                ]
                router = remote.FleetRouter(members, tenant=tenant)
                tier.routers.append(router)
                tier.tenants.append(tenant)
                scheds[tenant] = remote.RemoteScheduler(
                    router, tpools, tits,
                    device_scheduler_opts={"max_slots": 256},
                )
            autoscaler = TierAutoscaler(
                tier, 1, max_members,
                up_stable=1, down_stable=2,
                # 0.45: a lone quiet tenant must sit in the scale-down
                # band at EVERY size down to 2 members (1/(2*capacity)),
                # or the descent stalls halfway
                down_pressure=0.45,
                up_cooldown_s=0.0, down_cooldown_s=0.0,
                time_fn=lambda: vnow[0],
            ) if autoscale else None
            member_seconds = 0.0
            sizes = []
            for tick in range(surge_ticks + quiet_ticks):
                surge = tick < surge_ticks
                active = (
                    tenant_problems if surge
                    else tenant_problems[tick % n_tenants:][:1]
                )
                tier.offered = float(len(active))
                vnow[0] += tick_s
                if autoscaler is not None:
                    autoscaler.step()
                threads = [
                    threading.Thread(
                        target=lambda te=tenant, tp=tpods: scheds[te]
                        .solve(copy.deepcopy(tp)),
                        daemon=True,
                    )
                    for tenant, _tp_, _ti, tpods in active
                ]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
                member_seconds += len(tier.ids) * tick_s
                sizes.append(len(tier.ids))
            open_breakers = sum(
                1 for router in tier.routers for c in router.members
                if c.breaker.state != remote.STATE_CLOSED
            )
            return {
                "sizes": sizes,
                "member_seconds": member_seconds,
                "remapped_lineages": tier.remapped,
                "miss_rounds": int(
                    m.SOLVER_RPC_FAILURES.value(
                        {"cause": "segment_miss"}
                    ) - miss0
                ),
                "fallbacks": int(
                    counter_total(m.SOLVER_RPC_FALLBACKS) - fall0
                ),
                "open_breakers": open_breakers,
                "decisions": (
                    [list(d) for d in autoscaler.decisions]
                    if autoscaler else None
                ),
            }
        finally:
            tier.stop()

    auto, launches = _counted(lambda: run_tier(autoscale=True))
    fixed = run_tier(autoscale=False)

    # -- phase 2: the brownout ladder at forced max-scale overload ---------

    def brownout_ladder():
        tier = BenchTier(1)
        tenant, tpools, tits, tpods = tenant_problems[0]
        try:
            tier.routers.append(remote.FleetRouter(
                [tier.client(tier.addrs[0], tier.ids[0], tenant)],
                tenant=tenant,
            ))
            tier.tenants.append(tenant)
            sched_relax = remote.RemoteScheduler(
                tier.routers[0], tpools, tits,
                device_scheduler_opts={
                    "max_slots": 256, "solver_mode": "relax",
                },
            )
            autoscaler = TierAutoscaler(
                tier, 1, 1,
                up_stable=1, down_stable=10 ** 6,
                rung_up_stable=1, rung_down_stable=1,
                time_fn=lambda: vnow[0],
            )
            daemon = tier.daemons[0]
            base_window = daemon.gateway.batch_window
            base_depth = daemon.gateway.max_depth
            rej0 = counter_total(m.SOLVER_RESULT_REJECTED)
            served0 = counter_total(m.SOLVERD_BROWNOUT_SERVED)
            rungs = []
            tier.offered = 100.0  # over budget, nowhere left to scale
            for _ in range(3):
                vnow[0] += tick_s
                autoscaler.step()
                rungs.append(daemon.brownout_rung)
            at_max = {
                "window_s": daemon.gateway.batch_window,
                "depth": daemon.gateway.max_depth,
            }
            # rung >= 1: a relax request is served in FFD mode (anytime
            # answer, verification still on)
            res = sched_relax.solve(copy.deepcopy(tpods))
            served = int(
                counter_total(m.SOLVERD_BROWNOUT_SERVED) - served0
            )
            tier.offered = 0.0
            for _ in range(3):
                vnow[0] += tick_s
                autoscaler.step()
                rungs.append(daemon.brownout_rung)
            order = [
                int(arg) for _ts, action, arg in autoscaler.decisions
                if action in ("rung_up", "rung_down")
            ]
            restored = (
                daemon.gateway.batch_window == base_window
                and daemon.gateway.max_depth == base_depth
            )
            rejections = int(
                counter_total(m.SOLVER_RESULT_REJECTED) - rej0
            )
            return {
                "rungs": rungs,
                "rung_order": order,
                "relax_served_as_ffd": served,
                "relax_scheduled": bool(res.all_pods_scheduled()),
                "window_at_max_s": round(at_max["window_s"], 4),
                "depth_at_max": at_max["depth"],
                "base_window_s": round(base_window, 4),
                "base_depth": base_depth,
                "restored": bool(restored),
                "verifier_rejections": rejections,
                "brownout_order_ok": bool(
                    order == [1, 2, 3, 2, 1, 0]
                    and served > 0
                    and res.all_pods_scheduled()
                    and at_max["window_s"] > base_window
                    and at_max["depth"] < base_depth
                    and restored
                    and rejections == 0
                ),
            }
        finally:
            tier.stop()

    ladder = brownout_ladder()

    saving = 1.0 - auto["member_seconds"] / max(
        fixed["member_seconds"], 1e-9
    )
    resize_cost_ok = bool(
        auto["miss_rounds"] == 0
        and auto["fallbacks"] == 0
        and auto["open_breakers"] == 0
        and fixed["fallbacks"] == 0
    )
    readings = _readings(launches)
    out = {
        "tenants": n_tenants,
        "pods_per_tenant": n_pods,
        "surge_ticks": surge_ticks,
        "quiet_ticks": quiet_ticks,
        "tick_s": tick_s,
        "max_members": max_members,
        "autoscaled": auto,
        "fixed": fixed,
        "member_seconds_saving_pct": round(100.0 * saving, 1),
        # structural: the size trace rides the deterministic policy
        "saving_ok": bool(saving >= 0.30),
        "resize_cost_ok": resize_cost_ok,
        "brownout": ladder,
    }
    if readings:
        out["readings"] = readings
    return out


def _restart_probe() -> None:
    """Child mode: a FRESH process finds the kernel library the parent
    built, boots a DeviceScheduler, pre-warms the shape buckets
    (``DeviceScheduler.prewarm``) and makes its first real solve at the
    primary shape — the restart path. Prints one JSON line for the
    parent."""
    if DEVICE == "cuda":
        from karpenter_core_tpu_torch.ops import cuda_ffd

        cuda_ffd.build()
    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler

    pods = _plain_pods(N_PODS)
    catalog = bench_catalog(N_TYPES)
    sched = DeviceScheduler(
        [_pool()], {"default": list(catalog)}, max_slots=1024,
        kernel_backend=KERNEL, device=DEVICE,
    )
    sched.prewarm()
    res, launches = _counted(lambda: sched.solve(pods))
    assert res.all_pods_scheduled()
    out = {"nodes": res.node_count()}
    if DEVICE == "cuda":
        out["kernel_launches"] = launches
    print(json.dumps(out))


def _run_restart_probe() -> dict:
    import subprocess

    try:
        proc = subprocess.run(
            [sys.executable, __file__, "--restart-probe", "--device", DEVICE],
            capture_output=True, text=True, timeout=600,
            env={**os.environ, "BENCH_PODS": str(N_PODS),
                 "BENCH_TYPES": str(N_TYPES)},
        )
    except subprocess.TimeoutExpired:
        # degrade like other child failures — the already-measured configs
        # must still reach the JSON line
        return {"error": "restart probe exceeded 600s"}
    for line in reversed(proc.stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except (ValueError, TypeError):
            continue
    return {"error": proc.stderr.strip()[-300:] or "no output"}


def _twin_scenarios(scale: str = "full"):
    """cfg14_twin's scenarios by name: ``clean`` and ``fault_storm``
    (greedy solver) and, at the full scale, ``fleet`` (the solve tier
    under fleet faults)."""
    from karpenter_core_tpu_torch.twin import (
        FleetFault,
        Scenario,
        Storm,
        WorkloadWave,
    )

    if scale == "fast":
        counts = dict(serving=40, training=32, batch=60)
        duration, tick = 300.0, 30.0
    else:
        counts = dict(serving=1200, training=800, batch=2400)
        duration, tick = 7200.0, 300.0

    def waves():
        return (
            WorkloadWave(at=0.0, cluster=0, kind="serving",
                         count=counts["serving"], min_available=4),
            WorkloadWave(at=0.0, cluster=1, kind="training",
                         count=counts["training"], gang_size=8,
                         priority=100),
            WorkloadWave(at=tick, cluster=0, kind="batch",
                         count=counts["batch"], lifetime=duration / 2),
            WorkloadWave(at=tick * 2, cluster=1, kind="serving",
                         count=counts["serving"] // 2, min_available=2),
        )

    storm = Storm(start=tick, duration=tick * 3, cluster=0, head=6)
    rates = {
        "kube.create.conflict": 0.05,
        "kube.update.conflict": 0.04,
        "kube.bind.conflict": 0.04,
        "cloud.create.insufficient_capacity": 0.03,
    }
    scenarios = {
        "clean": Scenario(
            seed=3, clusters=2, duration=duration, tick=tick,
            solver="greedy", waves=waves(),
        ),
        "fault_storm": Scenario(
            seed=5, clusters=2, duration=duration, tick=tick,
            solver="greedy", waves=waves(), rates=rates, storms=(storm,),
        ),
    }
    if scale != "fast":
        # the fleet scenario runs the REAL solve tier (in-thread solverd
        # members behind each operator's router) under fleet faults
        scenarios["fleet"] = Scenario(
            seed=7, clusters=2, duration=1800.0, tick=60.0,
            solver="tpu", fleet=2, wire="delta",
            waves=(
                WorkloadWave(at=0.0, cluster=0, kind="serving", count=16,
                             min_available=2),
                WorkloadWave(at=60.0, cluster=1, kind="batch", count=16),
                WorkloadWave(at=600.0, cluster=0, kind="batch", count=12),
            ),
            fleet_faults=(
                FleetFault(at=300.0, kind="amnesia", member=0),
                FleetFault(at=600.0, kind="murder", member=1),
                FleetFault(at=900.0, kind="partition", cluster=0,
                           duration=120.0),
            ),
        )
    return scenarios


def _twin_outcome(result):
    """A twin run's ledger numbers and verdict counters, as cfg14 reports
    them (either package's result)."""
    ledger = result.ledger.encode()
    return {
        "pods_bound": sum(c["n"] for c in ledger["slo"].values()),
        "cost_dollar_hours": round(
            sum(ledger["cost_dollar_hours"].values()), 6
        ),
        "peak_nodes": ledger["peak_nodes"],
        "slo": ledger["slo"],
        "slo_misses": ledger["slo_misses"],
        "preemption_evictions": ledger["preemption_evictions"],
        "utilization": ledger["utilization"],
        "invariant_violations": len(result.violations),
        "rpc_fallbacks": result.counters["rpc_fallbacks"],
        "verifier_rejections": result.counters["result_rejected"],
    }


def _twin_bench(scale: str = "full"):
    """cfg14_twin: closed-loop macro outcomes over virtual time. The twin
    IS the judge here — per scenario it reports the ledger
    ($-cost integral, SLO percentiles per workload class, preemption
    burn, tier utilization), and the gates are outcome gates: no invariant
    violations anywhere, no greedy fallbacks on the clean run."""
    from karpenter_core_tpu_torch.twin.harness import run_scenario

    scenarios = _twin_scenarios(scale)
    out = {}
    n0 = _launches()
    for name in scenarios:
        result = run_scenario(scenarios[name], device=DEVICE, kernel=KERNEL)
        out[name] = {
            "virtual_s": result.ledger.encode()["virtual_seconds"],
            **_twin_outcome(result),
            # failed RPCs, which the ledger does not carry
            "rpc_failures": result.counters["rpc_failures"],
        }
    # launches over every scenario (only the tpu-solver fleet scenario
    # runs the kernel)
    readings = _readings(_launches() - n0)
    return {
        **out,
        "twin_ok": all(
            phase["invariant_violations"] == 0
            and phase["verifier_rejections"] == 0
            for phase in out.values()
        ) and out["clean"]["rpc_fallbacks"] == 0,
        **({"readings": readings} if readings else {}),
    }


def _pick(d, *keys):
    return {k: d[k] for k in keys if k in d}


def _relax_answers(o):
    return {
        shape: {
            mode: {
                **_pick(o[shape][mode], "nodes", "cost", "unschedulable"),
                "outcome": (o[shape][mode]["phases"].get("relax") or {})
                .get("outcome"),
            }
            for mode in ("ffd", "relax")
        }
        for shape in ("cfg3_shape", "cfg11_shape")
    }


_TWIN_LEDGER = ("pods_bound", "cost_dollar_hours", "peak_nodes", "slo",
                "slo_misses", "preemption_evictions", "invariant_violations",
                "verifier_rejections")

# What each config is held to: its answers (node counts and, where the
# config has them, evictions, gangs, $-cost, relax outcome, frontier,
# wire parity, the twin's ledger and violations), never a timing.
ANSWERS = {
    "primary": lambda o: _pick(o, "nodes", "greedy_nodes"),
    "cfg1_5k400": lambda o: _pick(o, "nodes", "greedy_nodes"),
    "cfg2_masked": lambda o: _pick(o, "nodes", "greedy_nodes"),
    "cfg3_topology": lambda o: _pick(o, "nodes", "greedy_nodes"),
    "cfg3_topology_50k": lambda o: _pick(o, "nodes", "greedy_nodes"),
    "shape_churn": lambda o: _pick(o, "nodes_by_round"),
    "cfg4_consol": lambda o: _pick(o, "schedulable_prefixes"),
    "cfg5_sidecar": lambda o: _pick(o, "nodes"),
    "cfg6_ice_storm": lambda o: {
        k: _pick(v, "nodes", "all_scheduled", "unavailable_offerings")
        for k, v in o.items()
    },
    "cfg7_fleet": lambda o: {
        t: v["nodes"] for t, v in o["per_tenant"].items()
    },
    "cfg8_multidev": lambda o: {
        k: _pick(v, "nodes_single", "nodes_sharded", "wire_parity")
        for k, v in (o.get("parity") or {}).items()
    },
    "cfg10_batch": lambda o: _pick(o, "nodes"),
    "cfg11_gangs": lambda o: _pick(
        o, "nodes", "preemption_count", "eviction_minimality", "gangs",
        "gangs_placed", "gang_atomicity_violations", "unschedulable"),
    "cfg12_relax": _relax_answers,
    # the wire's byte counts carry pod uids minted by a process-wide
    # counter, so they vary with what ran before: not an answer
    "cfg13_delta": lambda o: _pick(o["wire"], "parity_ok",
                                   "result_nodes_delta"),
    "cfg14_twin": lambda o: {
        s: _pick(v, *_TWIN_LEDGER)
        for s, v in o.items() if s in ("clean", "fault_storm", "fleet")
    },
    "cfg15_incremental": lambda o: _pick(
        o, "node_delta_pct_max", "outcomes", "replayed_rounds",
        "incremental_rejected", "verifier_rejections"),
    "cfg16_elastic": lambda o: {
        "autoscaled": _pick(o["autoscaled"], "sizes", "member_seconds",
                            "decisions", "miss_rounds", "open_breakers"),
        "fixed": _pick(o["fixed"], "sizes", "member_seconds", "miss_rounds",
                       "open_breakers"),
        "brownout": _pick(o["brownout"], "rungs", "rung_order",
                          "relax_served_as_ffd", "relax_scheduled",
                          "restored", "verifier_rejections"),
        "member_seconds_saving_pct": o["member_seconds_saving_pct"],
    },
    "cfg17_pallas": lambda o: {
        s: {"nodes": o[s]["cuda"]["nodes"],
            "reference_nodes": o[s]["reference"]["nodes"]}
        for s in ("primary", "topology")
    },
    "cfg18_topoaware": lambda o: {
        m: _pick(o[m], "max_intra_gang_hops", "provable_hop_bound",
                 "gangs_placed", "node_count", "new_claims",
                 "cost_dollars_per_hour", "unschedulable")
        for m in ("aware", "blind")
    },
    "restart": lambda o: _pick(o, "nodes"),
}

# The structural gates a config's run must pass besides its answers
# (never a timing verdict).
GATES = {
    "cfg6_ice_storm": lambda o: all(v["all_scheduled"] for v in o.values()),
    "cfg7_fleet": lambda o: o["shed_parity_ok"],
    "cfg8_multidev": lambda o: (
        o.get("parity_ok", False) if o.get("throughput_skipped")
        else o["parity_nodes_delta_multi_vs_single"] == 0),
    "cfg11_gangs": lambda o: o["gang_atomicity_ok"],
    "cfg12_relax": lambda o: all(
        o[s]["node_improved"] and o[s]["cost_improved"]
        for s in ("cfg3_shape", "cfg11_shape")),
    "cfg13_delta": lambda o: o["wire"]["parity_ok"],
    "cfg14_twin": lambda o: o["twin_ok"],
    "cfg15_incremental": lambda o: (
        o["replayed_rounds"] > 0 and o["incremental_rejected"] == 0
        and o["verifier_rejections"] == 0),
    "cfg16_elastic": lambda o: (
        o["saving_ok"] and o["resize_cost_ok"]
        and o["brownout"]["brownout_order_ok"]),
    "cfg17_pallas": lambda o: o["parity_ok"],
    "cfg18_topoaware": lambda o: (
        o["gangs_placed_ok"] and o["topo_hops_ok"] and o["hard_bound_ok"]),
    "restart": lambda o: "error" not in o,
}

# Configs whose sizes follow BENCH_PODS / BENCH_TYPES outside BENCH_FAST
# (under BENCH_FAST only the primary does): their pinned answers hold at
# the default 50,000 pods x 800 types only.
KNOB_SIZED = ("primary", "cfg2_masked", "cfg3_topology_50k", "cfg11_gangs",
              "cfg12_relax", "cfg13_delta", "cfg15_incremental",
              "cfg17_pallas", "restart")

# The JAX package's answers at bench.py's default sizes, from
# ``JAX_PLATFORMS=cpu python bench.py --configs <cfg>`` on the CPU
# (answers, not timings: the CPU serves), except where a config's entry
# names ``fleet_expected.py bench`` (answers bench.py does not print,
# computed by its functions' recipes through the JAX package).
EXPECTED = {
    "primary": {"nodes": 444, "greedy_nodes": 444},
    "cfg1_5k400": {"nodes": 171, "greedy_nodes": 171},
    "cfg2_masked": {"nodes": 236, "greedy_nodes": 236},
    "cfg3_topology": {"nodes": 91, "greedy_nodes": 121},
    "cfg3_topology_50k": {"nodes": 235, "greedy_nodes": 315},
    # fleet_expected.py bench
    "shape_churn": {"nodes_by_round": [157, 168, 179, 158, 169, 180]},
    "cfg4_consol": {"schedulable_prefixes": 100},
    "cfg5_sidecar": {"nodes": 171},
    "cfg6_ice_storm": {
        "storm_0pct": {
            "nodes": 171,
            "all_scheduled": True,
            "unavailable_offerings": 0,
        },
        "storm_25pct": {
            "nodes": 171,
            "all_scheduled": True,
            "unavailable_offerings": 800,
        },
        "storm_50pct": {
            "nodes": 171,
            "all_scheduled": True,
            "unavailable_offerings": 1600,
        },
    },
    "cfg7_fleet": {
        "tenant0": 36,
        "tenant1": 39,
        "tenant2": 43,
        "tenant3": 36,
        "tenant4": 39,
        "tenant5": 43,
        "tenant6": 36,
        "tenant7": 39,
    },
    "cfg8_multidev": {
        "even_8dev": {
            "nodes_single": 127,
            "nodes_sharded": 127,
            "wire_parity": True,
        },
        "padded_slots_8dev": {
            "nodes_single": 127,
            "nodes_sharded": 127,
            "wire_parity": True,
        },
        "uneven_3dev": {
            "nodes_single": 127,
            "nodes_sharded": 127,
            "wire_parity": True,
        },
    },
    # fleet_expected.py bench
    "cfg10_batch": {"nodes": [11]},
    # nodes: fleet_expected.py bench; the rest: bench.py
    "cfg11_gangs": {
        "nodes": 4038,
        "preemption_count": 320,
        "eviction_minimality": 1.0,
        "gangs": 375,
        "gangs_placed": 375,
        "gang_atomicity_violations": 0,
        "unschedulable": 1840,
    },
    "cfg12_relax": {
        "cfg3_shape": {
            "ffd": {
                "nodes": 588,
                "cost": 48.231,
                "unschedulable": 0,
                "outcome": None,
            },
            "relax": {
                "nodes": 301,
                "cost": 40.111,
                "unschedulable": 0,
                "outcome": "cached_won",
            },
        },
        "cfg11_shape": {
            "ffd": {
                "nodes": 565,
                "cost": 46.345,
                "unschedulable": 0,
                "outcome": None,
            },
            "relax": {
                "nodes": 140,
                "cost": 34.451,
                "unschedulable": 0,
                "outcome": "cached_won",
            },
        },
    },
    "cfg13_delta": {"parity_ok": True, "result_nodes_delta": 0},
    # the fleet scenario (tier faults) is held to its violations only
    "cfg14_twin": {
        "clean": {
            "pods_bound": 5000,
            "cost_dollar_hours": 84.520271,
            "peak_nodes": {"0": 129, "1": 23},
            "slo": {
                "batch": {
                    "n": 2400,
                    "p50_s": 1.0,
                    "p95_s": 1.0,
                    "max_s": 1.0,
                },
                "serving": {
                    "n": 1800,
                    "p50_s": 1.0,
                    "p95_s": 1.0,
                    "max_s": 1.0,
                },
                "training": {
                    "n": 800,
                    "p50_s": 1.0,
                    "p95_s": 1.0,
                    "max_s": 1.0,
                },
            },
            "slo_misses": 0,
            "preemption_evictions": 0,
            "invariant_violations": 0,
            "verifier_rejections": 0,
        },
        "fault_storm": {
            "pods_bound": 5000,
            "cost_dollar_hours": 86.297499,
            "peak_nodes": {"0": 130, "1": 24},
            "slo": {
                "batch": {
                    "n": 2400,
                    "p50_s": 174.0,
                    "p95_s": 355.0,
                    "max_s": 355.0,
                },
                "serving": {
                    "n": 1800,
                    "p50_s": 174.0,
                    "p95_s": 174.0,
                    "max_s": 174.0,
                },
                "training": {
                    "n": 800,
                    "p50_s": 174.0,
                    "p95_s": 174.0,
                    "max_s": 174.0,
                },
            },
            "slo_misses": 0,
            "preemption_evictions": 0,
            "invariant_violations": 0,
            "verifier_rejections": 0,
        },
        "fleet": {
            "pods_bound": 44,
            "cost_dollar_hours": 0.217261,
            "peak_nodes": {"0": 2, "1": 1},
            "slo": {
                "batch": {
                    "n": 28,
                    "p50_s": 1.0,
                    "p95_s": 1.3,
                    "max_s": 1.3,
                },
                "serving": {
                    "n": 16,
                    "p50_s": 1.0,
                    "p95_s": 1.0,
                    "max_s": 1.0,
                },
            },
            "slo_misses": 0,
            "preemption_evictions": 0,
            "invariant_violations": 0,
            "verifier_rejections": 0,
        },
    },
    "cfg15_incremental": {
        "node_delta_pct_max": 0.0,
        "outcomes": {"full": 1, "partial": 8},
        "replayed_rounds": 8,
        "incremental_rejected": 0,
        "verifier_rejections": 0,
    },
    "cfg16_elastic": {
        "autoscaled": {
            "sizes": [2, 3, 4, 4, 4, 4, 4, 3, 3, 2, 2, 1, 1, 1],
            "member_seconds": 1140.0,
            "decisions": [
                [30.0, "up", "pressure=3.500 n=1->2"],
                [60.0, "up", "pressure=1.750 n=2->3"],
                [90.0, "up", "pressure=1.167 n=3->4"],
                [240.0, "down", "0"],
                [300.0, "down", "0"],
                [360.0, "down", "0"],
            ],
            "miss_rounds": 0,
            "open_breakers": 0,
        },
        "fixed": {
            "sizes": [4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4],
            "member_seconds": 1680.0,
            "miss_rounds": 0,
            "open_breakers": 0,
        },
        "brownout": {
            "rungs": [1, 2, 3, 2, 1, 0],
            "rung_order": [1, 2, 3, 2, 1, 0],
            "relax_served_as_ffd": 1,
            "relax_scheduled": True,
            "restored": True,
            "verifier_rejections": 0,
        },
        "member_seconds_saving_pct": 32.1,
    },
    "cfg17_pallas": {
        "primary": {"nodes": 444, "reference_nodes": 444},
        "topology": {"nodes": 91, "reference_nodes": 91},
    },
    "cfg18_topoaware": {
        "aware": {
            "max_intra_gang_hops": 2,
            "provable_hop_bound": 2,
            "gangs_placed": 40,
            "node_count": 1019,
            "new_claims": 851,
            "cost_dollars_per_hour": 33.309,
            "unschedulable": 0,
        },
        "blind": {
            "max_intra_gang_hops": 3,
            "provable_hop_bound": 3,
            "gangs_placed": 40,
            "node_count": 1019,
            "new_claims": 851,
            "cost_dollars_per_hour": 33.309,
            "unschedulable": 0,
        },
    },
    # the primary's problem: bench.py's primary answer
    "restart": {"nodes": 444},
}
# ... and under BENCH_FAST=1 (bench.py's fast sizes, the primary at the
# default 50,000 x 800): ``JAX_PLATFORMS=cpu BENCH_FAST=1 python bench.py``.
EXPECTED_FAST = {
    "primary": {"nodes": 444},
    # fleet_expected.py bench
    "cfg10_batch": {"nodes": [10]},
    # nodes: fleet_expected.py bench; the rest: bench.py
    "cfg11_gangs": {
        "nodes": 40,
        "preemption_count": 16,
        "eviction_minimality": 1.0,
        "gangs": 3,
        "gangs_placed": 3,
        "gang_atomicity_violations": 0,
        "unschedulable": 12,
    },
    "cfg12_relax": {
        "cfg3_shape": {
            "ffd": {
                "nodes": 47,
                "cost": 3.855,
                "unschedulable": 0,
                "outcome": None,
            },
            "relax": {
                "nodes": 37,
                "cost": 3.691,
                "unschedulable": 0,
                "outcome": "cached_won",
            },
        },
        "cfg11_shape": {
            "ffd": {
                "nodes": 44,
                "cost": 3.609,
                "unschedulable": 0,
                "outcome": None,
            },
            "relax": {
                "nodes": 11,
                "cost": 2.707,
                "unschedulable": 0,
                "outcome": "cached_won",
            },
        },
    },
    "cfg13_delta": {"parity_ok": True, "result_nodes_delta": 0},
    "cfg14_twin": {
        "clean": {
            "pods_bound": 152,
            "cost_dollar_hours": 0.11903,
            "peak_nodes": {"0": 4, "1": 1},
            "slo": {
                "batch": {"n": 60, "p50_s": 1.0, "p95_s": 1.0, "max_s": 1.0},
                "serving": {
                    "n": 60,
                    "p50_s": 1.0,
                    "p95_s": 1.0,
                    "max_s": 1.0,
                },
                "training": {
                    "n": 32,
                    "p50_s": 1.0,
                    "p95_s": 1.0,
                    "max_s": 1.0,
                },
            },
            "slo_misses": 0,
            "preemption_evictions": 0,
            "invariant_violations": 0,
            "verifier_rejections": 0,
        },
        "fault_storm": {
            "pods_bound": 152,
            "cost_dollar_hours": 0.126868,
            "peak_nodes": {"0": 4, "1": 1},
            "slo": {
                "batch": {
                    "n": 60,
                    "p50_s": 17.0,
                    "p95_s": 17.0,
                    "max_s": 17.0,
                },
                "serving": {
                    "n": 60,
                    "p50_s": 17.0,
                    "p95_s": 17.0,
                    "max_s": 17.0,
                },
                "training": {
                    "n": 32,
                    "p50_s": 17.0,
                    "p95_s": 17.0,
                    "max_s": 17.0,
                },
            },
            "slo_misses": 0,
            "preemption_evictions": 0,
            "invariant_violations": 0,
            "verifier_rejections": 0,
        },
    },
    "cfg15_incremental": {
        "node_delta_pct_max": 0.0,
        "outcomes": {"full": 1, "partial": 3},
        "replayed_rounds": 3,
        "incremental_rejected": 0,
        "verifier_rejections": 0,
    },
    "cfg16_elastic": {
        "autoscaled": {
            "sizes": [2, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1],
            "member_seconds": 690.0,
            "decisions": [
                [30.0, "up", "pressure=2.500 n=1->2"],
                [60.0, "up", "pressure=1.250 n=2->3"],
                [180.0, "down", "0"],
                [240.0, "down", "0"],
            ],
            "miss_rounds": 0,
            "open_breakers": 0,
        },
        "fixed": {
            "sizes": [3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3],
            "member_seconds": 1080.0,
            "miss_rounds": 0,
            "open_breakers": 0,
        },
        "brownout": {
            "rungs": [1, 2, 3, 2, 1, 0],
            "rung_order": [1, 2, 3, 2, 1, 0],
            "relax_served_as_ffd": 1,
            "relax_scheduled": True,
            "restored": True,
            "verifier_rejections": 0,
        },
        "member_seconds_saving_pct": 36.1,
    },
    "cfg17_pallas": {
        "primary": {"nodes": 53, "reference_nodes": 53},
        "topology": {"nodes": 14, "reference_nodes": 14},
    },
    "cfg18_topoaware": {
        "aware": {
            "max_intra_gang_hops": 2,
            "provable_hop_bound": 2,
            "gangs_placed": 3,
            "node_count": 19,
            "new_claims": 0,
            "cost_dollars_per_hour": 0.0,
            "unschedulable": 0,
        },
        "blind": {
            "max_intra_gang_hops": 3,
            "provable_hop_bound": 3,
            "gangs_placed": 3,
            "node_count": 19,
            "new_claims": 0,
            "cost_dollars_per_hour": 0.0,
            "unschedulable": 0,
        },
    },
}


def _pinned(name):
    """The JAX package's answer for ``name`` at this run's sizes, or None
    where none is pinned."""
    default_knobs = (N_PODS, N_TYPES) == (50000, 800)
    if FAST:
        sized = name == "primary"
        table = EXPECTED_FAST
    else:
        sized = name in KNOB_SIZED
        table = EXPECTED
    if sized and not default_knobs:
        return None
    return table.get(name)


def _rejections() -> float:
    from karpenter_core_tpu_torch.metrics import wiring as m

    return sum(m.SOLVER_RESULT_REJECTED.values.values())


def _judged(name, fn):
    """Run one config and add its ``answers``, ``expected`` and
    ``correct`` (answers equal the pinned JAX answer where one is pinned,
    its gates hold and the verifier's rejection counter did not move)."""
    rej0 = _rejections()
    out = fn()
    answers = json.loads(json.dumps(ANSWERS[name](out)))
    gates = GATES.get(name, lambda o: True)(out)
    expected = _pinned(name)
    rejected = _rejections() - rej0
    out["answers"] = answers
    out["expected"] = expected
    out["correct"] = bool(
        (expected is None or answers == expected) and gates and rejected == 0
    )
    return out


def _device_block() -> dict:
    """The run's device: on the card its name and power limit as
    ``nvidia-smi`` prints them; a CPU run names no device metric."""
    import platform

    import torch

    if DEVICE == "cpu":
        return {"platform": "cpu", "name": platform.processor() or
                platform.machine(), "power_limit_w": None, "count": 1}
    import subprocess

    from karpenter_core_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")  # raises without a GPU: nothing falls back
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in smi.rsplit(",", 1))
    return {
        "platform": "gpu",
        "name": name,
        "power_limit_w": float(limit.split()[0]),
        "count": torch.cuda.device_count(),
    }


def main() -> int:
    """Run the selected configs, print the JSON line; the exit code."""
    import torch

    if DEVICE not in ("cuda", "cpu"):
        raise SystemExit(f"--device must be cuda or cpu, not {DEVICE!r}")

    from karpenter_core_tpu_torch.api.objects import Taint
    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog

    from chip_smoke import source_digest

    device = _device_block()
    if DEVICE == "cuda":
        from karpenter_core_tpu_torch.ops import cuda_ffd

        # the kernel library, built once from the checkout's sources (a
        # fresh checkout compiles it; a later process loads it)
        cuda_ffd.build()

    # --configs cfgA,cfgB: run only the named secondary configs (prefix
    # match, e.g. "cfg12" selects cfg12_relax). The primary always runs.
    only = None
    if "--configs" in sys.argv:
        i = sys.argv.index("--configs")
        if i + 1 >= len(sys.argv):
            raise SystemExit("--configs needs a comma-separated value")
        only = [c.strip() for c in sys.argv[i + 1].split(",") if c.strip()]
        known = (
            "cfg1_5k400", "cfg2_masked", "cfg3_topology", "cfg4_consol",
            "cfg5_sidecar", "cfg6_ice_storm", "cfg7_fleet", "cfg8_multidev",
            "cfg10_batch", "cfg11_gangs", "cfg12_relax",
            "cfg13_delta", "cfg14_twin", "cfg15_incremental",
            "cfg16_elastic", "cfg17_pallas", "cfg18_topoaware",
            "shape_churn", "restart",
        )
        bogus = [
            o for o in only
            if not any(k == o or k.startswith(o) for k in known)
        ]
        if bogus:
            # a typo'd name silently filtering everything out would look
            # like an intentional primary-only round
            raise SystemExit(f"--configs: unknown config name(s) {bogus}")

    def sel(name: str) -> bool:
        return only is None or any(
            name == o or name.startswith(o) for o in only
        )

    catalog = bench_catalog(N_TYPES)
    detail = {}

    def run(name, fn):
        detail[name] = _judged(name, fn)

    run("primary", lambda: _solve_bench(
        _plain_pods(N_PODS), [_pool()], catalog, parity=not FAST,
    ))

    if not FAST and sel("cfg1_5k400"):
        run("cfg1_5k400", lambda: _solve_bench(
            _plain_pods(5000), [_pool()], bench_catalog(400)
        ))
    if not FAST:
        from karpenter_core_tpu_torch.api import labels as L
        from karpenter_core_tpu_torch.api.objects import NodeSelectorRequirement

        masked_pools = [
            _pool("default"),
            _pool(
                "batch",
                taints=[Taint(key="batch", value="", effect="NoSchedule")],
                # pool-requirement mask path: the batch pool only offers
                # amd64/linux instance types
                requirements=[
                    NodeSelectorRequirement(L.LABEL_ARCH, "In", ("amd64",)),
                    NodeSelectorRequirement(L.LABEL_OS, "In", ("linux",)),
                ],
            ),
        ]
        masked_pools[1].spec.template.labels["pool"] = "batch"
        if sel("cfg2_masked"):
            run("cfg2_masked", lambda: _solve_bench(
                _masked_pods(N_PODS), masked_pools, catalog
            ))
        if sel("cfg3_topology"):
            run("cfg3_topology", lambda: _solve_bench(
                _topology_pods(5000),
                [_pool()],
                bench_catalog(400),
                max_slots=2048,
            ))
            # the full diverse mix at the north-star pod count, parity vs
            # the greedy oracle
            run("cfg3_topology_50k", lambda: _solve_bench(
                _topology_pods(50000, n_deploys=40),
                [_pool()],
                bench_catalog(N_TYPES),
                max_slots=4096,
            ))
        if sel("shape_churn"):
            run("shape_churn", _shape_churn_bench)
        if sel("cfg4_consol"):
            run("cfg4_consol", _consolidation_bench)
        if sel("cfg5_sidecar"):
            run("cfg5_sidecar", _sidecar_bench)
        if sel("cfg6_ice_storm"):
            run("cfg6_ice_storm", _ice_storm_bench)
        if sel("cfg7_fleet"):
            run("cfg7_fleet", _fleet_bench)
        if sel("cfg8_multidev"):
            run("cfg8_multidev", _multidev_bench)
        if sel("cfg10_batch"):
            run("cfg10_batch", _batch_bench)
        if sel("cfg11_gangs"):
            run("cfg11_gangs", lambda: _gangs_bench(
                # scale to the round's pod knob on small runs; a default
                # (50k-pod) round keeps the classic 20k shape
                n_pods=min(20000, max(N_PODS, 1000)),
            ))
        if sel("cfg12_relax"):
            run("cfg12_relax", lambda: _relax_bench(
                n_pods=min(5000, max(N_PODS, 500))
            ))
        if sel("cfg13_delta"):
            run("cfg13_delta", lambda: _delta_bench(
                n_pods=min(2000, max(N_PODS, 400)),
                n_nodes=min(600, max(N_PODS // 3, 100)),
            ))
        if sel("cfg14_twin"):
            run("cfg14_twin", _twin_bench)
        if sel("cfg15_incremental"):
            run("cfg15_incremental", lambda: _incremental_bench(
                n_pods=min(2000, max(N_PODS, 400)),
                n_nodes=min(600, max(N_PODS // 3, 100)),
            ))
        if sel("cfg16_elastic"):
            run("cfg16_elastic", _elastic_bench)
        if sel("cfg17_pallas"):
            run("cfg17_pallas", _pallas_bench)
        if sel("cfg18_topoaware"):
            run("cfg18_topoaware", _topoaware_bench)
        if sel("restart"):
            run("restart", _run_restart_probe)
    else:
        # the fast smoke: bench.py's tiny versions of cfg10-cfg18, each
        # proving its path end to end
        run("cfg10_batch", lambda: _batch_bench(
            n_tenants=4, n_pods=24, n_types=12
        ))
        run("cfg11_gangs", lambda: _gangs_bench(n_pods=200, n_existing=4))
        # 400 pods is the smallest size where the relax win is structural
        # on BOTH shapes
        run("cfg12_relax", lambda: _relax_bench(n_pods=400))
        run("cfg13_delta", lambda: _delta_bench(
            n_pods=96, n_nodes=48, n_types=16, rounds=2,
            fleet_tenants=3, fleet_rounds=2, fleet_sizes=(1, 2),
        ))
        run("cfg14_twin", lambda: _twin_bench(scale="fast"))
        run("cfg15_incremental", lambda: _incremental_bench(
            n_pods=160, n_nodes=24, n_types=16, churn=0.05, rounds=3,
        ))
        run("cfg16_elastic", lambda: _elastic_bench(
            n_tenants=3, n_types=12, n_pods=12,
            surge_ticks=4, quiet_ticks=8, max_members=3,
        ))
        # (24 types is the floor: bench_catalog(16) tops out at 1 cpu and
        # can't host the largest _plain_pods shape)
        run("cfg17_pallas", lambda: _pallas_bench(
            n_pods=120, n_types=24, topo_pods=60, topo_types=24,
            max_slots=128, topo_slots=128,
        ))
        run("cfg18_topoaware", lambda: _topoaware_bench(
            n_gangs=3, n_plain=60,
        ))

    correct = all(c["correct"] for c in detail.values())
    print(json.dumps({
        # a filtered round (--configs) is not comparable to a full one:
        # record what was selected
        "configs": only,
        "device": device,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "source_digest": source_digest()[0],
        "correct": correct,
        "detail": detail,
    }))
    return 0 if correct else 4


if __name__ == "__main__":
    if "--restart-probe" in sys.argv:
        _restart_probe()
    elif "--multidev-probe" in sys.argv:
        _multidev_probe()
    else:
        raise SystemExit(main())
