"""The port's bench: bench.py's configs through ``karpenter_core_tpu_torch``.

Run from the root of a checkout:

    python3 bench_torch.py [--configs cfgA,cfgB] [--no-verify]   # on the GPU
    python3 bench_torch.py --device cpu                          # plain scan

It prints ONE JSON line with bench.py's schema (``metric``, ``value``,
``unit``, ``vs_baseline``, ``budget_ok``, ``verification``, ``configs``,
``detail``; every config keeps bench.py's keys, ``phases`` included), so
the two lines read side by side. The config names, ``--configs`` prefix
matching, ``--no-verify`` and the ``BENCH_PODS`` / ``BENCH_TYPES`` /
``BENCH_FAST`` knobs are bench.py's; see its docstring for what each
config measures. What differs:

* ``--device cuda|cpu`` (default ``cuda``). Without a GPU ``cuda`` raises
  (``utils/device.resolve_device``); nothing falls back to the CPU. On the
  card every solve runs the CUDA FFD kernel (``kernel_backend="cuda"``); on
  the CPU the plain scan (``"reference"``). Every ``phases`` block names the
  backend that answered.
* Set-up: the kernel library is built once at start from the checkout's
  sources (``ops/cuda_ffd.build``), reported as ``build_s``, never inside a
  timed window. There is no compile cache to warm.
* Every timed window that does not end in a host read ends in
  ``torch.cuda.synchronize()``.
* Top-level ``device`` (``platform`` gpu or cpu, ``name``,
  ``power_limit_w`` and ``count``; name and limit from ``nvidia-smi``),
  ``torch``, ``cuda`` and ``source_digest`` (``chip_smoke.source_digest``).
* On the card each config adds per-layer readings (``phases`` where the
  config has them, else ``readings``): ``kernel_launches`` (the growth of
  ``cuda_ffd.counter`` over the last timed unit), ``device_idle_share``
  (one extra profiled unit after the timed ones) and
  ``peak_device_bytes`` (``torch.cuda.max_memory_allocated`` over the timed
  units). A CPU run carries none of them.
* Answers are checked. Each config records ``answers`` (its node counts
  and, where it has them, evictions, gangs, $-cost, relax outcome,
  frontier, wire parity and the twin's violations), ``expected`` (the JAX
  package's answer at this run's sizes, pinned in ``EXPECTED`` with the
  command that produced it; null at sizes with no pinned answer) and
  ``correct``: the answers equal ``expected``, the config's structural
  gates hold and the verifier's rejection counter
  (``SOLVER_RESULT_REJECTED``) did not move. The host ``Scheduler`` stays
  the independent greedy oracle (``parity_nodes_delta``).
* ``cfg17_pallas`` keeps its name: it holds the ``cuda`` and ``reference``
  backends to one result wire and one fetch-window byte count and records
  both p50s. The plain scan is the kernel's oracle, not a speed baseline,
  so no speed verdict is drawn from it.
* A sidecar solve that is not answered raises (the port's client has no
  greedy fallback), so cfg7 counts refused solves where bench.py counts
  greedy fallbacks.
* ``--lint`` is bench.py's alone (it lints the JAX package).

Exit codes: 1 when the primary p50 is over 1 s (bench.py's budget), 4 when
a config is not ``correct``; the JSON line is printed first either way. A
config that raises is not caught.
"""
from __future__ import annotations

import json
import os
import sys
import time

N_PODS = int(os.environ.get("BENCH_PODS", "50000"))
N_TYPES = int(os.environ.get("BENCH_TYPES", "800"))
FAST = os.environ.get("BENCH_FAST", "") == "1"
# --no-verify: the escape hatch for isolating verification cost; its use
# is recorded in the JSON
NO_VERIFY = "--no-verify" in sys.argv
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
    """One greedy-oracle solve on the identical inputs; returns (nodes, s)."""
    import copy

    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.scheduler import (
        Scheduler,
    )

    its = {p.name: list(catalog) for p in nodepools}
    s = Scheduler(copy.deepcopy(nodepools), its)
    pods = copy.deepcopy(pods)  # outside the timed window
    t0 = time.perf_counter()
    res = s.solve(pods)
    dt = time.perf_counter() - t0
    assert res.all_pods_scheduled(), list(res.pod_errors.items())[:3]
    return res.node_count(), dt


def _spread(times):
    """p50/p99/IQR over warm solves — a single p50 can't distinguish a real
    regression from contention on a shared host."""
    ts = sorted(times)
    n = len(ts)

    def q(p):
        return ts[min(int(round(p * (n - 1))), n - 1)]

    return {
        "p50_solve_s": round(q(0.50), 3),
        "p99_solve_s": round(q(0.99), 3),
        "iqr_s": round(q(0.75) - q(0.25), 3),
        "warm_times_s": [round(t, 3) for t in ts],
    }


def _phase_breakdown(sched) -> dict:
    """Per-phase split of the LAST solve (DeviceScheduler.last_phase_stats):
    host plan, host prepare, device dispatch incl. the result fetch, host
    decode and the verification pass, the device<->host bytes moved, the
    slot usage, the prepared-cache hits, the solve backend (``solver_mode``,
    with relax's verdict block) and the kernel backend that answered
    (``kernel_backend``: ``cuda`` or ``reference``)."""
    st = sched.last_phase_stats or {}
    out = {}
    for k in ("plan_s", "prepare_s", "kernel_s", "decode_s", "verify_s"):
        if k in st:
            out[k] = round(st[k], 4)
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


def _sync():
    """End a timed window on the card: wait for the queued device work."""
    if DEVICE == "cuda":
        import torch

        torch.cuda.synchronize()


def _launches() -> int:
    """Kernel launches so far (the wrappers count only launches on the
    card)."""
    from karpenter_core_tpu_torch.ops import cuda_ffd

    return cuda_ffd.counter.total()


def _timed(fn, repeats):
    """``repeats`` timed calls of ``fn``, each window ending in a sync;
    returns (seconds, the last result, the kernel launches of the last
    call)."""
    times, res, grew = [], None, 0
    for _ in range(repeats):
        n0 = _launches()
        t0 = time.perf_counter()
        res = fn()
        _sync()
        times.append(time.perf_counter() - t0)
        grew = _launches() - n0
    return times, res, grew


def _reset_peak():
    """Start the window that ``peak_device_bytes`` covers."""
    if DEVICE == "cuda":
        import torch

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _card_readings(launches, profiled=None, cpu=True) -> dict:
    """The per-layer readings of the card (empty on the CPU, where nothing
    is a device metric): the kernel launches of the last timed unit, the
    peak device bytes since ``_reset_peak`` (read first, so the profiled
    unit is outside it), and the device idle share of one extra profiled
    run of ``profiled`` (``chip_smoke.traced_idle``, which
    ``chip_smoke._idle_share`` reads; ``cpu=False`` traces the device
    only). The share is null when the trace holds fewer scan kernels than
    the unit launched (``traced_launches``, [traced, launched]): a trace
    that dropped the kernel would overstate it."""
    if DEVICE != "cuda":
        return {}
    import torch

    from chip_smoke import traced_idle

    torch.cuda.synchronize()
    out = {
        "kernel_launches": int(launches),
        "peak_device_bytes": int(torch.cuda.max_memory_allocated()),
        "device_idle_share": None,
    }
    if profiled is not None:
        n0 = _launches()
        idle, traced = traced_idle(profiled, cpu=cpu)
        ran = _launches() - n0
        out["traced_launches"] = [traced, ran]
        if traced >= ran:
            out["device_idle_share"] = idle
    return out


def _solve_bench(pods, nodepools, catalog, max_slots=1024, repeats=5,
                 parity=True, devices=1, verify=None, kernel=None):
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler

    # verify defaults to the RUN-WIDE flag: --no-verify must govern every
    # config, or the recorded "verification": false would lie about which
    # numbers still paid the trust anchor
    if verify is None:
        verify = not NO_VERIFY
    kernel = KERNEL if kernel is None else kernel
    its = {p.name: list(catalog) for p in nodepools}
    sched = DeviceScheduler(
        nodepools, its, max_slots=max_slots, devices=devices, verify=verify,
        kernel_backend=kernel, device=DEVICE,
    )

    t0 = time.perf_counter()
    res = sched.solve(pods)
    _sync()
    cold = time.perf_counter() - t0
    assert res.all_pods_scheduled(), list(res.pod_errors.items())[:3]

    _reset_peak()
    times, res, launches = _timed(lambda: sched.solve(pods), repeats)
    out = _spread(times)
    p50_raw = sorted(times)[len(times) // 2]  # unrounded for the ratio
    # phase split of the final warm solve (steady-state: prepared-state
    # caches hot, adaptive slot axis settled), then the card's readings;
    # the plain scan (cfg17's oracle) is not profiled
    phases = _phase_breakdown(sched)
    phases.update(_card_readings(
        launches,
        (lambda: sched.solve(pods)) if kernel == "cuda" else None))
    out.update({
        "cold_solve_s": round(cold, 3),
        "pods_per_sec": round(len(pods) / p50_raw, 1),
        "nodes": res.node_count(),
        "phases": phases,
    })
    if parity:
        greedy_nodes, greedy_s = _greedy_nodes(pods, nodepools, catalog)
        out["greedy_nodes"] = greedy_nodes
        out["greedy_solve_s"] = round(greedy_s, 1)
        out["parity_nodes_delta"] = res.node_count() - greedy_nodes
    return out


def _verified_summary(primary: dict, cfg1: dict) -> dict:
    """cfg9_verified: the verification trust anchor's cost, pinned.

    Verification is ON in the primary config (the production default), so
    its per-solve cost already rides every measurement above as the
    ``verify_s`` phase; this summary judges it against the <5% budget —
    relative to cfg1's solve p50 (the acceptance reference) and to the
    primary's own p50 — and records whether the --no-verify escape hatch
    was pulled for this run."""
    verify_s = (primary.get("phases") or {}).get("verify_s")
    out = {
        "verification_on": not NO_VERIFY,
        "verify_s": verify_s,
        "pods": N_PODS,
    }
    if verify_s is None:
        out["skipped"] = "--no-verify: no verification phase measured"
        return out
    p50 = primary["p50_solve_s"]
    out["pct_of_primary_p50"] = round(100.0 * verify_s / p50, 2) if p50 else None
    if cfg1:
        ref = cfg1["p50_solve_s"]
        # the verify phase scales with pod count; cfg1's own verify cost
        # is the like-for-like comparison at the 5k point
        cfg1_verify = (cfg1.get("phases") or {}).get("verify_s")
        out["cfg1_p50_s"] = ref
        out["cfg1_verify_s"] = cfg1_verify
        if cfg1_verify is not None and ref:
            out["cfg1_pct_of_p50"] = round(100.0 * cfg1_verify / ref, 2)
            out["budget_ok"] = cfg1_verify <= 0.05 * ref
    return out


def _ice_storm_bench(n_pods=5000, n_types=400, fractions=(0.0, 0.25, 0.5),
                     repeats=3):
    """Solve latency under an ICE storm: a growing fraction of the
    catalog's offerings — CHEAPEST first, exactly the rows the packer
    wants — marked unavailable through the same snapshot the provisioner
    passes (the UnavailableOfferings cache populated by lifecycle on
    InsufficientCapacityError). Measures the stockout-masking overhead
    (apply_unavailable catalog projection + the off_avail tensor mask) and
    the repack cost of routing around dead capacity."""
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
        sched.solve(pods)  # warm the prepared caches at this masking shape
        _reset_peak()
        times, res, launches = _timed(lambda: sched.solve(pods), repeats)
        entry = _spread(times)
        entry["unavailable_offerings"] = k
        entry["nodes"] = res.node_count()
        entry["all_scheduled"] = res.all_pods_scheduled()
        readings = _card_readings(launches, lambda: sched.solve(pods))
        if readings:
            entry["readings"] = readings
        out[f"storm_{int(frac * 100)}pct"] = entry
    return out


def _shape_churn_bench(n=20000, types=800, rounds=6):
    """Every solve mutates the pod mix — different pod counts AND a
    different shape grid, so class counts drift round to round. Bucketed
    device shapes (models/provisioner._bucket) keep the prepared planes'
    shapes in a few buckets: p50 over the churn rounds should sit near the
    static-shape p50. ``nodes_by_round`` is each round's answer."""
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler
    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog

    catalog = bench_catalog(types)
    sched = DeviceScheduler(
        [_pool()], {"default": list(catalog)}, max_slots=1024,
        kernel_backend=KERNEL, device=DEVICE,
    )
    times, nodes = [], []
    _reset_peak()
    launches = 0
    for r in range(rounds):
        pods = _plain_pods(n + 53 * r, shapes=(14 + r % 3, 11 + r % 2))
        (t,), res, launches = _timed(lambda: sched.solve(pods), 1)
        times.append(t)
        assert res.all_pods_scheduled(), list(res.pod_errors.items())[:3]
        nodes.append(res.node_count())
    churn = sorted(times[1:])[len(times[1:]) // 2]
    out = {
        "p50_churn_s": round(churn, 3),
        "cold_s": round(times[0], 3),
        "rounds": rounds,
        "round_times_s": [round(t, 3) for t in times],
        "nodes_by_round": nodes,
    }
    readings = _card_readings(launches, lambda: sched.solve(pods))
    if readings:
        out["readings"] = readings
    return out


def _consolidation_bench(n_nodes=2000, n_candidates=100, repeats=3):
    """BASELINE config 4: the multi-node consolidation frontier over a
    2k-node cluster — all `n_candidates` prefixes in one batched scan
    (models/consolidation.py; one kernel launch on the card) instead of the
    reference's binary search of full scheduling simulations
    (multinodeconsolidation.go:110-162). The sweep returns device tensors,
    so each timed window ends in a sync."""
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

    def sweep():
        return _prefix_scan(*args)

    (cold,), out, _ = _timed(sweep, 1)
    _reset_peak()
    times, out, launches = _timed(sweep, repeats)
    p50 = sorted(times)[len(times) // 2]
    unplaced = out[1].cpu().numpy()
    result = {
        "p50_sweep_s": round(p50, 3),
        "cold_sweep_s": round(cold, 3),
        "prefixes": n_candidates,
        "cluster_nodes": n_nodes,
        "schedulable_prefixes": int((unplaced == 0).sum()),
    }
    readings = _card_readings(launches, sweep)
    if readings:
        result["readings"] = readings
    return result


def _sidecar_bench(n_pods=5000, n_types=400, repeats=5):
    """solverd RPC overhead: the same solve through the in-proc
    DeviceScheduler and through a sidecar (in-thread server — the codec,
    HTTP framing, and result rematerialization are the costs under test;
    process hop adds scheduler noise, not work). Reported per phase from
    the client's RPC histograms so encode/transit/kernel/decode drift is
    visible across rounds."""
    from karpenter_core_tpu_torch.metrics import wiring as m
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler
    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.solver import remote, service

    pods = _plain_pods(n_pods)
    catalog = bench_catalog(n_types)
    pools = [_pool()]
    its = {"default": list(catalog)}

    sched = DeviceScheduler(pools, dict(its), max_slots=1024,
                            kernel_backend=KERNEL, device=DEVICE)
    sched.solve(pods)  # warm-up
    inproc_times, res, _ = _timed(lambda: sched.solve(pods), repeats)
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
            verify=not NO_VERIFY,
        )
        _reset_peak()
        rpc_times, res, launches = _timed(lambda: rs.solve(pods), repeats)
        assert res.all_pods_scheduled()
        # mode parity: the sidecar is the SAME solver behind a wire — any
        # node-count delta vs in-proc means the codec/rebind leaked
        assert res.node_count() == inproc_nodes, (
            res.node_count(), inproc_nodes,
        )
        readings = _card_readings(launches, lambda: rs.solve(pods))
    finally:
        srv.shutdown()
        srv.server_close()

    p50_in = sorted(inproc_times)[len(inproc_times) // 2]
    p50_rpc = sorted(rpc_times)[len(rpc_times) // 2]
    phases = {}
    h = m.SOLVER_RPC_PHASE_DURATION
    for phase in ("encode", "transit", "kernel", "decode"):
        k = (("phase", phase),)
        total, n = h.sums.get(k, 0.0), h.totals.get(k, 0)
        phases[f"mean_{phase}_s"] = round(total / n, 3) if n else None
    out = {
        "pods": n_pods,
        "p50_inproc_s": round(p50_in, 3),
        "p50_sidecar_s": round(p50_rpc, 3),
        "rpc_overhead_s": round(p50_rpc - p50_in, 3),
        "nodes": inproc_nodes,
        "mode_parity_nodes_delta": 0,  # asserted equal above
        **phases,
    }
    if readings:
        out["readings"] = readings
    return out


def _fleet_bench(n_tenants=8, n_pods=1000, n_types=200, repeats=3):
    """cfg7_fleet: N synthetic tenants hammering ONE sidecar through the
    fleet gateway (solver/fleet.py). Every tenant owns a distinct problem
    fingerprint (tenant-named pool; identical catalog shapes) and the
    scheduler cache is deliberately smaller than the tenant count, so the
    heterogeneous mix churns it — the eviction counter must move.

    Phases: (1) solo — each tenant alone, for its baseline queue-wait and
    e2e percentiles; (2) concurrent — all tenants hammer at once through
    their own RemoteSchedulers with a queue bound low enough that bursts
    shed. The port's client has no greedy path: a solve still shed after
    its retries raises, and is counted in ``refused_solves`` (bench.py
    counts the reference's greedy fallbacks there; ``greedy_fallbacks``
    stays 0 here); (3) a forced-shed probe — one solve against a saturated
    gateway must be refused (``shed_refused``: RemoteSolverError with cause
    "shed", nothing placed), where bench.py checks the reference's greedy
    answer (``shed_parity_ok``).

    ``fairness_ok`` is the no-starvation bound: no tenant's concurrent
    p99 queue wait exceeds 3x its fair-share round latency (n_tenants x
    the observed p50 device time) — a starved tenant blows that by an
    order of magnitude, a fair queue sits under it."""
    import threading

    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
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
                verify=not NO_VERIFY,
            )

        # -- solo baselines (also the warm-up) ------------------------------
        solo = {}
        for tenant in tenants:
            rs = scheduler_for(tenant)
            rs.solve(problems[tenant]["pods"])  # warm
            times, res, _ = _timed(
                lambda: rs.solve(problems[tenant]["pods"]), repeats)
            assert res.all_pods_scheduled()
            solo[tenant] = {
                "e2e": _spread(times), "nodes": res.node_count(),
            }
        solo_waits = gateway.snapshot(reset=True)["tenants"]

        # -- concurrent hammer --------------------------------------------
        fallbacks_before = m.SOLVER_RPC_FALLBACKS.value(
            {"endpoint": "solve"}
        )
        conc_times = {tenant: [] for tenant in tenants}
        refused = {tenant: 0 for tenant in tenants}
        errors = []

        def hammer(tenant):
            try:
                rs = scheduler_for(tenant)
                for _ in range(repeats):
                    t0 = time.perf_counter()
                    try:
                        res = rs.solve(problems[tenant]["pods"])
                    except remote.RemoteSolverError as e:
                        if e.cause != "shed":
                            raise
                        refused[tenant] += 1
                        continue
                    conc_times[tenant].append(time.perf_counter() - t0)
                    assert res.all_pods_scheduled()
            except Exception as e:  # surfaced after join
                errors.append((tenant, repr(e)))

        threads = [
            threading.Thread(target=hammer, args=(t,), daemon=True)
            for t in tenants
        ]
        _reset_peak()
        n0 = _launches()
        wall0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        _sync()
        wall = time.perf_counter() - wall0
        launches = _launches() - n0
        assert not errors, errors
        snap = gateway.snapshot()
        shed_total = sum(snap["sheds"].values())
        fallbacks = m.SOLVER_RPC_FALLBACKS.value(
            {"endpoint": "solve"}
        ) - fallbacks_before
        readings = _card_readings(
            launches,
            lambda: scheduler_for(tenants[0]).solve(
                problems[tenants[0]]["pods"]),
        )

        # -- forced-shed probe --------------------------------------------
        parked = [
            gateway.submit("parked", fleet.LANE_SOLVE)
            for _ in range(gateway.max_depth - gateway.depth())
        ]
        probe = problems[tenants[0]]
        rs = scheduler_for(tenants[0])
        try:
            rs.solve(probe["pods"])  # 429 -> raises: no greedy path
            shed_refused = False
        except remote.RemoteSolverError as e:
            shed_refused = e.cause == "shed"
        finally:
            for ticket in parked:
                gateway.abandon(ticket)

        fair_bound = 3.0 * n_tenants * snap["device_p50_s"]
        per_tenant = {}
        for tenant in tenants:
            waits = snap["tenants"].get(tenant, {})
            per_tenant[tenant] = {
                "solo_wait_p99_s": solo_waits.get(tenant, {}).get(
                    "wait_p99_s", 0.0
                ),
                "wait_p50_s": waits.get("wait_p50_s", 0.0),
                "wait_p99_s": waits.get("wait_p99_s", 0.0),
                "solo_p50_e2e_s": solo[tenant]["e2e"]["p50_solve_s"],
                "p50_e2e_s": round(
                    sorted(conc_times[tenant])[len(conc_times[tenant]) // 2],
                    3,
                ) if conc_times[tenant] else None,
                "nodes": solo[tenant]["nodes"],
            }
        out = {
            "tenants": n_tenants,
            "pods_per_tenant": n_pods,
            "aggregate_pods_per_sec": round(
                sum(len(ts) for ts in conc_times.values()) * n_pods / wall, 1
            ),
            "device_p50_s": snap["device_p50_s"],
            "shed_total": shed_total,
            "sheds_by_reason": snap["sheds"],
            "greedy_fallbacks": fallbacks,
            "refused_solves": sum(refused.values()),
            "cache_evictions": dict(cache.evictions),
            "cache_entries": len(cache),
            "cache_entry_bound": cache.max_entries,
            "shed_refused": shed_refused,
            "fair_bound_s": round(fair_bound, 3),
            "fairness_ok": all(
                pt["wait_p99_s"] <= fair_bound for pt in per_tenant.values()
            ),
            "per_tenant": per_tenant,
        }
        if readings:
            out["readings"] = readings
        return out
    finally:
        srv.shutdown()
        srv.server_close()


def _batch_bench(n_tenants=32, n_pods=120, n_types=60, repeats=3):
    """cfg10_batch: continuous cross-tenant solve batching.

    The many-small-solves traffic shape: N tenants, each with a SMALL
    problem (distinct fingerprint — tenant-named pool — but identical
    catalog/pod SHAPES, so every tenant lands in the same shape
    bucket), hammering one sidecar concurrently. Two phases over the same
    problems:

    * serialized — max_batch=1: the cfg7-shaped baseline, one exclusive
      device grant per request;
    * batched — the production defaults (max_batch=8, a few-ms window):
      a granted leader coalesces compatible queued problems into one
      batched multi-problem device dispatch (one kernel launch).

    Records aggregate pods/sec both ways (speedup target >=2x), the mean
    batch size and batch-axis padding ratio actually achieved, and
    per-tenant p99 queue wait (batched must be no worse than serialized:
    coalescing must AMORTIZE device time, not starve anyone)."""
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
            # deep enough that nothing sheds: this config measures
            # throughput and wait, cfg7 owns overload behavior
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

            def scheduler_for(tenant):
                p = problems[tenant]
                client = remote.SolverClient(addr, timeout=600, tenant=tenant)
                return remote.RemoteScheduler(
                    client, p["pools"], p["its"],
                    device_scheduler_opts={"max_slots": 256},
                    verify=not NO_VERIFY,
                )

            errors = []
            counts = {t: 0 for t in tenants}

            def hammer(tenant, rounds, count=False):
                try:
                    rs = scheduler_for(tenant)
                    for _ in range(rounds):
                        res = rs.solve(problems[tenant]["pods"])
                        assert res.all_pods_scheduled(), res.pod_errors
                        nodes_seen.add(res.node_count())
                        if count:
                            counts[tenant] += 1
                except Exception as e:  # surfaced after join
                    errors.append((tenant, repr(e)))

            # warm-up 1: each padded batch size (1, 2, 4, ... — the
            # power-of-two batch-axis pad) once, DETERMINISTICALLY, with
            # in-process solve_batch calls at the exact problem shapes the
            # timed phase produces (the concurrent warm rounds below
            # cannot guarantee which batch sizes they hit)
            if max_batch > 1:
                import copy as _copy

                from karpenter_core_tpu_torch.models.provisioner import (
                    DeviceScheduler,
                    solve_batch,
                )

                size = 2
                while size <= max_batch:
                    entries = []
                    for j in range(size):
                        p = problems[tenants[j % n_tenants]]
                        entries.append((
                            DeviceScheduler(
                                p["pools"], p["its"], max_slots=256,
                                verify=False, kernel_backend=KERNEL,
                                device=DEVICE,
                            ),
                            _copy.deepcopy(p["pods"]),
                        ))
                    outcomes, _stats = solve_batch(entries)
                    assert all(st == "ok" for st, _ in outcomes)
                    size *= 2
            def one_round():
                ws = [
                    threading.Thread(
                        target=hammer, args=(t, 1), daemon=True
                    )
                    for t in tenants
                ]
                for w in ws:
                    w.start()
                for w in ws:
                    w.join()

            # warm-up 2: two untimed concurrent rounds through the real
            # transport warm the scheduler cache
            for _ in range(2):
                one_round()
            assert not errors, errors[:3]

            gateway.snapshot(reset=True)
            pad_sum0 = sum(m.SOLVERD_BATCH_PADDING.sums.values())
            pad_n0 = sum(m.SOLVERD_BATCH_PADDING.totals.values())
            threads = [
                threading.Thread(
                    target=hammer, args=(t, repeats, True), daemon=True
                )
                for t in tenants
            ]
            _reset_peak()
            n0 = _launches()
            wall0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            _sync()
            wall = time.perf_counter() - wall0
            launches = _launches() - n0
            assert not errors, errors[:3]
            snap = gateway.snapshot()
            # the readings' launches cover the whole timed phase; the
            # profiled unit is one more concurrent round
            readings = _card_readings(launches, one_round)
            solves = sum(counts.values())
            pad_n = sum(m.SOLVERD_BATCH_PADDING.totals.values()) - pad_n0
            pad_sum = sum(m.SOLVERD_BATCH_PADDING.sums.values()) - pad_sum0
            waits = {
                t: snap["tenants"].get(t, {}).get("wait_p99_s", 0.0)
                for t in tenants
            }
            return {
                "aggregate_pods_per_sec": round(solves * n_pods / wall, 1),
                "wall_s": round(wall, 3),
                "solves": solves,
                "device_p50_s": snap["device_p50_s"],
                "grants": snap["grants"],
                "mean_batch_size": snap["batch"]["mean_size"],
                "coalesced": snap["batch"]["coalesced"],
                "padding_ratio": round(pad_sum / pad_n, 4) if pad_n else 0.0,
                "wait_p99_max_s": round(max(waits.values()), 6),
                "wait_p99_mean_s": round(
                    sum(waits.values()) / len(waits), 6
                ),
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
    speedup = batched["aggregate_pods_per_sec"] / max(
        serialized["aggregate_pods_per_sec"], 1e-9
    )
    backend = _platform()
    out = {
        "tenants": n_tenants,
        "pods_per_tenant": n_pods,
        "repeats": repeats,
        "backend": backend,
        "nodes": sorted(nodes_seen),
        "serialized": serialized,
        "batched": batched,
        "speedup": round(speedup, 2),
        "speedup_ok": speedup >= 2.0,
        # the coalescer itself must demonstrably engage regardless of
        # backend: grants served >1 problem on average under contention
        "coalesce_ok": batched["mean_batch_size"] >= 1.5,
        # no-worse bound on the per-tenant tail: coalescing must not buy
        # throughput by starving someone (small epsilon absorbs timer
        # noise on near-zero waits)
        "queue_wait_ok": (
            batched["wait_p99_max_s"]
            <= serialized["wait_p99_max_s"] + 0.010
        ),
        "mean_batch_size": batched["mean_batch_size"],
        "padding_ratio": batched["padding_ratio"],
    }
    if backend == "cpu":
        # the amortization target is an accelerator property: a batched
        # scan on the CPU competes with the solo scans for the same cores;
        # the CPU run still proves coalescing, fairness shares and waits
        out["speedup_note"] = (
            "cpu backend: batched kernels share the serial cores the"
            " solo kernels used; >=2x aggregate pods/sec is judged on"
            " the accelerator bench run"
        )
    return out


def _multidev_bench(repeats=3) -> dict:
    """cfg8_multidev: the primary config over every local GPU
    (``DeviceScheduler(devices=n)``, parallel/mesh.py: solo scans on the
    mesh's lead device, batched problems and the sweep's prefixes split
    over it). On a host without two GPUs the throughput half is
    meaningless, so it records `throughput_skipped` and runs the
    sharded-vs-single parity battery in a CHILD process on an 8-device
    virtual CPU mesh (``force_virtual_mesh(8, "cpu")``) instead."""
    import torch

    n_avail = torch.cuda.device_count() if DEVICE == "cuda" else 1
    if DEVICE == "cpu" or n_avail < 2:
        out = _run_multidev_probe()
        out.setdefault("throughput_skipped", True)
        out["reason"] = (
            f"{_platform()} backend with {n_avail} device(s);"
            " multi-device throughput needs a real >=2-device slice"
        )
        return out

    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog

    catalog = bench_catalog(N_TYPES)
    pods = _plain_pods(N_PODS)
    single = _solve_bench(
        pods, [_pool()], catalog, parity=False, repeats=repeats, devices=1
    )
    multi = _solve_bench(
        pods, [_pool()], catalog, parity=False, repeats=repeats,
        devices=n_avail,
    )
    speedup = multi["pods_per_sec"] / single["pods_per_sec"]
    return {
        "n_devices": n_avail,
        "throughput_skipped": False,
        "single": single,
        "multi": multi,
        "speedup_vs_single": round(speedup, 2),
        # the acceptance bar is defined on >=8 devices; on a smaller
        # slice report null rather than a vacuous pass
        "target_4x_ok": (speedup >= 4.0) if n_avail >= 8 else None,
        "parity_nodes_delta_multi_vs_single": (
            multi["nodes"] - single["nodes"]
        ),
    }


def _multidev_probe() -> None:
    """Child mode: an 8-device virtual CPU mesh runs the
    sharded-vs-single-device parity battery at small sizes — identical
    node counts and identical result wire bytes across an even split, a
    slot axis that needs padding (n_slots % n_devices != 0), and a
    3-device mesh, every solve on the plain scan. Throughput is NOT
    measured here (virtual devices share one CPU); prints one JSON line
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
                  topo_types=None, max_slots=1024, topo_slots=2048,
                  repeats=5) -> dict:
    """cfg17_pallas (name kept so ``--configs`` matches bench.py's): the
    CUDA FFD kernel (``kernel_backend="cuda"``) against the plain scan
    (``"reference"``) on the primary shape and the cfg3 topology mix.

    The plain scan is the kernel's oracle, not a speed baseline: both p50s
    are recorded and no speed verdict is drawn. The gates are parity, held
    INSIDE the round: each shape solves once more under both backends
    through fresh schedulers and compares the encoded result wire, and
    the used-slot fetch window (host-side, post-kernel) must move the
    same ``fetch_dev_bytes`` on both. On the CPU both backends run the
    plain scan (the kernel wrapper's CPU route)."""
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
        # one fresh solve per backend, outside the timed loops: byte
        # compare the decision content (solve_seconds pinned — timing is
        # not packing)
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

    def shape(pods, pools, catalog, slots, reps):
        ref = _solve_bench(
            pods, pools, catalog, max_slots=slots, repeats=reps,
            parity=False, kernel="reference",
        )
        cud = _solve_bench(
            pods, pools, catalog, max_slots=slots, repeats=reps,
            parity=False, kernel="cuda",
        )
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
    primary = shape(
        _plain_pods(n_pods), [_pool()], catalog, max_slots, repeats
    )
    topology = shape(
        _topology_pods(topo_pods), [_pool()], bench_catalog(topo_types),
        topo_slots, max(repeats - 2, 2),
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


def _gangs_bench(n_pods=20000, n_existing=None, repeats=3,
                 cfg1_p50=None) -> dict:
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
    * nodes — the final solve's node count;
    * p50_vs_cfg1 — the priority/gang machinery's price over the plain
      cfg1-shaped solve at the same scale (plain problems pay nothing;
      THIS config pays the gang scan + preemption pass and records how
      much).
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
        existing_nodes=existing, max_slots=4096, verify=not NO_VERIFY,
        kernel_backend=KERNEL, device=DEVICE,
    )
    (cold,), res, _ = _timed(lambda: sched.solve(pods), 1)
    _reset_peak()
    times, res, launches = _timed(lambda: sched.solve(pods), repeats)
    phases = _phase_breakdown(sched)
    phases.update(_card_readings(launches, lambda: sched.solve(pods)))

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

    out = _spread(times)
    p50_raw = sorted(times)[len(times) // 2]
    out.update({
        "cold_solve_s": round(cold, 3),
        "pods": len(pods),
        "pods_per_sec": round(len(pods) / p50_raw, 1),
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
    })
    if cfg1_p50:
        out["p50_vs_cfg1"] = round(p50_raw / cfg1_p50, 2)
    return out


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


def _topoaware_bench(n_gangs=40, n_plain=2000, repeats=3) -> dict:
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
    ``gangs_placed_ok`` — every gang actually bound. ``p50_ratio``
    records the topo machinery's latency price over the blind solve.
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
    measured = {}
    for mode in ("aware", "blind"):
        existing = _racked_nodes(n_existing,
                                 with_topo_labels=(mode == "aware"))
        sched = DeviceScheduler(
            [_pool()], {"default": list(catalog)},
            existing_nodes=existing, max_slots=4096, verify=not NO_VERIFY,
            kernel_backend=KERNEL, device=DEVICE,
        )
        (cold,), res, _ = _timed(lambda: sched.solve(pods), 1)
        _reset_peak()
        times, res, launches = _timed(lambda: sched.solve(pods), repeats)
        phases = _phase_breakdown(sched)
        phases.update(_card_readings(launches, lambda: sched.solve(pods)))
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
        p50_raw = sorted(times)[len(times) // 2]
        measured[mode] = {
            "p50": p50_raw,
            "hops": worst_hops,
            "nodes": len(res.new_node_claims) + sum(
                1 for s in res.existing_nodes if s.pods
            ),
        }
        out[mode] = {
            **_spread(times),
            "cold_solve_s": round(cold, 3),
            "max_intra_gang_hops": worst_hops,
            "provable_hop_bound": worst_bound,
            "gangs_placed": gangs_placed,
            "node_count": measured[mode]["nodes"],
            "new_claims": len(res.new_node_claims),
            "cost_dollars_per_hour": round(_result_cost(res), 3),
            "unschedulable": len(res.pod_errors),
            "phases": phases,
        }
    aware, blind = out["aware"], out["blind"]
    out.update({
        "p50_ratio": round(
            measured["aware"]["p50"] / measured["blind"]["p50"], 2
        ),
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


def _relax_bench(n_pods=5000, repeats=3):
    """cfg12_relax: the relaxsolve backend vs FFD on the two marquee
    shapes — cfg3-shaped (the diverse topology mix) and cfg11-shaped
    (gang/tier mix, ``_gang_tier_pods``) problems — over a two-pool
    catalog where first-template-wins is provably suboptimal
    (``_relax_world``). Both modes solve the IDENTICAL pod sets; the
    record is the node-count and $-cost delta at the two p50s — the gate
    is relax strictly fewer nodes AND dollars at equal-or-better p50 (the
    verdict cache makes warm relax solves single-dispatch). Verification
    stays ON (--no-verify governs here too)."""
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
                pools, its, max_slots=4096, verify=not NO_VERIFY,
                solver_mode=mode, kernel_backend=KERNEL, device=DEVICE,
            )
            (cold,), res, _ = _timed(lambda: sched.solve(pods), 1)
            # settle solve (untimed): the adaptive slot axis shrinks after
            # the cold solve, which re-keys the class batch — this run
            # pays the re-evaluation at the settled shape so the
            # timed repeats below measure steady state for BOTH modes
            # (relax's steady state is the verdict-cached single dispatch)
            sched.solve(pods)
            _reset_peak()
            times, res, launches = _timed(lambda: sched.solve(pods), repeats)
            phases = _phase_breakdown(sched)
            phases.update(
                _card_readings(launches, lambda: sched.solve(pods)))
            m = _spread(times)
            m.update({
                "cold_solve_s": round(cold, 3),
                "nodes": res.node_count(),
                "cost": round(_result_cost(res), 3),
                "unschedulable": len(res.pod_errors),
                "phases": phases,
            })
            entry[mode] = m
        f, r = entry["ffd"], entry["relax"]
        entry["nodes_delta"] = r["nodes"] - f["nodes"]  # negative = win
        entry["cost_delta"] = round(r["cost"] - f["cost"], 3)
        entry["p50_ratio"] = (
            round(r["p50_solve_s"] / f["p50_solve_s"], 3)
            if f["p50_solve_s"] else None
        )
        entry["node_improved"] = r["nodes"] < f["nodes"]
        entry["cost_improved"] = r["cost"] < f["cost"]
        # warm p50 parity: the verdict cache must make relax's steady
        # state cost what ffd's does (10% jitter headroom, or 50ms
        # absolute at smoke scale where both p50s are a few ms)
        entry["p50_ok"] = (
            entry["p50_ratio"] is None
            or entry["p50_ratio"] <= 1.10
            or r["p50_solve_s"] - f["p50_solve_s"] <= 0.05
        )
        out[pname] = entry
    out["relax_ok"] = all(
        out[p]["node_improved"] and out[p]["cost_improved"]
        and out[p]["p50_ok"]
        for p in problems
    )
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
    real SolverClient keeps). Records per-re-solve bytes and latency on
    both paths, the delta/full byte ratio (acceptance: <= 0.10 at
    scale), and node-count + result-wire parity per round (the manifest
    path may never change a packing).

    Phase 2 (fleet): N tenants with distinct catalogs (distinct problem
    fingerprints — warm scheduler caches are the prize) hammer 1 / 2 / 4
    in-thread sidecars through the client-side FleetRouter; at the
    largest size, affinity on vs off. Records aggregate pods/sec and the
    scheduler-cache hit rate per topology (affinity must keep re-solves
    hitting the member whose caches are warm)."""
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
    full_times, delta_times = [], []
    parity_ok = True
    launches = 0
    for r in range(rounds + 1):  # round 0 is the cold start
        if r == 1:
            _reset_peak()
        ns, pending, topo = snapshot(r)
        header = codec._encode_solve_header(
            pools, its, ns, [], pending, topology=topo, max_slots=1024,
        )
        # symmetric timing: each path's timer covers ITS encode (the
        # container dump here, split+manifest-encode below) plus the
        # daemon round — the p50 comparison must not hide the full
        # wire's encode cost
        t0 = time.perf_counter()
        body_full = codec._json_payload(header)
        out_full, _ = d_full.solve(body_full)
        t_full = time.perf_counter() - t0

        n0 = _launches()
        t0 = time.perf_counter()
        plan = segments.split_solve_header(header)
        include = [dg for dg in plan.segments if dg not in sent]
        body_delta = codec.encode_manifest_request(plan, include, base=base)
        out_delta, _ = d_delta.solve(body_delta)
        t_delta = time.perf_counter() - t0
        launches = _launches() - n0
        sent |= set(plan.segments)
        base = (plan.listing_digest, plan.listing)

        parity_ok = parity_ok and (
            result_view(out_full) == result_view(out_delta)
        )
        if r > 0:  # the cold round is the catalog upload, not the regime
            full_bytes.append(len(body_full))
            delta_bytes.append(len(body_delta))
            full_times.append(t_full)
            delta_times.append(t_delta)

    ratio = (
        sum(delta_bytes) / sum(full_bytes) if sum(full_bytes) else 1.0
    )
    nodes_full = len(codec._json_header(out_full)["claims"])
    nodes_delta = len(codec._json_header(out_delta)["claims"])
    # the profiled unit: the last round's delta body once more (every
    # segment it names is now stored)
    readings = _card_readings(launches, lambda: d_delta.solve(body_delta))

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
        "p50_full_resolve_s": round(
            sorted(full_times)[len(full_times) // 2], 4
        ) if full_times else None,
        "p50_delta_resolve_s": round(
            sorted(delta_times)[len(delta_times) // 2], 4
        ) if delta_times else None,
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
                    verify=not NO_VERIFY,
                )
                for tenant, tpools, tits, _ in tenant_problems
            }
            hits0 = m.SOLVERD_SCHED_CACHE.value({"outcome": "hit"})
            miss0 = m.SOLVERD_SCHED_CACHE.value({"outcome": "miss"})
            solved = [0]
            lock = threading.Lock()

            def hammer(tenant, tpods):
                for _ in range(fleet_rounds):
                    res = scheds[tenant].solve(copy.deepcopy(tpods))
                    assert res.all_pods_scheduled()
                    with lock:
                        solved[0] += len(tpods)

            t0 = time.perf_counter()
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
            wall = time.perf_counter() - t0
            hits = m.SOLVERD_SCHED_CACHE.value({"outcome": "hit"}) - hits0
            misses = (
                m.SOLVERD_SCHED_CACHE.value({"outcome": "miss"}) - miss0
            )
            return {
                "sidecars": n_sidecars,
                "affinity": affinity,
                "aggregate_pods_per_sec": round(solved[0] / wall, 1),
                "wall_s": round(wall, 3),
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
    Records the p50 re-solve both ways, the speedup, the per-round
    node-count delta vs fresh (node quality must not rot as replays
    compound), and the engine's outcome mix (warm/partial/drift_reset).

    Gates (`incremental_ok`, judged at full scale — a BENCH_FAST run is
    too small for the fresh solve to cost anything, and records the
    numbers): incremental p50 >= 5x below fresh, node count within 2%
    of fresh every round, zero self-verify rejections, and the
    client-facing solver_result_rejected_total unmoved."""
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
    inc_times, fresh_times = [], []
    node_delta_pct = 0.0
    launches = 0
    _reset_peak()
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

        t0 = time.perf_counter()
        out_f, _ = d_fresh.solve(body)
        fresh_times.append(time.perf_counter() - t0)

        inc_body = body_for(pods, prev=prev)
        n0 = _launches()
        t0 = time.perf_counter()
        out_i, _ = d_inc.solve(inc_body)
        inc_times.append(time.perf_counter() - t0)
        launches += _launches() - n0
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
    p50_inc = sorted(inc_times)[len(inc_times) // 2]
    p50_fresh = sorted(fresh_times)[len(fresh_times) // 2]
    speedup = p50_fresh / max(p50_inc, 1e-9)
    replayed = outcomes.get("warm", 0) + outcomes.get("partial", 0)
    ledger = d_inc.incremental.ledger.stats()
    # launches over every incremental round (a replayed round may launch
    # none); the profiled unit (after every counter above is read): the
    # last round's incremental request once more
    readings = _card_readings(launches, lambda: d_inc.solve(inc_body))
    out = {
        "pods": n_anchor + sum(counts.values()),
        "nodes": n_nodes,
        "types": n_types,
        "churn": churn,
        "rounds": rounds,
        "p50_fresh_resolve_s": round(p50_fresh, 4),
        "p50_incremental_resolve_s": round(p50_inc, 4),
        "speedup_x": round(speedup, 1),
        "node_delta_pct_max": round(100.0 * node_delta_pct, 3),
        "outcomes": outcomes,
        "replayed_rounds": replayed,
        # the self-verify gate is structural: ANY rejected outcome means
        # the replay machinery built a packing the trust anchor refused
        "incremental_rejected": outcomes.get("rejected", 0),
        # ... and the client-facing counter must never move for replays
        "verifier_rejections": rejections,
        "ledger": ledger,
        "incremental_ok": bool(
            speedup >= 5.0
            and node_delta_pct <= 0.02
            and replayed > 0
            and outcomes.get("rejected", 0) == 0
            and rejections == 0
        ),
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
    economics are deterministic; queue waits are measured from the real
    gateways AFTER the autoscaler's ramp window, when both tiers serve
    at full size. Resize cost is audited the way the contract states it:
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
    restored, rejections unmoved); `p99_ok` and the headline
    `elastic_ok` are judged at the full-scale round."""
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
        # the port's client has no greedy path: a solve without a verified
        # answer raises, and is counted here where the reference counts a
        # greedy fallback
        failed = []

        def solve_or_count(sched, tpods):
            try:
                sched.solve(copy.deepcopy(tpods))
            except remote.RemoteSolverError as e:
                failed.append(e.cause)

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
                    verify=not NO_VERIFY,
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
            # both runs judge queue waits only AFTER this many ticks —
            # the window the autoscaled tier needs to reach max size
            ramp = max_members - 1
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
                        target=solve_or_count, args=(scheds[tenant], tpods),
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
                if tick == ramp - 1:
                    for daemon in tier.daemons:
                        daemon.gateway.snapshot(reset=True)
            p99 = {}
            for daemon in tier.daemons:
                snap = daemon.gateway.snapshot()
                for tenant, row in snap["tenants"].items():
                    p99[tenant] = max(
                        p99.get(tenant, 0.0), row["wait_p99_s"]
                    )
            open_breakers = sum(
                1 for router in tier.routers for c in router.members
                if c.breaker.state != remote.STATE_CLOSED
            )
            return {
                "sizes": sizes,
                "member_seconds": member_seconds,
                "p99_by_tenant": {
                    t: round(v, 4) for t, v in sorted(p99.items())
                },
                "p99_max_s": round(max(p99.values() or [0.0]), 4),
                "remapped_lineages": tier.remapped,
                "miss_rounds": int(
                    m.SOLVER_RPC_FAILURES.value(
                        {"cause": "segment_miss"}
                    ) - miss0
                ),
                "fallbacks": int(
                    counter_total(m.SOLVER_RPC_FALLBACKS) - fall0
                ),
                "failed_solves": len(failed),
                "open_breakers": open_breakers,
                "decisions": (
                    [list(d) for d in autoscaler.decisions]
                    if autoscaler else None
                ),
            }
        finally:
            tier.stop()

    _reset_peak()
    n0 = _launches()
    auto = run_tier(autoscale=True)
    _sync()
    launches = _launches() - n0
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
                verify=not NO_VERIFY,
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
    p99_ok = auto["p99_max_s"] <= fixed["p99_max_s"] + 0.05
    resize_cost_ok = bool(
        auto["miss_rounds"] == 0
        and auto["fallbacks"] == 0
        and auto["failed_solves"] == 0
        and auto["open_breakers"] == 0
        and fixed["fallbacks"] == 0
        and fixed["failed_solves"] == 0
    )
    # the profiled unit: the autoscaled tier's trace once more (device
    # only: the run is host-bound)
    readings = _card_readings(
        launches, lambda: run_tier(autoscale=True), cpu=False)
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
        "p99_ok": bool(p99_ok),
        "resize_cost_ok": resize_cost_ok,
        "brownout": ladder,
        "elastic_ok": bool(
            saving >= 0.30
            and p99_ok
            and resize_cost_ok
            and ladder["brownout_order_ok"]
        ),
    }
    if readings:
        out["readings"] = readings
    return out


def _restart_probe() -> None:
    """Child mode: a FRESH process finds the kernel library the parent
    built (``load_s``: loading it), boots a DeviceScheduler, pre-warms the
    shape buckets (``DeviceScheduler.prewarm``) and times its first real
    solve at the primary shape — the restart path. Prints one JSON line
    for the parent."""
    t0 = time.perf_counter()
    if DEVICE == "cuda":
        from karpenter_core_tpu_torch.ops import cuda_ffd

        cuda_ffd.build()
    load_s = time.perf_counter() - t0
    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler

    pods = _plain_pods(N_PODS)
    catalog = bench_catalog(N_TYPES)
    t0 = time.perf_counter()
    sched = DeviceScheduler(
        [_pool()], {"default": list(catalog)}, max_slots=1024,
        kernel_backend=KERNEL, device=DEVICE,
    )
    sched.prewarm()
    _sync()
    prewarm_s = time.perf_counter() - t0
    (first,), res, launches = _timed(lambda: sched.solve(pods), 1)
    assert res.all_pods_scheduled()
    out = {
        "prewarm_s": round(prewarm_s, 3),
        "restart_cold_s": round(first, 3),
        "load_s": round(load_s, 3),
        "nodes": res.node_count(),
    }
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


def _twin_bench(scale: str = "full"):
    """cfg14_twin: closed-loop macro outcomes over virtual time. The twin
    IS the judge here — per scenario it reports the ledger
    ($-cost integral, SLO percentiles per workload class, preemption
    burn, tier utilization) plus the wall<->virtual compression, and the
    gates are outcome gates: no invariant violations anywhere, no greedy
    fallbacks on the clean run."""
    from karpenter_core_tpu_torch.twin import (
        FleetFault,
        Scenario,
        Storm,
        WorkloadWave,
    )
    from karpenter_core_tpu_torch.twin.harness import run_scenario

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

    out = {}
    _reset_peak()
    n0 = _launches()
    for name in scenarios:
        t0 = time.perf_counter()
        result = run_scenario(scenarios[name], device=DEVICE, kernel=KERNEL)
        _sync()
        wall = time.perf_counter() - t0
        ledger = result.ledger.encode()
        out[name] = {
            "wall_s": round(wall, 3),
            "virtual_s": ledger["virtual_seconds"],
            "compression_x": round(ledger["virtual_seconds"] / wall, 1),
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
            # the port's client fails a solve where the reference falls
            # back to greedy: its failed RPCs
            "rpc_failures": result.counters["rpc_failures"],
            "verifier_rejections": result.counters["result_rejected"],
        }
    # launches over every scenario (only the tpu-solver fleet scenario
    # runs the kernel); the profiled unit is that scenario once more
    readings = _card_readings(
        _launches() - n0,
        (lambda: run_scenario(scenarios["fleet"], device=DEVICE,
                              kernel=KERNEL))
        if "fleet" in scenarios else None,
        cpu=False,
    )
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
# wire parity, the twin's ledger and violations), never a timing. The
# tier-fault fleet twin is held to its violations only: the port fails a
# solve where the reference falls back to greedy, so its ledger differs by
# design.
ANSWERS = {
    "primary": lambda o: _pick(o, "nodes", "greedy_nodes"),
    "cfg1_5k400": lambda o: _pick(o, "nodes", "greedy_nodes"),
    "cfg2_masked": lambda o: _pick(o, "nodes", "greedy_nodes"),
    "cfg3_topology": lambda o: _pick(o, "nodes", "greedy_nodes"),
    "cfg3_topology_50k": lambda o: _pick(o, "nodes", "greedy_nodes"),
    "cfg9_verified": lambda o: {},
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
        s: _pick(v, *(_TWIN_LEDGER if s != "fleet" else
                      ("invariant_violations", "verifier_rejections")))
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
    "cfg7_fleet": lambda o: o["shed_refused"],
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
        "fleet": {"invariant_violations": 0, "verifier_rejections": 0},
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
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    answers = json.loads(json.dumps(ANSWERS[name](out)))
    gates = GATES.get(name, lambda o: True)(out)
    expected = _pinned(name)
    rejected = _rejections() - rej0
    out["config_wall_s"] = round(wall, 3)
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


def main():
    import torch

    if DEVICE not in ("cuda", "cpu"):
        raise SystemExit(f"--device must be cuda or cpu, not {DEVICE!r}")

    from karpenter_core_tpu_torch.api.objects import Taint
    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog

    from chip_smoke import source_digest

    device = _device_block()
    build_s = None
    if DEVICE == "cuda":
        from karpenter_core_tpu_torch.ops import cuda_ffd

        # the kernel library, built once from the checkout's sources (a
        # fresh checkout compiles it; a later process loads it)
        t0 = time.perf_counter()
        cuda_ffd.build()
        build_s = round(time.perf_counter() - t0, 3)

    # --configs cfgA,cfgB: run only the named secondary configs (prefix
    # match, e.g. "cfg12" selects cfg12_relax). The primary always runs —
    # it is the headline metric every round reports.
    only = None
    if "--configs" in sys.argv:
        i = sys.argv.index("--configs")
        if i + 1 >= len(sys.argv):
            raise SystemExit("--configs needs a comma-separated value")
        only = [c.strip() for c in sys.argv[i + 1].split(",") if c.strip()]
        known = (
            "cfg1_5k400", "cfg2_masked", "cfg3_topology", "cfg4_consol",
            "cfg5_sidecar", "cfg6_ice_storm", "cfg7_fleet", "cfg8_multidev",
            "cfg9_verified", "cfg10_batch", "cfg11_gangs", "cfg12_relax",
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
        return detail[name]

    primary = run("primary", lambda: _solve_bench(
        _plain_pods(N_PODS), [_pool()], catalog, parity=not FAST,
        repeats=7,  # the budget guard reads this p50
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
                repeats=5,
            ))
            # the full diverse mix at the north-star pod count, parity vs
            # the greedy oracle
            run("cfg3_topology_50k", lambda: _solve_bench(
                _topology_pods(50000, n_deploys=40),
                [_pool()],
                bench_catalog(N_TYPES),
                max_slots=4096,
                repeats=3,
            ))
        # cfg9_verified: the primary config WITH verification (the
        # production default); its verify phase against the <5% budget.
        # It is as correct as the primary it summarizes.
        if sel("cfg9_verified"):
            run("cfg9_verified", lambda: _verified_summary(
                primary, detail.get("cfg1_5k400")
            ))
            detail["cfg9_verified"]["correct"] = primary["correct"]
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
            cfg1 = detail.get("cfg1_5k400")
            run("cfg11_gangs", lambda: _gangs_bench(
                # scale to the round's pod knob on small runs; a default
                # (50k-pod) round keeps the classic 20k shape
                n_pods=min(20000, max(N_PODS, 1000)),
                cfg1_p50=cfg1["p50_solve_s"] if cfg1 else None,
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
            n_tenants=4, n_pods=24, n_types=12, repeats=2
        ))
        run("cfg11_gangs", lambda: _gangs_bench(
            n_pods=200, n_existing=4, repeats=2,
            cfg1_p50=primary["p50_solve_s"],
        ))
        # 400 pods is the smallest size where the relax win is structural
        # on BOTH shapes
        run("cfg12_relax", lambda: _relax_bench(n_pods=400, repeats=2))
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
            max_slots=128, topo_slots=128, repeats=2,
        ))
        run("cfg18_topoaware", lambda: _topoaware_bench(
            n_gangs=3, n_plain=60, repeats=2,
        ))

    # bench.py's layout: the primary leads ``detail``
    detail = {"primary": detail.pop("primary"), **detail}
    pods_per_sec = primary["pods_per_sec"]
    budget_ok = primary["p50_solve_s"] <= 1.0
    correct = all(c["correct"] for c in detail.values())
    print(
        json.dumps(
            {
                "metric": f"solve_throughput_{N_PODS}pods_{N_TYPES}types",
                "value": pods_per_sec,
                "unit": "pods/sec",
                "vs_baseline": round(pods_per_sec / 100.0, 2),
                "budget_ok": budget_ok,
                # the escape hatch's use is part of the record: a run
                # without verification is not comparable to one with it
                "verification": not NO_VERIFY,
                # a filtered round (--configs) is not comparable to a
                # full one either — record what was selected
                "configs": only,
                "device": device,
                "torch": torch.__version__,
                "cuda": torch.version.cuda,
                "source_digest": source_digest()[0],
                "build_s": build_s,
                "correct": correct,
                "detail": detail,
            }
        )
    )
    if not budget_ok:
        # enforced floor: the JSON line above is still emitted; the rc
        # flags the regression
        raise SystemExit(1)
    if not correct:
        raise SystemExit(4)


if __name__ == "__main__":
    if "--restart-probe" in sys.argv:
        _restart_probe()
    elif "--multidev-probe" in sys.argv:
        _multidev_probe()
    else:
        main()
