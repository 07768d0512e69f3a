#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs a CUDA device and exits non-zero without one. Phases, each fatal
on failure:

1. device: torch and CUDA versions, the card's name and power limit;
2. build: compiles the FFD step kernel from csrc/ffd_step.cu;
3. kernel against its plain version on the card, on the tensors the
   port's own prepare hands the scan at the 50k-pod x 800-type plain shape
   and the 5k-pod x 400-type topology shape: every plane of the final slot
   state, the takes and the unplaced counts must be bit-equal; times the
   kernel's scan and the plain scan with CUDA events;
4. main path: ``DeviceScheduler(device="cuda").solve`` on the three bench
   problems (50k plain pods x 800 types, 5k plain x 400, 5k topology x
   400), one cold solve and three warm ones each, with the plain step
   made to raise if anything calls it. Node counts must be 444, 171 and
   91 with no pod errors (the JAX package's answers), each of the step's
   four kernels must be launched on every solve once per padded step of
   each dispatch, the verifier's rejection counter must not move, and the
   result must equal the same solve through the plain version
   (``kernel_backend="reference"``). The scan inputs of a warm solve, at
   the adaptive slot width the warm solves run at, are then held
   bit-equal between the kernel and the plain version for each problem.

It prints a sha256 digest of the sources it runs (``source_digest``), a
``{"kernels": [...]}`` line, the card's name and power limit from
nvidia-smi, and last ``{"ok": true, "device": {...}}``. The problems are
built here, from a fixed recipe (no randomness).
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import statistics
import subprocess
import sys
import time

GIB = 2.0**30
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 non-tensor ops/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
EXPECTED_NODES = {"plain_50k_800": 444, "plain_5k_400": 171,
                  "topology_5k_400": 91}


def source_digest():
    """(sha256 hex, file count) over this script and the port package's
    Python and CUDA sources, in path order; computable without a card:
    ``python3 -c 'import chip_smoke; print(chip_smoke.source_digest())'``."""
    from pathlib import Path

    root = Path(__file__).resolve().parent
    pkg = root / "karpenter_core_tpu_torch"
    files = [root / "chip_smoke.py"] + sorted(
        p for p in pkg.rglob("*")
        if p.suffix in (".py", ".cu") and "build" not in p.parts)
    h = hashlib.sha256()
    for p in files:
        h.update(str(p.relative_to(root)).encode() + b"\0")
        h.update(p.read_bytes())
    return h.hexdigest(), len(files)


def _pool(name="default"):
    from karpenter_core_tpu_torch.api.nodepool import NodePool, NodePoolSpec
    from karpenter_core_tpu_torch.api.objects import ObjectMeta

    pool = NodePool(metadata=ObjectMeta(name=name))
    pool.spec = NodePoolSpec()
    return pool


def _plain_pods(n, shapes=(16, 12)):
    """Diverse cpu/mem shapes -> many pod classes (the bench's plain mix)."""
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


def _topology_pods(n, n_deploys=10):
    """The bench's diverse topology mix: 1/6 each generic, zonal node
    affinity, nodeSelector, zone spread, hostname spread, hostname
    anti-affinity, in deployment-style cohorts."""
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


def problems():
    """name -> (pods factory, catalog size, max_slots)."""
    return {
        "plain_50k_800": (lambda: _plain_pods(50_000), 800, 4096),
        "plain_5k_400": (lambda: _plain_pods(5000), 400, 2048),
        "topology_5k_400": (lambda: _topology_pods(5000), 400, 2048),
    }


def _selector(labels):
    from karpenter_core_tpu_torch.api.objects import LabelSelector

    return LabelSelector(match_labels=tuple(sorted(labels.items())))


def mixed_problem(seed):
    """A seeded small problem mixing every constraint family the scan
    handles: zone pins, node selectors, zone / hostname / capacity-type /
    arch spread (hard, soft and with minDomains), hostname anti-affinity,
    tolerations, sidecar containers, and existing nodes (some tainted)
    with partial free capacity. Returns (pool, catalog, existing, pods)."""
    import random

    from karpenter_core_tpu_torch.api import labels as L
    from karpenter_core_tpu_torch.api.objects import (
        CONTAINER_RESTART_ALWAYS,
        Affinity,
        Container,
        NodeAffinity,
        NodeSelectorRequirement,
        NodeSelectorTerm,
        ObjectMeta,
        Pod,
        PodAffinity,
        PodAffinityTerm,
        Taint,
        Toleration,
        TopologySpreadConstraint,
    )
    from karpenter_core_tpu_torch.cloudprovider.kwok import build_catalog
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (
        SimNode,
    )
    from karpenter_core_tpu_torch.utils.resources import pod_requests

    zones = ("zone-a", "zone-b", "zone-c")
    rng = random.Random(1000 + seed)

    def spread(key, app, when="DoNotSchedule", min_domains=None):
        return TopologySpreadConstraint(
            max_skew=1, topology_key=key, when_unsatisfiable=when,
            label_selector=_selector({"app": app}), min_domains=min_domains,
        )

    pods = []
    for i in range(rng.randint(30, 80)):
        cpu = rng.choice([0.1, 0.25, 0.5, 1.0, 2.0, 4.0])
        mem = rng.choice([0.25, 0.5, 1.0, 2.0])
        kind = rng.randrange(12)
        pod = Pod(metadata=ObjectMeta(name=f"m{seed}-{i}"),
                  resource_requests={"cpu": cpu, "memory": mem * GIB})
        if kind == 1:
            pod.affinity = Affinity(node_affinity=NodeAffinity(required=[
                NodeSelectorTerm(match_expressions=(NodeSelectorRequirement(
                    L.LABEL_TOPOLOGY_ZONE, "In",
                    tuple(rng.sample(zones, rng.randint(1, 2)))),)),
            ]))
        elif kind == 2:
            pod.node_selector = {L.LABEL_OS: "linux"}
        elif kind in (3, 4):
            pod.metadata.labels["app"] = "spread"
            key = L.LABEL_TOPOLOGY_ZONE if kind == 3 else L.LABEL_HOSTNAME
            pod.topology_spread_constraints = [spread(key, "spread")]
        elif kind == 5:
            pod.metadata.labels["app"] = "anti"
            pod.affinity = Affinity(pod_anti_affinity=PodAffinity(required=[
                PodAffinityTerm(topology_key=L.LABEL_HOSTNAME,
                                label_selector=_selector({"app": "anti"})),
            ]))
        elif kind == 6:
            pod.tolerations = [Toleration(key="batch", operator="Exists",
                                          effect="NoSchedule")]
        elif kind == 8:
            pod.metadata.labels["app"] = "ctspread"
            key = rng.choice([L.CAPACITY_TYPE_LABEL_KEY, L.LABEL_ARCH])
            pod.topology_spread_constraints = [spread(key, "ctspread")]
        elif kind == 9:
            pod.metadata.labels["app"] = "softspread"
            pod.topology_spread_constraints = [spread(
                L.LABEL_TOPOLOGY_ZONE, "softspread", when="ScheduleAnyway")]
        elif kind == 10:
            pod.metadata.labels["app"] = "mindom"
            pod.topology_spread_constraints = [spread(
                L.LABEL_TOPOLOGY_ZONE, "mindom",
                min_domains=rng.choice([2, 3]))]
        elif kind == 11:
            pod.containers = [Container(resource_requests={
                "cpu": cpu / 2, "memory": mem * GIB})]
            pod.init_containers = [Container(
                resource_requests={"cpu": cpu / 2},
                restart_policy=CONTAINER_RESTART_ALWAYS)]
            pod.resource_requests = pod_requests(pod)
        pods.append(pod)
    existing = []
    for i in range(rng.randint(0, 4)):
        zone = rng.choice(zones)
        cpu = rng.choice([4.0, 8.0, 16.0])
        existing.append(SimNode(
            name=f"exist-{i}",
            labels={
                L.LABEL_TOPOLOGY_ZONE: zone,
                L.LABEL_HOSTNAME: f"exist-{i}",
                L.LABEL_OS: "linux",
                L.LABEL_ARCH: "amd64",
                L.CAPACITY_TYPE_LABEL_KEY: "on-demand",
                L.NODEPOOL_LABEL_KEY: "default",
            },
            taints=([Taint(key="batch", effect="NoSchedule")]
                    if rng.random() < 0.3 else []),
            available={"cpu": cpu * rng.uniform(0.3, 1.0),
                       "memory": cpu * 2 * GIB, "pods": 110.0},
            capacity={"cpu": cpu, "memory": cpu * 2 * GIB, "pods": 110.0},
            initialized=True,
        ))
    pool = _pool()
    pool.spec.template.requirements = [
        NodeSelectorRequirement(L.LABEL_TOPOLOGY_ZONE, "In", zones)
    ]
    catalog = build_catalog(cpu_grid=[1, 2, 4, 8, 16], mem_factors=[2, 4])
    return pool, catalog, existing, pods


def scheduler(n_types, max_slots, kernel_backend="cuda"):
    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler

    pool = _pool()
    return DeviceScheduler(
        [pool], {pool.name: list(bench_catalog(n_types))},
        max_slots=max_slots, device="cuda", kernel_backend=kernel_backend,
    )


def first_request(sched, pods):
    """The port's prepared scan inputs for these pods: the first kernel
    request its solve generator yields."""
    gen = sched._solve_gen(pods)
    req = gen.send(None)
    gen.close()
    return req


@contextlib.contextmanager
def plain_forbidden():
    """Make the plain FFD step raise while the card path runs."""
    from karpenter_core_tpu_torch.ops import ffd

    def forbidden(*args, **kwargs):
        raise AssertionError("the plain FFD step ran on the card path")

    saved = ffd.ffd_step
    ffd.ffd_step = forbidden
    try:
        yield
    finally:
        ffd.ffd_step = saved


def hold_bit_equal(req, what):
    """Run one request's scan through the kernel and the plain version on
    the card; raise unless every plane is bit-equal. Returns the planes'
    largest absolute difference (0.0)."""
    import torch

    from karpenter_core_tpu_torch.ops import cuda_ffd, ffd

    args = (req.init_state, req.steps, req.statics, req.level_iters)
    kp = _planes(*cuda_ffd.cuda_ffd_solve(*args))
    pp = _planes(*ffd.ffd_solve(*args))
    torch.cuda.synchronize()
    bad = {k: n for k in kp if (n := _unequal(kp[k], pp[k]))}
    if bad:
        raise AssertionError(f"{what}: kernel != plain on {bad}")
    return max(_max_abs_err(kp[k], pp[k]) for k in kp)


def _planes(state, takes, unplaced):
    out = dict(state._asdict())
    out["takes"] = takes
    out["unplaced"] = unplaced
    return out


def _unequal(a, b):
    """Elements whose bits differ (float planes compared as int32 bits)."""
    import torch

    if a.dtype == b.dtype and a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def _max_abs_err(a, b):
    import torch

    if a.numel() == 0:
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def _time_ms(fn, reps):
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(req, state, takes, unplaced):
    """Least time of one scan on the card: the larger of the bytes that
    must move (every input read once, every output written once) over the
    HBM rate, and the float32 operations of the k_max evaluation this
    run's data needs (open slots x compatible instance types x 3R+2 per
    step) over the non-tensor float32 peak."""
    import torch

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in tree
                   if x is not None)

    moved = (nbytes(req.init_state) + nbytes(req.steps) + nbytes(req.statics)
             + nbytes(state) + takes.numel() * 4 + unplaced.numel() * 4)
    J, N = takes.shape
    R = req.init_state.requests.shape[1]
    kind0 = req.init_state.kind
    # a fresh slot opens at the first step that puts pods on it
    took = takes > 0
    first = torch.where(took.any(0), took.int().argmax(0),
                        torch.full((N,), J, device=takes.device))
    first = torch.where(kind0 > 0, torch.zeros_like(first), first)
    opened = torch.bincount(first.clamp(max=J), minlength=J + 1)[:J]
    open_before = torch.cumsum(opened, 0)  # open at the start of step j
    types = req.steps.class_it.sum(1)
    ops = float((open_before * types).sum()) * (3 * R + 2)
    t_bytes = moved / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase():
    """Kernel vs plain version on the port's prepared inputs."""
    import torch

    from karpenter_core_tpu_torch.ops import cuda_ffd, ffd

    rows = []
    for name in ("plain_50k_800", "topology_5k_400"):
        make, n_types, max_slots = problems()[name]
        req = first_request(scheduler(n_types, max_slots, "reference"),
                            make())
        args = (req.init_state, req.steps, req.statics, req.level_iters)
        err = hold_bit_equal(req, name)
        k_out = cuda_ffd.cuda_ffd_solve(*args)
        J = req.steps.count.shape[0]
        N, K, V = req.init_state.valmask.shape
        T = req.init_state.itmask.shape[1]
        ms = _time_ms(lambda: cuda_ffd.cuda_ffd_solve(*args), 10)
        plain_ms = _time_ms(lambda: ffd.ffd_solve(*args), 2)
        bound_ms, bound_by = _bound(req, *k_out)
        stages = _stage_profile(lambda: cuda_ffd.cuda_ffd_solve(*args), J)
        rows.append(dict(
            problem=name, J=J, N=N, T=T, K=K, V=V,
            unequal=0, max_abs_err=err,
            ms=ms, ms_per_step=ms / J, plain_ms=plain_ms,
            plain_ms_per_step=plain_ms / J,
            bound_ms=bound_ms, bound_by=bound_by, stage_us_per_step=stages,
        ))
        print(f"kernel vs plain [{name}] J={J} N={N} T={T} K={K} V={V}:"
              f" 0 unequal elements; scan {ms:.3f} ms ({ms / J * 1e3:.2f}"
              f" us/step) vs plain {plain_ms:.1f} ms; bound {bound_ms:.4f}"
              f" ms ({bound_by}); device us/step by stage"
              f" {json.dumps(stages)}", flush=True)

    # every constraint family and existing nodes, at small widths
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler

    steps = 0
    for seed in range(14):
        pool, catalog, existing, pods = mixed_problem(seed)
        req = first_request(DeviceScheduler(
            [pool], {pool.name: catalog}, existing_nodes=existing,
            max_slots=128, device="cuda", kernel_backend="reference",
        ), pods)
        hold_bit_equal(req, f"mixed seed {seed}")
        steps += req.steps.count.shape[0]
    print(f"kernel vs plain [mixed seeds 0-13, existing nodes in"
          f" {sum(1 for s in range(14) if mixed_problem(s)[2])}]: {steps}"
          " steps, 0 unequal elements", flush=True)
    return rows


def _stage_profile(fn, steps):
    """Device microseconds per step of each of the kernel's four stages,
    from one profiled scan (torch.profiler); None where the profiler
    recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for stage in ("k_prologue", "k_feasible", "k_decide", "k_merge"):
        total = 0.0
        for evt in prof.key_averages():
            if stage in evt.key:
                total += getattr(evt, "device_time_total",
                                 getattr(evt, "cuda_time_total", 0.0))
        out[stage] = total / steps if total else None
    return out


def _idle_share(fn):
    """1 - device busy time / wall time over one profiled warm solve
    (torch.profiler; kernels run on one stream, so their device times do
    not overlap). None when the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(
        getattr(evt, "self_device_time_total",
                getattr(evt, "self_cuda_time_total", 0.0))
        for evt in prof.key_averages()
    )
    return 1.0 - busy_us / wall_us if busy_us else None


def _canonical(res):
    """Claims, bindings and errors as a comparable tuple (hostname
    placeholders are per-process counters, so that key is left out)."""
    from karpenter_core_tpu_torch.api import labels as L

    claims = sorted(
        (
            tuple(p.name for p in c.pods),
            c.template.nodepool_name,
            tuple(sorted(it.name for it in c.instance_type_options)),
            tuple(sorted(c.requests.items())),
            tuple(
                (k, repr(c.requirements[k]))
                for k in sorted(c.requirements) if k != L.LABEL_HOSTNAME
            ),
        )
        for c in res.new_node_claims
    )
    bound = sorted(
        (s.name, tuple(p.name for p in s.pods)) for s in res.existing_nodes
    )
    return claims, bound, sorted(res.pod_errors.items())


def main_path_phase():
    import torch

    from karpenter_core_tpu_torch.metrics import wiring as m
    from karpenter_core_tpu_torch.ops import cuda_ffd

    rows = []
    launches = dict.fromkeys(cuda_ffd.KERNELS, 0)
    for name, (make, n_types, max_slots) in problems().items():
        sched = scheduler(n_types, max_slots)
        rejected0 = dict(m.SOLVER_RESULT_REJECTED.values)
        times, stats = [], []
        for rep in range(4):  # one cold solve, three warm
            pods = make()
            cuda_ffd.counter.reset()
            with plain_forbidden():
                t0 = time.perf_counter()
                res = sched.solve(pods)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            grew = dict(cuda_ffd.counter.launches)
            for k, n in grew.items():
                launches[k] += n
            st = dict(sched.last_phase_stats)
            stats.append(st)
            jps = {
                int(b["class_steps"].count.shape[0])
                for b in sched._batch_cache.values()
                if b.get("class_steps") is not None
            }
            idle_kernels = [k for k, n in grew.items() if n <= 0]
            if idle_kernels:
                raise AssertionError(
                    f"{name}: solve {rep} never launched {idle_kernels}")
            if len(jps) == 1:
                per_kernel = st["rounds"] * jps.pop()
                if set(grew.values()) != {per_kernel}:
                    raise AssertionError(
                        f"{name}: launches {grew} for {st['rounds']}"
                        f" dispatches of {per_kernel // st['rounds']} steps")
            if res.pod_errors:
                raise AssertionError(
                    f"{name}: {len(res.pod_errors)} pod errors")
            if res.node_count() != EXPECTED_NODES[name]:
                raise AssertionError(
                    f"{name}: {res.node_count()} nodes, expected"
                    f" {EXPECTED_NODES[name]}")
        with plain_forbidden():
            idle = _idle_share(lambda: sched.solve(make()))
        if dict(m.SOLVER_RESULT_REJECTED.values) != rejected0:
            raise AssertionError(f"{name}: the verifier rejected a result")
        ref = scheduler(n_types, max_slots, "reference").solve(make())
        if _canonical(ref) != _canonical(res):
            raise AssertionError(f"{name}: cuda result != reference result")
        warm = times[1:]
        last = stats[-1]
        # the kernel against the plain version at the warm slot width
        wreq = first_request(sched, make())
        wN = int(wreq.init_state.kind.shape[0])
        if wN != last["slots"]:
            raise AssertionError(
                f"{name}: warm request has {wN} slots, the warm solves"
                f" ran at {last['slots']}")
        hold_bit_equal(wreq, f"{name} warm")
        row = dict(
            problem=name, nodes=res.node_count(), cold_s=times[0],
            warm_p50_s=statistics.median(warm), warm_s=warm,
            launches_last_solve=grew,
            phases={k: last.get(k) for k in (
                "plan_s", "prepare_s", "kernel_s", "decode_s", "verify_s")},
            used_slots=last["used_slots"], rounds=last["rounds"],
            slots=last["slots"], device_idle_share=idle,
            warm_bit_equal=dict(N=wN, J=int(wreq.steps.count.shape[0])),
        )
        rows.append(row)
        print(f"main path [{name}]: {row['nodes']} nodes, 0 pod errors,"
              f" cold {times[0]:.3f} s, warm p50 {row['warm_p50_s']:.4f} s;"
              f" phases {json.dumps(row['phases'])}; used_slots"
              f" {row['used_slots']}, rounds {row['rounds']}; launches"
              f" {json.dumps(grew)}; device idle share {idle}; verifier"
              " rejections unmoved; equals reference; kernel bit-equal to"
              f" plain on the warm request (N={wN},"
              f" J={row['warm_bit_equal']['J']})", flush=True)
    return rows, launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is"
              " False)", file=sys.stderr)
        return 2
    try:
        from karpenter_core_tpu_torch.ops import cuda_ffd
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda};"
          f" device {torch.cuda.get_device_name(0)}; {smi}", flush=True)

    digest, n_files = source_digest()
    print(f"sources sha256 {digest} over {n_files} files", flush=True)

    # 2. build
    t0 = time.perf_counter()
    cuda_ffd.build()
    print(f"built {cuda_ffd.library_path().name} from"
          f" {cuda_ffd.SOURCE.relative_to(cuda_ffd.SOURCE.parents[2])} in"
          f" {time.perf_counter() - t0:.2f} s", flush=True)

    # 3. kernel against its plain version
    krows = kernel_phase()
    # 4. the main path
    mrows, launches = main_path_phase()

    k50 = krows[0]
    kernels = {"kernels": [{
        "name": "ffd_step",
        "route": "cuda",
        "source": "karpenter_core_tpu_torch/csrc/ffd_step.cu",
        "replaces": "karpenter_core_tpu/ops/pallas_ffd.py:135",
        "launches": sum(launches.values()),
        "launches_by_kernel": launches,
        "max_abs_err": max(r["max_abs_err"] for r in krows),
        "ms": k50["ms"],
        "plain_ms": k50["plain_ms"],
        "bound_ms": k50["bound_ms"],
        "bound_by": k50["bound_by"],
        "library_ms": None,
        "unequal": sum(r["unequal"] for r in krows),
        "ms_per_step": k50["ms_per_step"],
        "stage_us_per_step": k50["stage_us_per_step"],
        "plain_ms_per_step": k50["plain_ms_per_step"],
        "shapes": krows,
        "main_path": mrows,
    }]}
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
