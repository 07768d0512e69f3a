#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs a CUDA device and exits non-zero without one. Phases, each fatal
on failure:

1. device: torch and CUDA versions, the card's name and power limit;
2. build: compiles the FFD scan kernel from csrc/ffd_step.cu;
3. kernel against its plain version on the card, on the tensors the
   port's own prepare hands the scan at the 50k-pod x 800-type plain shape
   and the 5k-pod x 400-type topology shape: every plane of the final slot
   state, the takes and the unplaced counts must be bit-equal, on the full
   grid and on a grid forced down to 2 blocks; times the kernel's scan
   (the wrapper's pack and unpack passes of the requirement plane
   included, and timed alone) and the plain scan with CUDA events, and
   splits a step by stage from the kernel's own device clock stamps;
4. main path: ``DeviceScheduler(device="cuda").solve`` on the three bench
   problems (50k plain pods x 800 types, 5k plain x 400, 5k topology x
   400), one cold solve and three warm ones each, with the plain step
   made to raise if anything calls it. Node counts must be 444, 171 and
   91 with no pod errors (the JAX package's answers), the scan kernel must
   be launched once per dispatch of every solve (one launch a scan), the
   verifier's rejection counter must not move, and the
   result must equal the same solve through the plain version
   (``kernel_backend="reference"``). The scan inputs of a warm solve, at
   the adaptive slot width the warm solves run at, are then held
   bit-equal between the kernel and the plain version for each problem;
5. batched kernel: the fleet batch, 11 tenants with their own pool names
   over 400 types at 2048 slots (8 plain with 5000, 4900, ... 4300 pods, 3
   topology with 5000, 4900, 4800), grouped by the shape key of each
   tenant's first request (8 plain rows, 3 topology rows padded to 4). For
   each group the batched scan (``cuda_ffd_solve_batched``) must be
   bit-equal to the plain batched scan on every plane, each row bit-equal
   to the solo kernel scan of its request, and each pad row equal to row
   0, on the full grid and on 2 blocks; times the batched scan, the same
   requests' solo scans one after another, and the plain batched scan,
   and splits a step by stage from the stamps;
6. batched main path: ``solve_batch`` over the 11 tenants, one cold round,
   two warm and a warm one with the garbage collector off, with the
   plain step made to raise. Every tenant's node count must be the JAX
   package's (``FLEET_EXPECTED_NODES``) and its result the same as the
   tenant solved alone through the kernel (and, for the first tenant of
   each shape group, through the plain version);
   the cold round must batch at least 8 problems in one dispatch; no
   batched dispatch may fail (so none is retried solo); the kernel's
   launches must grow by one a scan and the problem rows counted by the
   scans' rows; the verifier's rejection counter must not move. The last
   round's batched scans, at the slot widths every warm round ran at, are
   then held bit-equal to the plain batched scan, row by row to the solo
   kernel, and pad rows to row 0. Times each round and splits its wall
   (the tenants' phase timers, the time inside their solve generators,
   the dispatches, the shape keys, the garbage collector's passes), times
   the tenants solved one after another, and the device idle share of a
   profiled warm round. The last round's results are freed, and the heap
   collected, before each timed round or pass starts;
7. consolidation sweep: multi-node consolidation's prefix sweep at
   BASELINE config 4 (2,000 nodes, 100 candidate prefixes, 400 types,
   2560 slots) through ``models/consolidation.frontier_core``, with the
   plain step made to raise: one kernel launch of 100 rows a sweep,
   through the sweep's entry (``cuda_ffd_solve_prefixes``, counted in
   ``counter.prefix_launches``), and the frontier equal to the JAX
   package's (``SWEEP_EXPECTED``). Its stacked scan (the slot state
   packed, the class steps and statics one copy shared by the rows) must
   be bit-equal to the plain batched scan on the full grid and on 2
   blocks, each row to the solo kernel, the final plane unpacked for the
   comparison, and the prepared state unchanged. Prints the packed and
   shared bytes against the old interface's, times the kernel's scan, the
   device sweep (stack, scan, verdicts) cold and warm, the plain scan and
   ``frontier_core``, splits a step by stage, gives three bounds (the
   scan's interface, the old stacked interface, the bytes the sweep
   needs), the peak device memory of one warm ``frontier_core`` and the
   device idle share of a profiled warm sweep;
8. operator: the port's ``Operator(Options(solver="tpu"))`` with its
   defaults (device cuda, kernel cuda) and the plain step made to raise,
   on 5,000 pending pods over 400 types and on a 100-node under-utilized
   fleet that multi-node consolidation sweeps over all 100 nodes. Each
   must bind every pod and end with the JAX operator's node count and cpu
   (``OPERATOR_EXPECTED``) and the same operator's through the plain
   version; the kernel must be launched once a provisioning scan and once
   (P rows) a sweep, every multi-node pass must get a frontier, and no
   reconcile error, verifier rejection or controller fault may be
   recorded, with ``readyz()`` true. The first sweep of each prefix count
   (B = 100, then B = 4) is kept at the kernel's boundary and held to the
   plain batched scan (full grid and 2 blocks, row by row to the solo
   kernel, its verdicts to the plain scan's), and every pass's frontier
   to the plain version's run, prefix by prefix. Times each scenario and
   splits its wall into solves, sweeps and the rest.

9. gangs and preemption: bench.py's cfg11_gangs recipe at its defaults
   (20,000 pods: 2,000 system-critical pods of 6 cpu that place only by
   evicting tier-0 victims, 375 gangs of 8, the rest plain; 80 existing
   nodes with four victims each; ``cpu_grid=[1, 2, 4]``, 4096 slots) plus
   16 gangs of 8 whose 4 members of 6 cpu cannot place, so every solve
   rolls a gang back. One cold and two warm solves through
   ``DeviceScheduler(device="cuda")`` with the plain step made to raise:
   each must give the JAX package's node count, evicted-uid set, gangs
   placed, unschedulable count and result digest (``GANGS_EXPECTED``),
   no partially placed gang, no verifier rejection, and exactly two
   kernel launches (the gang dispatch's two scans). A further warm solve
   times the gang dispatch's first scan, failure check (its one host
   read), second scan and guard, and the preemption pass apart. Both
   scans' inputs are held bit-equal to the plain scan on the full grid
   and on 2 blocks. Then four
   same-shaped tenants (the recipe at 5,000 pods, their own pool names)
   through ``solve_batch``: one batched gang dispatch of 4 rows (two
   launches) and one batched preemption pass, each tenant equal to its
   solo solve and to the JAX package's node count
   (``GANG_TENANTS_EXPECTED``);
10. rack-aware gangs: bench.py's cfg18_topoaware recipe at its defaults
   (40 ranked gangs of 8 at 3 cpu with ``pod-group-max-hops: 2``, 2,000
   plain pods, 168 existing nodes with rack and superpod labels,
   ``cpu_grid=[1, 2]``). One cold and three warm solves, each equal to
   the JAX package's node count, worst intra-gang hop count, gangs placed
   and digest (``TOPO_EXPECTED``) and to the plain version's; the
   ``topo_rank`` scan bit-equal to the plain scan on the full grid and on
   2 blocks, and batched (two rows, one with the levels reversed) to the
   plain batched scan and row by row to the solo kernel.

11. relax: bench.py's cfg12_relax recipe (``_relax_bench``) at its
   defaults: 5,000 pods of the cfg3 shape (the topology mix) and of the
   cfg11 shape (15% in gangs of 8, 10% at priority 1e6) over two pools
   (``a-first``, 4-cpu nodes; ``b-dense``, 16-cpu nodes at 0.75x the
   price), 4096 slots. In each mode (ffd, relax) one scheduler makes a
   cold, a settle and three warm solves with the plain step made to
   raise; each must give the JAX package's nodes, cost, unschedulable
   count, relax outcome, template moves and result digest
   (``RELAX_EXPECTED``), and make the dispatches its outcome calls for: a
   cold relax solve its baseline scan, the relax_choose dispatch and the
   candidate scan, a verdict-cached warm solve one scan; every scan one
   kernel launch (two for a gang rollback). The plain version's cold relax
   solve must give the same answer. The candidate scan's inputs are held
   bit-equal to the plain scan on the full grid and on 2 blocks (its
   rollback scan too), ``relax_choose``'s integral outputs on the card
   equal to the CPU's on the same planes (the iterates' drift printed),
   and both are timed. Then two tenants of each problem through
   ``solve_batch``: a batched relax_choose and batched baseline and
   candidate scans for each pair, each tenant equal to its solo cold
   solve and each batched choose row to its solo choose. The verdicts'
   cost margins |cost_r - cost_f| / cost_f are printed;
12. solverd: a ``SolverDaemon`` in this process (device cuda, kernel
   cuda, the CLI's gateway defaults) on a loopback port answers
   ``RemoteScheduler`` solves of plain_5k_400, topology_5k_400 and phase
   11's relax cfg3 shape: each answer's wire must equal the in-process
   ``DeviceScheduler``'s (solve_seconds aside), with kernel launches in
   the daemon, no failed RPC and no client-side verifier rejection (a
   sidecar solve without a verified answer raises; nothing falls back);
   the RPC and in-process walls are printed. The fleet batch's 11
   tenants then reach it at once: each must get the JAX package's node
   count and the gateway must coalesce at least 2 problems. Last, the
   operator with ``solver_mode="sidecar"`` spawns the port's
   ``solver.service`` on the card and provisions phase 8's 5,000 pods to
   ``OPERATOR_EXPECTED``, with no reconcile error, controller fault or
   failed RPC and ``readyz()`` true; the sidecar stops with it.
13. entry points and the twin: (a) the binary, ``python -m
   karpenter_core_tpu_torch.main --solver tpu --max-iters 3 --health-port
   -1 --poll-interval 0.5``, must answer ``/healthz``, ``/readyz`` and
   ``/metrics`` with 200 at the address it logs while it runs, and exit 0
   with no traceback; (b) the operator over HTTP: the port's
   ``kube.httpserver`` in a child process, the pool and the first
   ``HTTP_PODS`` pods of plain_5k_400's mix created through the port's
   ``HttpKubeClient``, ``Operator(kube=HttpKubeClient(...),
   options=Options(solver="tpu"))`` run until idle with the plain step
   made to raise: a second client must read back every pod bound and the
   JAX operator's node count and cpu over HTTP (``HTTP_EXPECTED``), one
   launch a provisioning scan, no reconcile error, controller fault or
   verifier rejection, ``readyz()`` true; (c) the twin in process on the
   reference's macro scenario (2 clusters, 1,890 pods in 8 waves, 8
   virtual hours at 600-s ticks, ``solver="tpu"``) with the plain step
   made to raise: 0 violations, no greedy fallback, its ledger JSON the
   JAX twin's (``TWIN_EXPECTED``), trace and ledger equal to the run with
   ``kernel="reference"``, one launch a scan and one a sweep, all on the
   operators' thread; the device idle share of a profiled run; (d) the
   twin over its in-thread solverd tier: the storm fleet scenario (fleet
   2, delta wire, ICE storm, kube and cloud chaos, amnesia at 90 s, the
   murder of member 1 at 120 s, a 60-s partition of cluster 0 at 180 s)
   twice through the kernel and once with ``kernel="reference"``: each
   with 0 violations, no greedy fallback, failed RPCs counted, member
   solves, every pod bound, launches only in the daemons' threads; the
   three traces and ledgers byte-identical. Then the elastic scenario
   once: 0 violations, the tier grows and shrinks on the one card.
14. multi-device solves and the spawned fleet: (a) ``DeviceScheduler(
   devices=0)`` and ``devices=8`` resolve to the one card and solve
   plain_5k_400 with the wire of devices=1; (b) the config-4 sweep through
   ``frontier_core`` on virtual meshes of 2, 3 and 4 shards over the card
   (``parallel/mesh.force_virtual_mesh``; 3 shards pad the 100 prefixes
   to 102): the frontier ``SWEEP_EXPECTED`` and the one-device one, one
   launch a shard over the padded prefixes, each shard's rows bit-equal
   to the single launch over the same stack on the full grid and on 2
   blocks, one shard to the plain batched scan; each shard's scan time,
   stacked bytes and bound, and the sweep's wall at 1-4 shards (shards
   that share one card, not a multi-GPU time); (c) the fleet batch
   through ``solve_batch`` at devices 1, 2 and 4: ``FLEET_EXPECTED_NODES``
   and the one-device result for every tenant, one launch a shard of each
   batched dispatch, the largest stack's shards each bit-equal to its
   single launch and the last to the plain batched scan; plain_50k_800 at devices=4 and plain_5k_400 at
   devices=3 (slot width padded to 2049, held bit-equal to the plain
   scan) with the wire and slot stats of devices=1; (d) the operator with
   ``solver_fleet=2`` spawns two solverd members on the card and
   provisions phase 8's pods to ``OPERATOR_EXPECTED``; the fleet's 11
   tenants through its ``FleetRouter`` at once, each the JAX package's
   node count, both members launching the kernel (their ``/healthz``);
   ``FleetSupervisor.add_member`` spawns a third that answers plain_5k_400
   as the in-process solve, and ``retire_member`` drains it with the drain
   exit code. Spawn-to-ready times, members' device memory and the RPC
   against the in-process wall are printed; every member stops.

15. the port's answer check: ``python3 bench_torch.py`` in a child process
   under ``BENCH_FAST=1`` (bench.py's fast sizes: the primary at 50,000
   pods x 800 types, the small cfg10-cfg18), its last line parsed: the
   device block must name the card (``platform`` gpu, nvidia-smi's name),
   every config must be ``correct`` (the JAX package's answers at these
   sizes), every ``phases`` block must say ``cuda`` (``reference`` on
   cfg17's plain side, which launches nothing), every kernel-driven config
   must count kernel launches, and the exit code must be 0. Then cfg7
   (``bench_fleet``), which BENCH_FAST's set leaves out, in this process.
16. a real device fault, in child processes (``fault_phase``): (a) the
   binary (``python -m karpenter_core_tpu_torch.main --solver tpu``, in
   process, on cuda) over the HTTP apiserver with plain_5k_400's first
   ``FAULT_PODS`` pods pending; its entry point (``chip_smoke.py
   --fault-child``) makes the first provisioning solve raise a real
   device-side assert at the kernel seam. The child must log the sticky
   error, answer /healthz 503 and exit ``DEVICE_FAULT_EXIT_CODE`` within
   ``FAULT_EXIT_BOUND_S``, having bound nothing; the same command
   respawned must bind every pod with the JAX operator's node count and
   cpu (``FAULT_EXPECTED``) and exit 0 on SIGINT. (b) The same fault in a
   spawned solverd member: the solve fails, the member exits
   ``WATCHDOG_EXIT_CODE``, the supervisor respawns it, and the respawn's
   wire equals the in-process solve's. Prints one ``device_fault`` line
   (exit codes, seconds to exit, seconds to a ready respawn, pods bound,
   node count).

It prints a sha256 digest of the sources it runs (``source_digest``), a
``{"kernels": [...]}`` line, the card's name and power limit from
nvidia-smi, and last ``{"ok": true, "device": {...}}``. The problems are
built from fixed recipes (no randomness), the bench's shared with
``bench_torch.py``, the answer check. ``fleet_expected.py``
computes ``FLEET_EXPECTED_NODES``, ``SWEEP_EXPECTED``,
``OPERATOR_EXPECTED``, ``GANGS_EXPECTED``, ``GANG_TENANTS_EXPECTED``,
``TOPO_EXPECTED``, ``RELAX_EXPECTED``, ``HTTP_EXPECTED`` and
``TWIN_EXPECTED`` with the JAX package on the CPU;
tests/test_torch_device_fault.py holds ``FAULT_EXPECTED`` to it.
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import statistics
import subprocess
import sys
import time

# the bench's recipes, one copy for the port's answer check and this smoke
from bench_torch import (  # noqa: F401
    _gang_tier_pods,
    _plain_pods,
    _pool,
    _relax_world as relax_world,
    _result_cost as result_cost,
    _topology_pods,
)

GIB = 2.0**30
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 non-tensor ops/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
EXPECTED_NODES = {"plain_50k_800": 444, "plain_5k_400": 171,
                  "topology_5k_400": 91}


def source_digest():
    """(sha256 hex, file count) over this script, the port's answer check
    (``bench_torch.py``) and the port package's Python and CUDA sources, in
    path order; computable without a card:
    ``python3 -c 'import chip_smoke; print(chip_smoke.source_digest())'``."""
    from pathlib import Path

    root = Path(__file__).resolve().parent
    pkg = root / "karpenter_core_tpu_torch"
    files = [root / "chip_smoke.py", root / "bench_torch.py"] + sorted(
        p for p in pkg.rglob("*")
        if p.suffix in (".py", ".cu") and "build" not in p.parts)
    h = hashlib.sha256()
    for p in files:
        h.update(str(p.relative_to(root)).encode() + b"\0")
        h.update(p.read_bytes())
    return h.hexdigest(), len(files)


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


def scheduler(n_types, max_slots, kernel_backend="cuda", pool="default"):
    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler

    pool = _pool(pool)
    return DeviceScheduler(
        [pool], {pool.name: list(bench_catalog(n_types))},
        max_slots=max_slots, device="cuda", kernel_backend=kernel_backend,
    )


def fleet():
    """tenant -> (pods factory, pod count): the fleet batch of the batched
    phases, each tenant with its own pool name over bench_catalog(400) at
    max_slots=2048 (the widths of plain_5k_400 and topology_5k_400). Pod
    counts differ per tenant, so a kernel that mixes up problems cannot
    pass."""
    out = {f"fleet-plain-{i}": (lambda i=i: _plain_pods(5000 - 100 * i),
                                5000 - 100 * i) for i in range(8)}
    out.update({f"fleet-topo-{i}": (lambda i=i: _topology_pods(5000 - 100 * i),
                                    5000 - 100 * i) for i in range(3)})
    return out


FLEET_TYPES, FLEET_SLOTS = 400, 2048
# the JAX package's node count for each fleet tenant (its DeviceScheduler,
# xla backend, each tenant solved alone and all 11 through its solve_batch,
# on the CPU): ``JAX_PLATFORMS=cpu python3 fleet_expected.py`` prints them
FLEET_EXPECTED_NODES = {
    "fleet-plain-0": 171, "fleet-plain-1": 168, "fleet-plain-2": 164,
    "fleet-plain-3": 161, "fleet-plain-4": 157, "fleet-plain-5": 154,
    "fleet-plain-6": 151, "fleet-plain-7": 147,
    "fleet-topo-0": 91, "fleet-topo-1": 89, "fleet-topo-2": 87,
}
# how the tenants' first requests group by shape key
FLEET_GROUPS = [[f"fleet-plain-{i}" for i in range(8)],
                [f"fleet-topo-{i}" for i in range(3)]]


def fleet_scheduler(name, kernel_backend="cuda"):
    return scheduler(FLEET_TYPES, FLEET_SLOTS, kernel_backend, pool=name)


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


def hold_bit_equal(req, what, grids=(0,)):
    """Run one request's scan through the kernel, once for each grid cap in
    ``grids`` (0: the full grid), and once through the plain version on the
    card; raise unless every plane is bit-equal. Returns (the planes'
    largest absolute difference (0.0), plain scan ms)."""
    from karpenter_core_tpu_torch.ops import cuda_ffd, ffd

    args = (req.init_state, req.steps, req.statics, req.level_iters)
    p_out, plain_ms = _time_once(lambda: ffd.ffd_solve(*args))
    pp = _planes(*p_out)
    err = 0.0
    for grid in grids:
        kp = _planes(*cuda_ffd.cuda_ffd_solve(*args, _max_blocks=grid))
        bad = {k: n for k in kp if (n := _unequal(kp[k], pp[k]))}
        if bad:
            raise AssertionError(f"{what} (grid cap {grid}, blocks"
                                 f" {cuda_ffd.counter.blocks}): kernel !="
                                 f" plain on {bad}")
        err = max(err, max(_max_abs_err(kp[k], pp[k]) for k in kp))
    return err, plain_ms


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
    return _bound_ms([_bound_terms(req.init_state, req.steps, req.statics,
                                   state, takes, unplaced)])


def _bound_batched(init, steps, statics, state, takes, unplaced):
    """``_bound`` of a batched scan: bytes and operations summed over its
    problem rows (pad rows included: the kernel computes them)."""
    return _bound_ms(_batched_terms(init, steps, statics, state, takes,
                                    unplaced))


def _batched_terms(init, steps, statics, state, takes, unplaced):
    """``_bound_terms`` of each problem row of a batched scan."""
    from karpenter_core_tpu_torch.ops.ffd import _row

    return [_bound_terms(_row(init, b), _row(steps, b), _row(statics, b),
                         _row(state, b), takes[b], unplaced[b])
            for b in range(takes.shape[0])]


def _bound_ms(terms):
    moved = sum(t[0] for t in terms)
    ops = sum(t[1] for t in terms)
    t_bytes = moved / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bound_terms(init_state, steps, statics, state, takes, unplaced):
    """(bytes moved, float32 operations) of one problem's scan."""
    import torch

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in tree
                   if x is not None)

    moved = (nbytes(init_state) + nbytes(steps) + nbytes(statics)
             + nbytes(state) + takes.numel() * 4 + unplaced.numel() * 4)
    J, N = takes.shape
    R = init_state.requests.shape[1]
    kind0 = init_state.kind
    # a fresh slot opens at the first step that puts pods on it
    took = takes > 0
    first = torch.where(took.any(0), took.int().argmax(0),
                        torch.full((N,), J, device=takes.device))
    first = torch.where(kind0 > 0, torch.zeros_like(first), first)
    opened = torch.bincount(first.clamp(max=J), minlength=J + 1)[:J]
    open_before = torch.cumsum(opened, 0)  # open at the start of step j
    types = steps.class_it.sum(1)
    ops = float((open_before * types).sum()) * (3 * R + 2)
    return moved, ops


def kernel_phase():
    """Kernel vs plain version on the port's prepared inputs."""
    import torch

    from karpenter_core_tpu_torch.ops import cuda_ffd

    rows = []
    for name in ("plain_50k_800", "topology_5k_400"):
        make, n_types, max_slots = problems()[name]
        req = first_request(scheduler(n_types, max_slots, "reference"),
                            make())
        args = (req.init_state, req.steps, req.statics, req.level_iters)
        # the plain scan is timed once, by CUDA events, in this check; the
        # kernel runs on the full grid and on 2 blocks
        err, plain_ms = hold_bit_equal(req, name, grids=(0, 2))
        k_out = cuda_ffd.cuda_ffd_solve(*args)
        blocks = cuda_ffd.counter.blocks
        J = req.steps.count.shape[0]
        N, K, V = req.init_state.valmask.shape
        T = req.init_state.itmask.shape[1]
        ms = _time_ms(lambda: cuda_ffd.cuda_ffd_solve(*args), 10)
        bound_ms, bound_by = _bound(req, *k_out)
        stages = _stage_stamps(
            lambda st: cuda_ffd.cuda_ffd_solve(*args, _stamps=st), J)
        # the wrapper's two passes around the launch (in ms above): the
        # plane packed for the kernel, and the final plane unpacked
        vm = req.init_state.valmask
        packed = cuda_ffd.pack_values(vm)
        pack_ms = _time_ms(lambda: cuda_ffd.pack_values(vm), 50)
        unpack_ms = _time_ms(lambda: cuda_ffd.unpack_values(packed), 50)
        rows.append(dict(
            problem=name, J=J, N=N, T=T, K=K, V=V, blocks=blocks,
            unequal=0, max_abs_err=err,
            ms=ms, ms_per_step=ms / J, plain_ms=plain_ms,
            plain_ms_per_step=plain_ms / J,
            bound_ms=bound_ms, bound_by=bound_by, stage_us_per_step=stages,
            pack_ms=pack_ms, unpack_ms=unpack_ms,
        ))
        print(f"kernel vs plain [{name}] J={J} N={N} T={T} K={K} V={V}:"
              f" 0 unequal elements on {blocks} blocks and on 2; scan"
              f" {ms:.3f} ms ({ms / J * 1e3:.2f} us/step; the wrapper's"
              f" pack {pack_ms:.4f} ms and unpack {unpack_ms:.4f} ms"
              f" included) vs plain {plain_ms:.1f} ms; bound"
              f" {bound_ms:.4f} ms ({bound_by}); device us/step by stage"
              f" (stamps) {json.dumps(stages)}", flush=True)

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


STAGES = ("prologue", "feasibility", "decisions", "merge")


def _stage_stamps(fn, steps):
    """Device microseconds per step of each of the scan's four stages, each
    up to and through the grid barrier that ends it, and of the whole step:
    means over the steps of one scan, from the device clock (%globaltimer)
    that the kernel writes into a [J, 5] stamp buffer (``fn(stamps)`` runs
    the scan)."""
    import torch

    stamps = torch.zeros((steps, 5), dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    fn(stamps)
    torch.cuda.synchronize()
    d = stamps.diff(dim=1).double().mean(0) / 1e3
    out = {name: float(d[i]) for i, name in enumerate(STAGES)}
    out["step"] = float((stamps[:, 4] - stamps[:, 0]).double().mean() / 1e3)
    return out


def _idle_share(fn, cpu=True):
    """1 - device busy time / wall time over one profiled warm solve
    (torch.profiler; kernels run on one stream, so their device times do
    not overlap). None when the profiler recorded no device time.
    ``cpu=False`` traces the device only: a long host-bound run (the twin)
    spends most of a CPU trace recording its host ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    busy_us = sum(
        getattr(evt, "self_device_time_total",
                getattr(evt, "self_cuda_time_total", 0.0))
        for evt in events
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
            # one scan, so one launch and one problem row, per dispatch
            if (grew != dict.fromkeys(cuda_ffd.KERNELS, st["rounds"])
                    or cuda_ffd.counter.rows != st["rounds"]
                    or st["rounds"] < 1):
                raise AssertionError(
                    f"{name}: solve {rep} launched {grew} over"
                    f" {cuda_ffd.counter.rows} rows for {st['rounds']}"
                    " dispatches")
            if res.pod_errors:
                raise AssertionError(
                    f"{name}: {len(res.pod_errors)} pod errors")
            if res.node_count() != EXPECTED_NODES[name]:
                raise AssertionError(
                    f"{name}: {res.node_count()} nodes, expected"
                    f" {EXPECTED_NODES[name]}")
        with plain_forbidden():
            idle = _idle_share(lambda: sched.solve(make()), cpu=False)
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


def _copy(tree):
    return type(tree)(*(None if x is None else x.clone() for x in tree))


def _key_digest(key):
    return hashlib.sha256(repr(key).encode()).hexdigest()[:12]


def _time_once(fn):
    """(result, device ms) of one call, by CUDA events."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def fleet_groups(reqs):
    """Group the tenants' requests by shape key, as solve_batch does; raise
    unless they group as FLEET_GROUPS."""
    groups = {}
    for name, req in reqs.items():
        groups.setdefault(req.shape_key(), []).append(name)
    for key, names in groups.items():
        print(f"shape key {_key_digest(key)}: {names}", flush=True)
    if sorted(groups.values()) != sorted(FLEET_GROUPS):
        raise AssertionError(f"fleet grouped as {list(groups.values())},"
                             f" expected {FLEET_GROUPS}")
    return list(groups.values())


def hold_batched_bit_equal(state, steps, statics, li, names, grids=(0,),
                           scan=None):
    """Run a stacked scan through the batched kernel (on a copy of the
    state, which it updates in place), once for each grid cap in ``grids``
    (0: the full grid), and through the plain batched scan on the card;
    raise unless every plane is bit-equal, row b is bit-equal to the solo
    kernel's scan of row b for each member ``names[b]``, and each pad row
    past the members equals row 0. ``scan`` is the kernel's entry
    (``cuda_ffd_solve_batched`` by default; the sweep's packed stack runs
    through ``cuda_ffd_solve_prefixes``); a packed final plane is
    unpacked for the comparisons. Returns (the full grid's kernel outputs
    as the entry gave them; the planes' largest absolute difference (0.0);
    plain scan ms)."""
    from karpenter_core_tpu_torch.ops import cuda_ffd, ffd
    from karpenter_core_tpu_torch.ops.ffd import _row

    scan = scan or cuda_ffd.cuda_ffd_solve_batched
    plain_state = cuda_ffd.unpack_state(state)
    p_out, plain_ms = _time_once(
        lambda: ffd.ffd_solve_batched(plain_state, steps, statics, li))
    pb = _planes(*p_out)
    err = 0.0
    for grid in grids:
        out = scan(_copy(state), steps, statics, li, _max_blocks=grid)
        kg = _planes(cuda_ffd.unpack_state(out[0]), *out[1:])
        bad = {k: n for k in kg if (n := _unequal(kg[k], pb[k]))}
        if bad:
            raise AssertionError(f"{names} (grid cap {grid}, blocks"
                                 f" {cuda_ffd.counter.blocks}): batched"
                                 f" kernel != plain on {bad}")
        err = max(err, max(_max_abs_err(kg[k], pb[k]) for k in kg))
        if grid == grids[0]:
            k_out, kb = out, kg
    for b, name in enumerate(names):
        sp = _planes(*cuda_ffd.cuda_ffd_solve(
            _row(plain_state, b), _row(steps, b), _row(statics, b), li))
        bad = {k: n for k in sp if (n := _unequal(kb[k][b], sp[k]))}
        if bad:
            raise AssertionError(f"{name}: batched row != solo kernel on {bad}")
    for b in range(len(names), int(state.kind.shape[0])):
        bad = {k: n for k in kb if (n := _unequal(kb[k][b], kb[k][0]))}
        if bad:
            raise AssertionError(f"pad row {b} != row 0 on {bad}")
    return k_out, err, plain_ms


def batched_kernel_phase():
    """The batched kernel on the fleet batch's stacked requests, held
    bit-equal to the plain batched scan, row by row to the solo kernel, and
    pad rows to row 0; timed against the same requests' solo scans."""
    from karpenter_core_tpu_torch.models.provisioner import (
        _BATCH_PAD_LO,
        _bucket,
        _stack_trees,
    )
    from karpenter_core_tpu_torch.ops import cuda_ffd

    reqs = {name: first_request(fleet_scheduler(name, "reference"), make())
            for name, (make, _n) in fleet().items()}
    rows = []
    for names in fleet_groups(reqs):
        rs = [reqs[n] for n in names]
        B = len(rs)
        Bp = _bucket(B, lo=_BATCH_PAD_LO)
        rs_p = rs + [rs[0]] * (Bp - B)
        state = _stack_trees([r.init_state for r in rs_p])
        steps = _stack_trees([r.steps for r in rs_p])
        statics = _stack_trees([r.statics for r in rs_p])
        li = rs[0].level_iters
        J = int(steps.count.shape[1])
        N = int(state.kind.shape[1])

        def batched():  # the kernel updates its state in place: a copy
            return cuda_ffd.cuda_ffd_solve_batched(_copy(state), steps,
                                                   statics, li)

        k_out, err, plain_ms = hold_batched_bit_equal(state, steps, statics,
                                                      li, names, (0, 2))
        blocks = cuda_ffd.counter.blocks
        ms = _time_ms(batched, 10)
        solo_ms = _time_ms(
            lambda: [cuda_ffd.cuda_ffd_solve(r.init_state, r.steps,
                                             r.statics, li) for r in rs], 5)
        bound_ms, bound_by = _bound_batched(state, steps, statics, *k_out)
        stages = _stage_stamps(
            lambda st: cuda_ffd.cuda_ffd_solve_batched(
                _copy(state), steps, statics, li, _stamps=st), J)
        row = dict(
            tenants=names, B=B, Bp=Bp, J=J, N=N,
            T=int(state.itmask.shape[2]), blocks=blocks, unequal=0,
            max_abs_err=err, ms=ms, ms_per_step=ms / J, solo_sum_ms=solo_ms,
            solo_sum_ms_per_step=solo_ms / J, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, stage_us_per_step=stages,
        )
        rows.append(row)
        print(f"batched kernel [{names[0]}..{names[-1]}] B={B} Bp={Bp} J={J}"
              f" N={N}: 0 unequal elements against the plain batched scan"
              f" on {blocks} blocks and on 2, each row equal to its solo"
              f" kernel scan, pad rows equal to row 0; scan {ms:.3f} ms"
              f" ({ms / J * 1e3:.2f} us/step) vs {B} solo scans"
              f" {solo_ms:.3f} ms vs plain {plain_ms:.1f} ms; bound"
              f" {bound_ms:.4f} ms ({bound_by}); device us/step by stage"
              f" (stamps) {json.dumps(stages)}", flush=True)
    return rows


@contextlib.contextmanager
def dispatch_spy():
    """Record what solve_batch does: its batched dispatches (and whether
    one raised), its solo ones, the (rows, steps) of each scan the kernel
    wrappers take, and the seconds spent in the dispatches, in the shape
    keys and in the garbage collector's passes (``gc.callbacks``), with the
    passes counted by generation. While ``log["capture"]`` is true, each
    batched scan's inputs are kept, its state copied before the kernel
    updates it, with the names the requests were tagged with
    (``_instrument``). Calls straight through and counts no launch."""
    from karpenter_core_tpu_torch.models import provisioner as prov
    from karpenter_core_tpu_torch.ops import cuda_ffd

    log = dict(batched=0, batched_failed=0, solo=0, scans=[], padded=[],
               dispatch_s=0.0, key_s=0.0, gen_s=0.0, gc_s=0.0,
               gc_passes=[0, 0, 0], capture=False, captured=[], names=None)
    run_b, run_1 = prov._run_kernel_batched, prov._run_kernel_solo
    scan_b, scan_1 = cuda_ffd.cuda_ffd_solve_batched, cuda_ffd.cuda_ffd_solve
    key = prov._KernelRequest.shape_key
    gc_t0 = [0.0]

    def batched(reqs):
        log["batched"] += 1
        log["names"] = [getattr(r, "tenant", None) for r in reqs]
        t0 = time.perf_counter()
        try:
            outs, padded = run_b(reqs)
        except Exception:
            log["batched_failed"] += 1
            raise
        finally:
            log["dispatch_s"] += time.perf_counter() - t0
        log["padded"].append(padded)
        return outs, padded

    def solo(req):
        log["solo"] += 1
        t0 = time.perf_counter()
        try:
            return run_1(req)
        finally:
            log["dispatch_s"] += time.perf_counter() - t0

    def kernel_b(state, steps, statics, level_iters):
        log["scans"].append((int(state.kind.shape[0]),
                             int(steps.count.shape[1])))
        if log["capture"]:
            log["captured"].append((log["names"], _copy(state), steps,
                                    statics, level_iters))
        return scan_b(state, steps, statics, level_iters)

    def kernel_1(state, steps, *args, **kwargs):
        log["scans"].append((1, int(steps.count.shape[0])))
        return scan_1(state, steps, *args, **kwargs)

    def shape_key(req):
        t0 = time.perf_counter()
        try:
            return key(req)
        finally:
            log["key_s"] += time.perf_counter() - t0

    def gc_pass(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            log["gc_s"] += time.perf_counter() - gc_t0[0]
            log["gc_passes"][info["generation"]] += 1

    prov._run_kernel_batched, prov._run_kernel_solo = batched, solo
    cuda_ffd.cuda_ffd_solve_batched, cuda_ffd.cuda_ffd_solve = (
        kernel_b, kernel_1)
    prov._KernelRequest.shape_key = shape_key
    gc.callbacks.append(gc_pass)
    try:
        yield log
    finally:
        gc.callbacks.remove(gc_pass)
        prov._KernelRequest.shape_key = key
        prov._run_kernel_batched, prov._run_kernel_solo = run_b, run_1
        cuda_ffd.cuda_ffd_solve_batched, cuda_ffd.cuda_ffd_solve = (
            scan_b, scan_1)


def _instrument(sched, name, log):
    """Wrap a scheduler's solve generator: tag each kernel request it
    yields with the tenant's name, and add the seconds spent inside the
    generator (its host phases and everything between them) to
    ``log["gen_s"]``."""
    solve_gen = sched._solve_gen

    def gen(pods):
        inner = solve_gen(pods)
        step, arg = inner.send, None
        while True:
            t0 = time.perf_counter()
            try:
                req = step(arg)
            except StopIteration as stop:
                return stop.value
            finally:
                log["gen_s"] += time.perf_counter() - t0
            req.tenant = name
            try:
                step, arg = inner.send, (yield req)
            except Exception as e:  # a failed dispatch, thrown in
                step, arg = inner.throw, e

    sched._solve_gen = gen


def _split(log, before):
    """The seconds and garbage collector passes that ``log`` gained since
    the copy ``before``."""
    out = {k: log[k] - before[k]
           for k in ("gen_s", "dispatch_s", "key_s", "gc_s")}
    out["gc_passes"] = [a - b for a, b in zip(log["gc_passes"],
                                              before["gc_passes"])]
    return out


def batched_main_path_phase():
    """``solve_batch`` over the fleet's 11 tenants on the card: one cold,
    two warm rounds and a warm round with the garbage collector off, held
    to the JAX package's node counts and to each tenant solved alone
    through the kernel (the first of each shape group also through the
    plain version), with every launch and
    problem row accounted for and no solo retry; then the last round's
    batched scans held bit-equal to the plain batched scan at the warm
    slot widths."""
    import torch

    from karpenter_core_tpu_torch.metrics import wiring as m
    from karpenter_core_tpu_torch.models.provisioner import solve_batch
    from karpenter_core_tpu_torch.ops import cuda_ffd

    tenants = fleet()
    total_pods = sum(n for _make, n in tenants.values())
    rejected0 = dict(m.SOLVER_RESULT_REJECTED.values)
    with dispatch_spy() as log:
        # the tenants solved alone, one after another, through the kernel:
        # a cold pass and a warm one before the batched rounds, a warm pass
        # after them
        alone = {n: fleet_scheduler(n) for n in tenants}
        expected = {}

        def one_by_one():
            pods = {n: make() for n, (make, _k) in tenants.items()}
            gc.collect()  # each timed window starts from a collected heap
            before = {k: (list(v) if isinstance(v, list) else v)
                      for k, v in log.items()}
            with plain_forbidden():
                t0 = time.perf_counter()
                res = {n: alone[n].solve(pods[n]) for n in tenants}
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            for n, r in res.items():
                expected.setdefault(n, _canonical(r))
                if _canonical(r) != expected[n] or r.pod_errors:
                    raise AssertionError(f"{n}: a warm solve alone changed")
            phases = _phase_sums(alone.values())
            split = _split(log, before)
            return dict(wall_s=wall, phases=phases,
                        outside_s=wall - sum(phases.values()),
                        gc_s=split["gc_s"], gc_passes=split["gc_passes"])

        seq = [one_by_one() for _ in range(2)]
        # and through the plain version, the first tenant of each shape
        # group (phase 5 holds every group's batched scan to the plain
        # batched scan, each row to its solo kernel scan)
        for n in (group[0] for group in FLEET_GROUPS):
            ref = fleet_scheduler(n, "reference").solve(tenants[n][0]())
            if _canonical(ref) != expected[n]:
                raise AssertionError(f"{n}: cuda result != reference result")

        scheds = [fleet_scheduler(n) for n in tenants]
        for sched, n in zip(scheds, tenants):
            _instrument(sched, n, log)
        rounds = []
        outcomes = res = pods = None
        cuda_ffd.counter.reset()
        with plain_forbidden():
            # one cold round, two warm, and a warm round with the garbage
            # collector off, whose batched scans are kept for the check below
            for rnd in range(4):
                t1 = time.perf_counter()
                outcomes = res = pods = None  # the last round's, freed here
                freed_s = time.perf_counter() - t1
                pods = [make() for make, _k in tenants.values()]
                gc.collect()
                log["capture"] = rnd == 3
                before = {k: (list(v) if isinstance(v, list) else v)
                          for k, v in log.items()}
                launches0, rows0 = (dict(cuda_ffd.counter.launches),
                                    cuda_ffd.counter.rows)
                if rnd == 3:
                    gc.disable()
                try:
                    t0 = time.perf_counter()
                    outcomes, stats = solve_batch(list(zip(scheds, pods)))
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                finally:
                    gc.enable()
                log["capture"] = False
                for n, (status, res) in zip(tenants, outcomes):
                    if status != "ok":
                        raise AssertionError(f"round {rnd} {n}: {res!r}")
                    if res.pod_errors:
                        raise AssertionError(f"round {rnd} {n}:"
                                             f" {len(res.pod_errors)} pod"
                                             " errors")
                    if res.node_count() != FLEET_EXPECTED_NODES[n]:
                        raise AssertionError(
                            f"round {rnd} {n}: {res.node_count()} nodes,"
                            f" expected {FLEET_EXPECTED_NODES[n]}")
                    if _canonical(res) != expected[n]:
                        raise AssertionError(
                            f"round {rnd} {n}: batched result != the tenant"
                            " solved alone")
                scans = log["scans"][len(before["scans"]):]
                n_batched = log["batched"] - before["batched"]
                n_solo = log["solo"] - before["solo"]
                padded = log["padded"][len(before["padded"]):]
                if log["batched_failed"]:
                    raise AssertionError("a batched dispatch failed and was"
                                         " retried solo")
                if (stats["dispatches"] != n_batched + n_solo
                        or stats["batched_dispatches"] != n_batched
                        or stats["padded_total_rows"] != sum(padded)):
                    raise AssertionError(f"round {rnd}: stats {stats} against"
                                         f" {n_batched} batched and {n_solo}"
                                         " solo dispatches")
                if rnd == 0 and (stats["batched_dispatches"] < 1
                                 or stats["batched_problems"] < 8):
                    raise AssertionError(
                        f"cold round batched too little: {stats}")
                grew = {k: v - launches0[k]
                        for k, v in cuda_ffd.counter.launches.items()}
                launched = sum(1 for _b, j in scans if j > 0)
                if (grew != dict.fromkeys(cuda_ffd.KERNELS, launched)
                        or not launched):
                    raise AssertionError(f"round {rnd}: launches {grew} for"
                                         f" {launched} scans")
                rows = cuda_ffd.counter.rows - rows0
                if rows != sum(b for b, _j in scans):
                    raise AssertionError(f"round {rnd}: rows counted {rows},"
                                         f" scans {scans}")
                if dict(m.SOLVER_RESULT_REJECTED.values) != rejected0:
                    raise AssertionError(f"round {rnd}: the verifier"
                                         " rejected")
                phases = _phase_sums(scheds)
                split = _split(log, before)
                rounds.append(dict(
                    wall_s=wall, pods_per_s=total_pods / wall, stats=stats,
                    scans=scans, launches=grew, rows=rows, phases=phases,
                    outside_s=wall - sum(phases.values()), split=split,
                    # the wall outside the generators, dispatches and keys
                    loop_s=(wall - split["gen_s"] - split["dispatch_s"]
                            - split["key_s"]),
                    freed_s=freed_s, gc_off=rnd == 3,
                    slots={n: s.last_phase_stats["slots"]
                           for n, s in zip(tenants, scheds)},
                ))
                kind = ("cold" if rnd == 0 else
                        "warm, garbage collector off" if rnd == 3 else "warm")
                print(f"solve_batch round {rnd} ({kind}): {wall:.3f} s,"
                      f" {total_pods / wall:.0f} pods/s; scans (rows, steps)"
                      f" {scans}; stats {json.dumps(stats)}; launches"
                      f" {json.dumps(grew)}; outside the phase timers"
                      f" {rounds[-1]['outside_s']:.4f} s, split"
                      f" {json.dumps(split)}, driver loop"
                      f" {rounds[-1]['loop_s']:.4f} s; the last round's"
                      f" results freed before the timer in {freed_s:.4f} s;"
                      " node counts equal the JAX package's; results equal"
                      " each tenant solved alone; no solo retry; verifier"
                      " rejections unmoved", flush=True)
        launches = dict(cuda_ffd.counter.launches)
        rows_served = cuda_ffd.counter.rows
        outcomes = res = pods = None
        seq.append(one_by_one())

    # the batched kernel against its plain version at the warm rounds'
    # slot widths, on the inputs the last round's batched scans were given
    warm_checks = []
    for names, state, steps, statics, li in log["captured"]:
        N = int(state.kind.shape[1])
        off = {n: [r["slots"][n] for r in rounds[1:]] for n in names
               if any(r["slots"][n] != N for r in rounds[1:])}
        if off:
            raise AssertionError(f"{names}: a warm batched scan at {N} slots,"
                                 f" the warm rounds ran at {off}")
        _k, err, plain_ms = hold_batched_bit_equal(state, steps, statics, li,
                                                   names)
        warm_checks.append(dict(
            tenants=names, B=len(names), Bp=int(state.kind.shape[0]),
            J=int(steps.count.shape[1]), N=N, unequal=0, max_abs_err=err,
            plain_ms=plain_ms))
        print(f"batched kernel at the warm width [{names[0]}..{names[-1]}]"
              f" B={len(names)} Bp={warm_checks[-1]['Bp']}"
              f" J={warm_checks[-1]['J']} N={N} (every warm round's slots):"
              " 0 unequal elements against the plain batched scan, each row"
              " equal to its solo kernel scan, pad rows equal to row 0;"
              f" plain {plain_ms:.1f} ms", flush=True)
    if not warm_checks:
        raise AssertionError("the last round made no batched scan")

    with plain_forbidden():
        pods = [make() for make, _k in tenants.values()]
        idle = _idle_share(lambda: solve_batch(list(zip(scheds, pods))),
                           cpu=False)
    warm = [r["wall_s"] for r in rounds[1:3]]
    seq_warm = [s["wall_s"] for s in seq[1:]]  # 1 pass before, 1 after
    out = dict(
        tenants=list(tenants), pods=total_pods,
        nodes=dict(FLEET_EXPECTED_NODES), rounds=rounds,
        cold_s=rounds[0]["wall_s"], warm_s=warm,
        warm_p50_s=statistics.median(warm),
        gc_off_s=rounds[3]["wall_s"],
        one_by_one=seq, one_by_one_cold_s=seq[0]["wall_s"],
        one_by_one_warm_s=seq_warm,
        one_by_one_warm_p50_s=statistics.median(seq_warm),
        pods_per_s_batched_warm_p50=total_pods / statistics.median(warm),
        pods_per_s_one_by_one_warm_p50=(total_pods
                                        / statistics.median(seq_warm)),
        device_idle_share=idle, launches=launches, rows=rows_served,
        warm_bit_equal=warm_checks,
    )
    print(f"solve_batch over {len(tenants)} tenants ({total_pods} pods):"
          f" cold {out['cold_s']:.3f} s, warm p50 {out['warm_p50_s']:.3f} s"
          f" ({out['pods_per_s_batched_warm_p50']:.0f} pods/s), garbage"
          f" collector off {out['gc_off_s']:.3f} s; one by one cold"
          f" {seq[0]['wall_s']:.3f} s, warm {json.dumps(seq_warm)} (p50"
          f" {out['pods_per_s_one_by_one_warm_p50']:.0f} pods/s), outside"
          f" the phase timers {json.dumps([s['outside_s'] for s in seq])} s,"
          f" garbage collector {json.dumps([s['gc_s'] for s in seq])} s in"
          f" passes by generation {json.dumps([s['gc_passes'] for s in seq])};"
          f" device idle share {idle}; launches {json.dumps(launches)}, rows"
          f" {rows_served}", flush=True)
    return out


def _phase_sums(schedulers):
    """Each phase's seconds summed over the schedulers' last solves."""
    keys = ("plan_s", "prepare_s", "kernel_s", "decode_s", "verify_s")
    return {k: sum(s.last_phase_stats.get(k, 0.0) for s in schedulers)
            for k in keys}


# ---------------------------------------------------------------------------
# the consolidation sweep (phase 7) and the operator (phase 8)

SWEEP_NODES, SWEEP_CANDIDATES, SWEEP_TYPES, SWEEP_SLOTS = 2000, 100, 400, 2560
# the JAX package's frontier at config 4 (its frontier_core, xla backend,
# on the CPU): per prefix (all pods placed, new nodes, fresh-node price lower
# bound), run-length encoded as [count, (ok, n_new, price_lb)];
# ``JAX_PLATFORMS=cpu python3 fleet_expected.py`` prints it
SWEEP_EXPECTED = [[100, [True, 0, 0.0]]]
# the JAX package's Operator(solver="tpu") on each phase-8 scenario: the
# final node count and the nodes' summed cpu capacity
OPERATOR_EXPECTED = {"provisioning": [171, 4274.0],
                     "consolidation": [4, 64.0]}
OPERATOR_CANDIDATES = 100


def sweep_inputs(n_nodes=SWEEP_NODES, n_cand=SWEEP_CANDIDATES,
                 n_types=SWEEP_TYPES):
    """bench.py's BASELINE config 4, built with the port's classes: 2,000
    existing nodes, of which the first 100 are under-utilized candidates
    (7 cpu / 14 GiB free), two reschedulable pods per candidate, one pool
    over ``bench_catalog(400)``. Keyword arguments of ``frontier_core``
    (less ``max_slots``); candidate nodes first. The tests shrink the
    counts."""
    from karpenter_core_tpu_torch.api import labels as L
    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (
        SimNode,
    )

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
            available={"cpu": 7.0 if i < n_cand else 1.0,
                       "memory": 14 * GIB if i < n_cand else 2 * GIB,
                       "pods": 200.0},
            capacity={"cpu": 8.0, "memory": 16 * GIB, "pods": 210.0},
        )
        for i in range(n_nodes)
    ]
    resched = _plain_pods(2 * n_cand, shapes=(4, 3))
    return dict(
        nodepools=[_pool()],
        instance_types={"default": list(bench_catalog(n_types))},
        cand_nodes=nodes[:n_cand],
        keep_nodes=nodes[n_cand:],
        daemonset_pods=[],
        base_pods=[],
        candidate_pods=[resched[2 * i:2 * i + 2] for i in range(n_cand)],
    )


def run_length(triples):
    """[[count, triple], ...] of consecutive equal frontier triples."""
    out = []
    for t in triples:
        t = [bool(t[0]), int(t[1]), float(t[2])]
        if out and out[-1][1] == t:
            out[-1][0] += 1
        else:
            out.append([1, t])
    return out


def frontier_equal(got, expected_rle):
    """The frontier against a run-length encoded one: the flags and
    new-node counts exactly, the price bound to a relative 1e-6 (float32
    sums in another order)."""
    want = [t for n, t in expected_rle for _ in range(n)]
    if len(got) != len(want):
        return False
    for (ok, n_new, lb), (ok2, n_new2, lb2) in zip(got, want):
        if bool(ok) != ok2 or int(n_new) != n_new2:
            return False
        if lb != lb2 and abs(lb - lb2) > 1e-6 * abs(lb2):
            return False
    return True


def _tree_bytes(*trees):
    return sum(x.numel() * x.element_size() for t in trees for x in t
               if x is not None)


def _stack_bound(init, steps, statics, state, takes, unplaced):
    """``_bound_batched`` of a stacked scan at its own interface: every
    row's slot state read and written as the kernel has it (packed or
    not), and a leaf shared over the rows (stride 0) read once; the same
    operations."""
    from karpenter_core_tpu_torch.ops import cuda_ffd

    ops = sum(t[1] for t in _batched_terms(
        cuda_ffd.unpack_state(init), steps, statics,
        cuda_ffd.unpack_state(state), takes, unplaced))
    moved = (_tree_bytes(init, state) + _stored_bytes(steps, statics)
             + takes.numel() * 4 + unplaced.numel() * 4)
    return _bound_ms([(moved, ops)])


def _stored_bytes(*trees):
    """``_tree_bytes`` counting a leaf expanded with stride 0 over its
    leading axis (the sweep's shared class steps and statics) once."""
    def one(x):
        if x.dim() and x.shape[0] > 1 and x.stride(0) == 0:
            x = x[0]
        return x.numel() * x.element_size()

    return sum(one(x) for t in trees for x in t if x is not None)


def sweep_phase():
    """The consolidation sweep at config 4 through the kernel: the port's
    ``frontier_core`` (one launch through the sweep's entry,
    ``cuda_ffd_solve_prefixes``, B = 100) held to the JAX package's
    frontier; its stacked scan (packed slot state, shared class steps and
    statics) held bit-equal to the plain batched scan on the full grid and
    on 2 blocks, each row to the solo kernel, the final plane unpacked for
    the comparison; timed (the kernel's scan, the whole sweep cold and
    warm, the plain scan), split by stage from the stamps, with the peak
    device memory of one warm ``frontier_core`` and the device idle share
    of one profiled warm sweep."""
    import torch

    from karpenter_core_tpu_torch.models import consolidation as cons
    from karpenter_core_tpu_torch.ops import cuda_ffd
    from karpenter_core_tpu_torch.ops.ffd import LEVEL_ITERS

    inputs = sweep_inputs()
    P = len(inputs["candidate_pods"])

    def sweep():
        return cons.frontier_core(**inputs, max_slots=SWEEP_SLOTS,
                                  device="cuda", kernel_backend="cuda")

    walls = []
    for rep in range(4):  # one cold, three warm
        cuda_ffd.counter.reset()
        with plain_forbidden():
            t0 = time.perf_counter()
            frontier = sweep()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        grew = dict(cuda_ffd.counter.launches)
        if (grew != dict.fromkeys(cuda_ffd.KERNELS, 1)
                or cuda_ffd.counter.prefix_launches != 1
                or cuda_ffd.counter.rows != P):
            raise AssertionError(
                f"sweep {rep}: launches {grew}"
                f" ({cuda_ffd.counter.prefix_launches} through"
                f" cuda_ffd_solve_prefixes) over {cuda_ffd.counter.rows}"
                f" rows, expected one launch of the sweep's entry over {P}")
        if frontier is None or not frontier_equal(frontier, SWEEP_EXPECTED):
            raise AssertionError(f"sweep {rep}: frontier"
                                 f" {run_length(frontier or [])} != the JAX"
                                 f" package's {SWEEP_EXPECTED}")
    prefix_launches = cuda_ffd.counter.prefix_launches
    with plain_forbidden():
        idle = _idle_share(sweep, cpu=False)
    # the peak device memory of one warm frontier_core, over what was
    # allocated before it
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sweep()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    # the sweep's stacked scan, held to the plain batched scan
    sched, prep, classes, kind_batch, count_batch = cons.sweep_problem(
        **inputs, max_slots=SWEEP_SLOTS, device="cuda")
    E = len(sched.existing_nodes)
    it_price = torch.as_tensor(cons._it_price_vector(prep), device="cuda")
    init0 = _copy(prep.init_state)
    state, steps, statics = cons.prefix_stack(
        cuda_ffd.pack_state(prep.init_state), classes, prep.statics,
        kind_batch, count_batch)
    li = LEVEL_ITERS
    J = int(steps.count.shape[1])
    N, K = (int(x) for x in state.valmask.shape[1:3])
    V = int(state.zcount.shape[2])
    T = int(state.itmask.shape[2])
    packed_bytes = _tree_bytes(state)
    shared_bytes = _stored_bytes(steps, statics)
    old_bytes = _tree_bytes(cuda_ffd.unpack_state(state), steps, statics)
    scratch = cuda_ffd.scratch_bytes(state, statics)
    outputs = P * J * N * 4 + P * J * 4
    print(f"sweep [config 4] P={P} J={J} N={N} T={T} K={K} V={V}: stacked"
          f" inputs {packed_bytes + shared_bytes} bytes: the slot state,"
          f" packed, {packed_bytes} ({P} rows), the shared class steps and"
          f" statics {shared_bytes} (one copy, stride 0; steps"
          f" {_stored_bytes(steps)}, statics {_stored_bytes(statics)});"
          f" the old interface's {old_bytes} (P bool copies of every leaf);"
          f" scratch {scratch}, takes and unplaced {outputs}", flush=True)
    names = [f"prefix-{p + 1}" for p in range(P)]
    k_out, err, plain_ms = hold_batched_bit_equal(
        state, steps, statics, li, names, (0, 2),
        scan=cuda_ffd.cuda_ffd_solve_prefixes)
    blocks = cuda_ffd.counter.blocks

    def kernel_ms(reps):
        """The sweep's scan alone, by CUDA events, each on a fresh copy of
        the stacked state made outside the timed window."""
        total = 0.0
        for _ in range(reps):
            st = _copy(state)
            _out, ms = _time_once(
                lambda: cuda_ffd.cuda_ffd_solve_prefixes(st, steps, statics,
                                                         li))
            total += ms
        return total / reps

    kernel_ms(1)  # warm
    ms = kernel_ms(10)
    # three bounds, the same operations: the scan's own interface (every
    # row's packed state read and written, one copy of the shared steps
    # and statics), the old interface's (every row's bool copies of every
    # leaf, as PRs 4-9 stacked them), and the bytes the sweep needs (one
    # prepared state, one set of steps and statics, the per-prefix kind
    # and count planes and verdicts), which no layout changes
    terms = _batched_terms(cuda_ffd.unpack_state(state), steps, statics,
                           cuda_ffd.unpack_state(k_out[0]), *k_out[1:])
    ops = sum(t[1] for t in terms)
    bound_ms, bound_by = _stack_bound(state, steps, statics, *k_out)
    old_bound_ms, old_bound_by = _bound_ms(terms)
    unique_bytes = (_tree_bytes(prep.init_state, classes, prep.statics)
                    + kind_batch.size * state.kind.element_size()
                    + count_batch.size * steps.count.element_size()
                    + P * (4 + 4 + 1 + 4))
    unique_bound_ms, unique_bound_by = _bound_ms([(unique_bytes, ops)])
    stages = _stage_stamps(
        lambda st: cuda_ffd.cuda_ffd_solve_prefixes(
            _copy(state), steps, statics, li, _stamps=st), J)

    # the whole device sweep (stack, scan, verdicts), cold and warm, and
    # its verdicts against the frontier
    def prefix_scan():
        return cons._prefix_scan(prep.init_state, classes, prep.statics,
                                 kind_batch, count_batch, it_price, E)

    sweep_ms = [_time_once(prefix_scan)[1] for _ in range(4)]
    verdicts = prefix_scan()
    if not frontier_equal([
            (int(u) == 0 and not bool(o), int(nf) - E, float(lb))
            for nf, u, o, lb in zip(*(x.cpu().tolist() for x in verdicts))],
            SWEEP_EXPECTED):
        raise AssertionError("the prefix scan's verdicts != the frontier")
    bad = {k: n for k, n in ((k, _unequal(a, b)) for k, a, b in zip(
        init0._fields, init0, prep.init_state)) if n}
    if bad:
        raise AssertionError(f"the sweep wrote the prepared state: {bad}")
    row = dict(
        P=P, J=J, N=N, T=T, K=K, V=V, blocks=blocks, unequal=0,
        max_abs_err=err, packed_state_bytes=packed_bytes,
        shared_bytes=shared_bytes, old_stacked_bytes=old_bytes,
        scratch_bytes=scratch, output_bytes=outputs, ms=ms,
        ms_per_step=ms / J, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, old_bound_ms=old_bound_ms,
        old_bound_by=old_bound_by, unique_bytes=unique_bytes,
        unique_bound_ms=unique_bound_ms, unique_bound_by=unique_bound_by,
        stage_us_per_step=stages, frontier_cold_s=walls[0],
        frontier_warm_s=walls[1:],
        frontier_warm_p50_s=statistics.median(walls[1:]),
        frontier_peak_bytes=peak, frontier_base_bytes=base,
        frontier_peak_over_base_bytes=peak - base,
        prefix_launches=prefix_launches,
        sweep_cold_ms=sweep_ms[0], sweep_warm_ms=sweep_ms[1:],
        sweep_warm_p50_ms=statistics.median(sweep_ms[1:]),
        device_idle_share=idle, frontier=run_length(frontier),
    )
    print(f"sweep [config 4]: frontier equals the JAX package's"
          f" ({row['frontier']}); one launch of {P} rows a sweep, through"
          f" cuda_ffd_solve_prefixes ({prefix_launches} in the last sweep);"
          f" the stacked scan 0 unequal elements against the plain batched"
          f" scan on {blocks} blocks and on 2, each row equal to its solo"
          f" kernel scan; scan {ms:.3f} ms ({ms / J * 1e3:.2f} us/step) vs"
          f" plain {plain_ms:.1f} ms; bound of its interface"
          f" {bound_ms:.4f} ms ({bound_by}), of the old stacked interface"
          f" {old_bound_ms:.4f} ms ({old_bound_by}), of the {unique_bytes}"
          f" bytes the sweep needs {unique_bound_ms:.4f} ms"
          f" ({unique_bound_by}); device us/step by stage (stamps)"
          f" {json.dumps(stages)}; device sweep (stack, scan, verdicts) cold"
          f" {sweep_ms[0]:.3f} ms, warm {json.dumps(sweep_ms[1:])} ms;"
          f" frontier_core cold {walls[0]:.3f} s, warm"
          f" {json.dumps(walls[1:])} s; peak device memory of a warm"
          f" frontier_core {peak} bytes ({peak - base} over the {base}"
          f" allocated before it); device idle share {idle}; the prepared"
          f" state unchanged", flush=True)
    return row


def _replicated_pod(name, cpu, memory_gib=1.0):
    from karpenter_core_tpu_torch.api.objects import (
        ObjectMeta,
        OwnerReference,
        Pod,
    )

    return Pod(
        metadata=ObjectMeta(name=name, owner_references=[OwnerReference(
            kind="ReplicaSet", name="rs", uid="rs-uid")]),
        resource_requests={"cpu": cpu, "memory": memory_gib * GIB},
    )


def _consolidation_pool():
    """An on-demand pool (spot-to-spot consolidation is gated off) whose
    budget lets every node be disrupted at once, so multi-node
    consolidation sees the whole fleet as candidates."""
    from karpenter_core_tpu_torch.api import labels as L
    from karpenter_core_tpu_torch.api.nodepool import Budget
    from karpenter_core_tpu_torch.api.objects import NodeSelectorRequirement

    pool = _pool()
    pool.spec.template.requirements = [NodeSelectorRequirement(
        L.CAPACITY_TYPE_LABEL_KEY, "In", ("on-demand",))]
    pool.spec.disruption.budgets = [Budget(nodes="100%")]
    return pool


def port_classes():
    """The classes an operator scenario needs, from the port."""
    from types import SimpleNamespace

    from karpenter_core_tpu_torch.api.objects import Pod
    from karpenter_core_tpu_torch.cloudprovider.kwok import KwokCloudProvider
    from karpenter_core_tpu_torch.kube.store import KubeStore
    from karpenter_core_tpu_torch.operator import Operator
    from karpenter_core_tpu_torch.utils.clock import FakeClock

    return SimpleNamespace(Operator=Operator, KubeStore=KubeStore,
                           KwokCloudProvider=KwokCloudProvider,
                           FakeClock=FakeClock, Pod=Pod,
                           convert=lambda obj: obj)


def _new_operator(ns, catalog, options):
    clock = ns.FakeClock()
    kube = ns.KubeStore(clock)
    return ns.Operator(kube=kube, clock=clock, options=options,
                       cloud_provider=ns.KwokCloudProvider(
                           kube, ns.convert(catalog)))


def provisioning_scenario(ns, options):
    """plain_5k_400's 5,000 pods created pending over one pool on
    ``bench_catalog(400)``; returns (operator, run) where ``run()`` drives
    ``run_until_idle(disrupt=False)``. ``ns`` names the package's classes
    (``port_classes``), ``options`` its ``Options``."""
    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog

    op = _new_operator(ns, list(bench_catalog(400)), options)
    op.kube.create(ns.convert(_pool()))
    for pod in ns.convert(_plain_pods(5000)):
        op.kube.create(pod)
    return op, lambda: op.run_until_idle(disrupt=False)


def consolidation_scenario(ns, options, n=OPERATOR_CANDIDATES):
    """An under-utilized fleet of ``n`` nodes, one pod on each, then
    ``run_until_idle(max_iters=200)``: the shape of
    tests/test_batched_consolidation.py's ``underutilized_fleet``, sized so
    that no node is empty (each holds a 15-cpu pod and a 0.6-cpu one, and
    the 15-cpu pods are deleted) and the pool's budget lets all ``n`` be
    candidates, so multi-node consolidation sweeps all ``n`` prefixes."""
    from karpenter_core_tpu_torch.cloudprovider.kwok import build_catalog

    catalog = build_catalog(cpu_grid=[1, 2, 4, 8, 16], mem_factors=[2, 4])
    op = _new_operator(ns, catalog, options)
    op.kube.create(ns.convert(_consolidation_pool()))
    for i in range(n):
        op.kube.create(ns.convert(_replicated_pod(f"big{i}", 15.0)))
        op.kube.create(ns.convert(_replicated_pod(f"small{i}", 0.6)))
    op.run_until_idle(disrupt=False)
    for i in range(n):
        pod = op.kube.get(ns.Pod, f"big{i}")
        pod.metadata.owner_references = []
        op.kube.delete(pod)
    op.run_until_idle(disrupt=False)
    return op, lambda: op.run_until_idle(max_iters=200)


OPERATOR_SCENARIOS = {"provisioning": provisioning_scenario,
                      "consolidation": consolidation_scenario}


def operator_outcome(op):
    """(node count, the nodes' summed cpu capacity, every pod bound)."""
    nodes = op.kube.list_nodes()
    return (len(nodes), sum(n.status.capacity.get("cpu", 0) for n in nodes),
            all(p.node_name for p in op.kube.list_pods()))


@contextlib.contextmanager
def operator_spy():
    """Record, per port DeviceScheduler solve and per multi-node
    consolidation pass, its seconds and what the scan kernel's counters
    gained inside it, per kernel request of a solve whether it had class
    steps (a request with none launches nothing), each pass's frontier
    triples and (passing, dubious) sizes, and, for the first sweep of each
    prefix count P, its ``_prefix_scan`` arguments and verdicts and the
    stacked inputs and outputs of its kernel launch through the sweep's
    entry, ``cuda_ffd_solve_prefixes`` (copies: the kernel writes its
    final state into its input; the plane packed, as the kernel has it)."""
    from karpenter_core_tpu_torch.controllers.disruption import methods
    from karpenter_core_tpu_torch.models import consolidation as cons
    from karpenter_core_tpu_torch.models import provisioner as prov
    from karpenter_core_tpu_torch.ops import cuda_ffd

    log = dict(solves=[], sweeps=[], scans=0, frontiers=[], captured={},
               capture=None)
    solve, frontier = prov.DeviceScheduler.solve, (
        methods.MultiNodeConsolidation._device_frontier)
    run_1 = prov._run_kernel_solo
    sched_frontier = cons.schedulability_frontier
    prefix_scan = cons._prefix_scan
    prefixes = cuda_ffd.cuda_ffd_solve_prefixes

    def counted(fn, entry):
        l0, r0 = cuda_ffd.counter.total(), cuda_ffd.counter.rows
        p0 = cuda_ffd.counter.prefix_launches
        t0 = time.perf_counter()
        try:
            out = fn()
        finally:
            entry.update(s=time.perf_counter() - t0,
                         launches=cuda_ffd.counter.total() - l0,
                         prefix_launches=(cuda_ffd.counter.prefix_launches
                                          - p0),
                         rows=cuda_ffd.counter.rows - r0)
        return out

    def spy_solve(self, pods):
        entry = dict(scans0=log["scans"])
        log["solves"].append(entry)
        out = counted(lambda: solve(self, pods), entry)
        entry["scans"] = log["scans"] - entry.pop("scans0")
        return out

    def spy_run(req):
        log["scans"] += int(req.steps.count.shape[0] > 0)
        return run_1(req)

    def spy_frontier(self, candidates):
        entry = dict(candidates=len(candidates))
        log["sweeps"].append(entry)
        out = counted(lambda: frontier(self, candidates), entry)
        entry["frontier"] = out is not None
        entry["sizes"] = out
        return out

    def spy_sched_frontier(*args, **kwargs):
        out = sched_frontier(*args, **kwargs)
        log["frontiers"].append(out)
        return out

    def spy_prefix_scan(state, classes, statics, kind_batch, count_batch,
                        it_price, n_existing, kernel_backend="cuda"):
        args = (state, classes, statics, kind_batch, count_batch, it_price,
                n_existing, kernel_backend)
        P = int(kind_batch.shape[0])
        if P in log["captured"]:
            return prefix_scan(*args)
        cap = log["captured"][P] = dict(args=(
            _copy(state), _copy(classes), _copy(statics), kind_batch.copy(),
            count_batch.copy(), it_price.clone(), n_existing))
        log["capture"] = cap
        try:
            out = prefix_scan(*args)
        finally:
            log["capture"] = None
        cap["verdicts"] = tuple(x.clone() for x in out)
        return out

    def spy_prefixes(state, steps, statics, level_iters, **kwargs):
        cap = log["capture"]
        if cap is None:
            return prefixes(state, steps, statics, level_iters, **kwargs)
        cap["kernel_in"] = (_copy(state), _copy(steps), _copy(statics),
                            level_iters)
        out = prefixes(state, steps, statics, level_iters, **kwargs)
        cap["kernel_out"] = (_copy(out[0]), out[1].clone(), out[2].clone())
        return out

    prov.DeviceScheduler.solve = spy_solve
    prov._run_kernel_solo = spy_run
    methods.MultiNodeConsolidation._device_frontier = spy_frontier
    cons.schedulability_frontier = spy_sched_frontier
    cons._prefix_scan = spy_prefix_scan
    cuda_ffd.cuda_ffd_solve_prefixes = spy_prefixes
    try:
        yield log
    finally:
        prov.DeviceScheduler.solve = solve
        prov._run_kernel_solo = run_1
        methods.MultiNodeConsolidation._device_frontier = frontier
        cons.schedulability_frontier = sched_frontier
        cons._prefix_scan = prefix_scan
        cuda_ffd.cuda_ffd_solve_prefixes = prefixes


def hold_operator_sweeps(log, name):
    """Hold the batched scans of the first sweep of each prefix count that
    the operator ran through the kernel: the stacked inputs it handed the
    sweep's entry, run again through it (full grid and 2 blocks), the
    plain batched scan and the solo kernel row by row
    (``hold_batched_bit_equal``, the planes unpacked); the main path's own
    launch output bit-equal to them; and its verdicts (next free slot,
    unplaced pods, overflow exactly, the price bound to a relative 1e-6)
    equal to ``_prefix_scan`` through the plain batched scan on the same
    arguments. Returns a row per prefix count."""
    from karpenter_core_tpu_torch.models import consolidation as cons
    from karpenter_core_tpu_torch.ops import cuda_ffd

    rows = []
    for P, cap in sorted(log["captured"].items()):
        if "kernel_out" not in cap:
            raise AssertionError(f"{name}: the sweep of {P} prefixes did"
                                 " not reach the batched kernel")
        state, steps, statics, li = cap["kernel_in"]
        names = [f"{name} sweep P={P} prefix-{p + 1}" for p in range(P)]
        k_out, err, plain_ms = hold_batched_bit_equal(
            state, steps, statics, li, names, (0, 2),
            scan=cuda_ffd.cuda_ffd_solve_prefixes)
        live_state, *live_rest = cap["kernel_out"]
        live = _planes(cuda_ffd.unpack_state(live_state), *live_rest)
        again = _planes(cuda_ffd.unpack_state(k_out[0]), *k_out[1:])
        bad = {k: n for k in live if (n := _unequal(live[k], again[k]))}
        if bad:
            raise AssertionError(f"{name}: the operator's sweep launch"
                                 f" (P={P}) != the plain batched scan on"
                                 f" {bad}")
        want = [x.cpu().tolist() for x in cons._prefix_scan(
            *cap["args"], kernel_backend="reference")]
        got = [x.cpu().tolist() for x in cap["verdicts"]]
        if got[:3] != want[:3] or any(
                a != b and abs(a - b) > 1e-6 * abs(b)
                for a, b in zip(got[3], want[3])):
            raise AssertionError(f"{name}: the sweep's verdicts (P={P})"
                                 f" {got} != the plain scan's {want}")
        E = cap["args"][6]
        rows.append(dict(
            P=P, J=int(steps.count.shape[1]), N=int(state.kind.shape[1]),
            unequal=0, max_abs_err=err, plain_ms=plain_ms,
            fresh_prefixes=sum(nf > E for nf in got[0]),
            priced_prefixes=sum(lb > 0 for lb in got[3])))
    return rows


def same_sweeps(log, ref_log, name):
    """Raise unless the kernel's run and the plain version's ran the same
    multi-node passes with the same frontier, prefix by prefix (flags and
    new-node counts exactly, the price bound to a relative 1e-6), and the
    same (passing, dubious) sizes."""
    got, want = log["frontiers"], ref_log["frontiers"]
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} frontiers, the plain"
                             f" version's run {len(want)}")
    for k, (a, b) in enumerate(zip(got, want)):
        if (a is None) != (b is None) or (
                a is not None and not frontier_equal(a, run_length(b))):
            raise AssertionError(f"{name}: frontier {k} {run_length(a or [])}"
                                 f" != the plain version's"
                                 f" {run_length(b or [])}")
    sizes = [s["sizes"] for s in log["sweeps"]]
    ref_sizes = [s["sizes"] for s in ref_log["sweeps"]]
    if sizes != ref_sizes:
        raise AssertionError(f"{name}: (passing, dubious) {sizes} != the"
                             f" plain version's {ref_sizes}")


def reset_name_counters():
    """Claim names, hostname placeholders and object uids come from
    module-level counters: each operator run starts them from 1, so the
    kernel's run and the plain version's see the same names."""
    import itertools

    from karpenter_core_tpu_torch.api import objects
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling import (
        inflight,
        nodeclaimtemplate,
    )

    nodeclaimtemplate._claim_counter = itertools.count(1)
    inflight._hostname_counter = itertools.count(1)
    objects._uid_counter = itertools.count(1)


def check_launches(log, name):
    """One launch a provisioning scan and one launch of P rows a sweep,
    through the sweep's entry, in an ``operator_spy`` log."""
    for s in log["solves"]:
        if s["launches"] != s["scans"] or s["rows"] != s["scans"]:
            raise AssertionError(f"{name}: a solve of {s['scans']} scans"
                                 f" launched {s['launches']} over"
                                 f" {s['rows']} rows")
    for s in log["sweeps"]:
        if (s["launches"] != 1 or s["prefix_launches"] != 1
                or s["rows"] != s["candidates"]):
            raise AssertionError(f"{name}: a sweep of {s['candidates']}"
                                 f" prefixes launched {s['launches']}"
                                 f" ({s['prefix_launches']} through"
                                 " cuda_ffd_solve_prefixes) over"
                                 f" {s['rows']} rows")


def check_operator_run(op, log, name, errors0, rejected0, expect_sweep,
                       launched=True):
    """Raise unless the run left no trace of a swallowed failure and went
    through the kernel as it should: no reconcile error and no verifier
    rejection counted, no controller fault, ``readyz()`` true, on every
    multi-node pass a frontier (never the host binary search), a sweep over
    ``expect_sweep`` candidates when that is not 0, and (``launched``: on
    the card) one launch a provisioning scan and one launch of ``P`` rows a
    sweep."""
    from karpenter_core_tpu_torch.metrics import wiring as m

    if dict(m.RECONCILE_ERRORS.values) != errors0:
        raise AssertionError(f"{name}: reconcile errors"
                             f" {dict(m.RECONCILE_ERRORS.values)}")
    if dict(m.SOLVER_RESULT_REJECTED.values) != rejected0:
        raise AssertionError(f"{name}: the verifier rejected a result")
    if op._controller_faults or m.CONTROLLER_CRASHLOOPING.value() or (
            not op.readyz()):
        raise AssertionError(f"{name}: controller faults"
                             f" {op._controller_faults}, readyz"
                             f" {op.readyz()}")
    for s in log["sweeps"]:
        if not s["frontier"]:
            raise AssertionError(f"{name}: a multi-node pass over"
                                 f" {s['candidates']} candidates had no"
                                 " frontier")
    if launched:
        check_launches(log, name)
    if expect_sweep and not any(s["candidates"] == expect_sweep
                                for s in log["sweeps"]):
        raise AssertionError(f"{name}: no sweep over {expect_sweep}"
                             f" candidates ({log['sweeps']})")


def operator_phase():
    """``Operator(Options(solver="tpu"))`` on the card with the defaults
    (device cuda, kernel cuda), the plain step made to raise: each
    scenario held to the JAX operator's node count and cpu, and to the
    same port operator with ``solver_kernel="reference"`` (its frontiers
    too, pass by pass), with every launch accounted for, the sweeps'
    launches held to the plain batched scan, and no swallowed failure."""
    import torch

    from karpenter_core_tpu_torch.metrics import wiring as m
    from karpenter_core_tpu_torch.operator import Options
    from karpenter_core_tpu_torch.ops import cuda_ffd

    ns = port_classes()
    rows = {}
    for name, scenario in OPERATOR_SCENARIOS.items():
        expect_sweep = OPERATOR_CANDIDATES if name == "consolidation" else 0
        errors0 = dict(m.RECONCILE_ERRORS.values)
        rejected0 = dict(m.SOLVER_RESULT_REJECTED.values)
        reset_name_counters()
        op, run = scenario(ns, Options(solver="tpu"))
        with operator_spy() as log, plain_forbidden():
            cuda_ffd.counter.reset()
            t0 = time.perf_counter()
            passes = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, rows_served = (cuda_ffd.counter.total(),
                                     cuda_ffd.counter.rows)
            prefix_launches = cuda_ffd.counter.prefix_launches
        check_operator_run(op, log, name, errors0, rejected0, expect_sweep)
        outcome = operator_outcome(op)
        if not outcome[2]:
            raise AssertionError(f"{name}: a pod is not bound")
        if list(outcome[:2]) != list(OPERATOR_EXPECTED[name]):
            raise AssertionError(f"{name}: {outcome[:2]} (nodes, cpu),"
                                 " the JAX operator's"
                                 f" {OPERATOR_EXPECTED[name]}")
        scans = sum(s["scans"] for s in log["solves"])
        prefixes = sum(s["candidates"] for s in log["sweeps"])
        if (launches != scans + len(log["sweeps"])
                or prefix_launches != len(log["sweeps"])
                or rows_served != scans + prefixes):
            raise AssertionError(f"{name}: {launches} launches over"
                                 f" {rows_served} rows for {scans} scans and"
                                 f" {len(log['sweeps'])} sweeps of {prefixes}"
                                 " prefixes")
        # the sweeps' batched scans against the plain batched scan
        held = hold_operator_sweeps(log, name)
        if name == "consolidation" and sorted(
                h["P"] for h in held) != sorted({
                    s["candidates"] for s in log["sweeps"]}):
            raise AssertionError(f"{name}: held sweeps {held}")
        # the same operator through the plain version on the card
        errors0 = dict(m.RECONCILE_ERRORS.values)
        rejected0 = dict(m.SOLVER_RESULT_REJECTED.values)
        reset_name_counters()
        ref_op, ref_run = scenario(
            ns, Options(solver="tpu", solver_kernel="reference"))
        with operator_spy() as ref_log:
            ref_run()
        check_operator_run(ref_op, ref_log, f"{name} (reference)", errors0,
                           rejected0, expect_sweep, launched=False)
        if operator_outcome(ref_op) != outcome:
            raise AssertionError(f"{name}: kernel {outcome} != reference"
                                 f" {operator_outcome(ref_op)}")
        same_sweeps(log, ref_log, name)
        solve_s = sum(s["s"] for s in log["solves"])
        sweep_s = sum(s["s"] for s in log["sweeps"])
        rows[name] = dict(
            nodes=outcome[0], cpu=outcome[1], passes=passes, wall_s=wall,
            solve_s=solve_s, sweep_s=sweep_s,
            other_s=wall - solve_s - sweep_s, solves=len(log["solves"]),
            scans=scans, sweeps=[s["candidates"] for s in log["sweeps"]],
            launches=launches, prefix_launches=prefix_launches,
            rows=rows_served, held=held,
        )
        print(f"operator [{name}]: {outcome[0]} nodes, {outcome[1]} cpu,"
              " every pod bound (the JAX operator's, and the plain"
              f" version's); {passes} passes in {wall:.3f} s: solves"
              f" {solve_s:.3f} s ({len(log['solves'])} solves, {scans}"
              f" scans), sweeps {sweep_s:.3f} s (prefixes"
              f" {rows[name]['sweeps']}), other {rows[name]['other_s']:.3f}"
              f" s; {launches} launches over {rows_served} rows; no"
              " reconcile error, no verifier rejection, readyz true;"
              f" {len(log['frontiers'])} frontiers equal to the plain"
              " version's run, prefix by prefix; the first sweep of each"
              " prefix count held to the plain batched scan on the full"
              f" grid and on 2 blocks: {json.dumps(held)}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# gangs, priority tiers and preemption (phase 9); rack-aware gangs (phase 10)

GANG_PODS, GANG_SLOTS, FAIL_GANGS = 20000, 4096, 16
GANG_TENANTS = [f"gang-tenant-{i}" for i in range(4)]
GANG_TENANT_PODS = 5000
TOPO_GANGS, TOPO_PLAIN, TOPO_SLOTS = 40, 2000, 4096
# the JAX package's answers on the CPU (its DeviceScheduler, xla backend;
# the tenants also through its solve_batch):
# ``JAX_PLATFORMS=cpu python3 fleet_expected.py gangs`` prints them
GANGS_EXPECTED = {"nodes": 4038, "evicted": 320,
                  "evicted_sha": "3896bb47af6a2119", "gangs_placed": 375,
                  "violations": 0, "unschedulable": 1968,
                  "digest": "08b496d79d87d4b2"}
GANG_TENANTS_EXPECTED = {n: 1009 for n in GANG_TENANTS}
TOPO_EXPECTED = {"nodes": 851, "worst_hops": 2, "gangs_placed": 40,
                 "violations": 0, "unschedulable": 0,
                 "digest": "3237c4931e914201"}


def gangs_problem(n_pods=None, pool="default", fail_gangs=None):
    """bench.py's cfg11_gangs recipe (``_gangs_bench``) with its defaults:
    ~75% tier-0 plain pods, 10% system-critical pods of 6 cpu (past the
    4-cpu fresh ceiling: they place only by evicting the existing nodes'
    tier-0 victims), 15% of pods in gangs of 8, over n_pods / 250 existing
    nodes with four victims of 3 cpu each, on a ``cpu_grid=[1, 2, 4]``
    catalog; plus ``fail_gangs`` gangs of 8 whose 4 members of 6 cpu at
    tier 0 cannot place, so the first scan's gang check rolls them back
    and a second scan runs (``n_pods`` and ``fail_gangs`` default to
    GANG_PODS and FAIL_GANGS). Returns (pool, catalog, existing, pods)."""
    from bench_torch import _gangs_problem

    from karpenter_core_tpu_torch.api.objects import ObjectMeta, Pod
    from karpenter_core_tpu_torch.solver.gangs import GANG_ANNOTATION

    n_pods = GANG_PODS if n_pods is None else n_pods
    fail_gangs = FAIL_GANGS if fail_gangs is None else fail_gangs
    catalog, existing, pods = _gangs_problem(n_pods, pool=pool)
    pods += [
        Pod(metadata=ObjectMeta(name=f"fg{k}-{i}", annotations={
                GANG_ANNOTATION: f"fgang-{k}"}),
            resource_requests=({"cpu": 6.0, "memory": 0.5 * GIB} if i < 4
                               else {"cpu": 0.5, "memory": 0.25 * GIB}))
        for k in range(fail_gangs) for i in range(8)
    ]
    return _pool(pool), catalog, existing, pods


def topo_problem(pool="default"):
    """bench.py's cfg18_topoaware recipe (``_topoaware_bench``, the aware
    run) with its defaults: 40 gangs of 8 members of 3 cpu, each member
    declaring ``pod-group-max-hops: 2`` and its rank, and 2,000 plain
    pods, over 168 existing nodes with rack and superpod labels (zones
    interleaved in slot order, racks of 2 nodes, superpods of 2 racks), on
    a ``cpu_grid=[1, 2]`` catalog (fresh nodes top out at 2 cpu, so the
    gangs live on the fleet). Returns (pool, catalog, existing, pods)."""
    from bench_torch import _racked_nodes, _topoaware_pods

    from karpenter_core_tpu_torch.cloudprovider.kwok import build_catalog

    existing = _racked_nodes(4 * TOPO_GANGS + 8, with_topo_labels=True,
                             pool=pool)
    return (_pool(pool), build_catalog(cpu_grid=[1, 2]), existing,
            _topoaware_pods(TOPO_GANGS, TOPO_PLAIN))


def gang_scheduler(problem, kernel_backend="cuda", device="cuda",
                   max_slots=None, devices=1):
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler

    max_slots = GANG_SLOTS if max_slots is None else max_slots
    pool, catalog, existing, _pods = problem
    return DeviceScheduler(
        [pool], {pool.name: list(catalog)}, existing_nodes=existing,
        max_slots=max_slots, devices=devices, device=device,
        kernel_backend=kernel_backend,
    )


def gang_outcome(res, pods):
    """(gangs placed at or above their min count, gangs partially placed:
    atomicity violations) over a result."""
    from karpenter_core_tpu_torch.solver.gangs import (
        gang_min_count,
        pod_gang_sig,
    )

    placed = {p.uid for c in res.new_node_claims for p in c.pods}
    placed |= {p.uid for s in res.existing_nodes for p in s.pods}
    by_gang = {}
    for p in pods:
        g = pod_gang_sig(p)
        if g is not None:
            by_gang.setdefault(g[0], []).append(p)
    ok = bad = 0
    for mpods in by_gang.values():
        n = sum(p.uid in placed for p in mpods)
        if n >= gang_min_count(mpods):
            ok += 1
        elif n > 0:
            bad += 1
    return ok, bad


def _sha(obj):
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()[:16]


def gang_summary(res, pods):
    """What phase 9 holds a gang solve to: node count, evictions (count and
    a digest of the sorted victim uids), gangs placed, atomicity
    violations, unschedulable pods, and a digest of the whole result
    (``_canonical`` with errors keyed by pod name, plus the evictions)."""
    name_of = {p.uid: p.name for p in pods}
    claims, bound, errors = _canonical(res)
    errors = sorted((name_of.get(u, u), msg) for u, msg in errors)
    evictions = sorted((n, list(u)) for n, u in res.evictions.items())
    evicted = sorted(u for _n, us in evictions for u in us)
    placed, violations = gang_outcome(res, pods)
    return dict(nodes=res.node_count(), evicted=len(evicted),
                evicted_sha=_sha(evicted), gangs_placed=placed,
                violations=violations, unschedulable=len(res.pod_errors),
                digest=_sha([claims, bound, errors, evictions]))


def topo_summary(res, pods, existing):
    """What phase 10 holds a rack-aware solve to: node count, the worst
    hop distance inside a gang (judged on the nodes' labels), gangs
    placed, unschedulable pods, and the result digest."""
    from karpenter_core_tpu_torch.solver.gangs import hop_distance

    out = gang_summary(res, pods)
    truth = {n.name: dict(n.labels) for n in existing}
    node_of = {p.name: s.name for s in res.existing_nodes for p in s.pods}
    worst = 0
    for g in range(TOPO_GANGS):
        labs = [truth[node_of[f"tg{g}-{i}"]] for i in range(8)
                if f"tg{g}-{i}" in node_of]
        if len(labs) == 8:
            worst = max(worst, max(hop_distance(a, b)
                                   for i, a in enumerate(labs)
                                   for b in labs[i + 1:]))
    return dict(nodes=out["nodes"], worst_hops=worst,
                gangs_placed=out["gangs_placed"],
                violations=out["violations"],
                unschedulable=out["unschedulable"], digest=out["digest"])


@contextlib.contextmanager
def gang_spy():
    """Record, with the device synchronised at each mark, every scan the
    kernel wrapper launches, each gang dispatch (solo or batched), each
    entry into the gang failure check, each preemption pass, and the host
    backstops of the result (atomicity, distance, eviction pruning, rank
    order): a list of (event, host seconds) in order."""
    import torch

    from karpenter_core_tpu_torch.ops import cuda_ffd, gangsched
    from karpenter_core_tpu_torch.solver import gangs

    backstops = ("enforce_atomicity", "enforce_distance", "prune_evictions",
                 "rank_order_pods")
    log = []
    saved_backstops = {n: getattr(gangs, n) for n in backstops}
    saved = dict(
        launch=cuda_ffd._launch_batched,
        gang=cuda_ffd.cuda_gang_solve,
        gang_s=cuda_ffd.cuda_gang_solve_sharded,
        failed=gangsched._step_failed,
        pre=gangsched.preempt_pass,
        pre_b=gangsched.preempt_pass_batched,
    )

    def mark(tag):
        torch.cuda.synchronize()
        log.append((tag, time.perf_counter()))

    def timed(tag, fn):
        def run(*a, **k):
            mark(tag + "_start")
            out = fn(*a, **k)
            mark(tag + "_end")
            return out
        return run

    def failed(*a, **k):
        log.append(("check", time.perf_counter()))
        return saved["failed"](*a, **k)

    cuda_ffd._launch_batched = timed("scan", saved["launch"])
    cuda_ffd.cuda_gang_solve = timed("gang", saved["gang"])
    cuda_ffd.cuda_gang_solve_sharded = timed("gang", saved["gang_s"])
    gangsched._step_failed = failed
    gangsched.preempt_pass = timed("preempt", saved["pre"])
    gangsched.preempt_pass_batched = timed("preempt", saved["pre_b"])
    for n, fn in saved_backstops.items():
        setattr(gangs, n, timed("backstop", fn))
    try:
        yield log
    finally:
        for n, fn in saved_backstops.items():
            setattr(gangs, n, fn)
        cuda_ffd._launch_batched = saved["launch"]
        cuda_ffd.cuda_gang_solve = saved["gang"]
        cuda_ffd.cuda_gang_solve_sharded = saved["gang_s"]
        gangsched._step_failed = saved["failed"]
        gangsched.preempt_pass = saved["pre"]
        gangsched.preempt_pass_batched = saved["pre_b"]


def gang_split(log):
    """Seconds of each gang dispatch's parts and of each preemption pass
    from a ``gang_spy`` log: the first scan, the failure check with its
    host read (first scan's end to the second scan's start, or to the
    guard when no gang rolled back), the second scan, the cascade guard,
    and the whole dispatch; and the host backstops' seconds in all."""
    out = dict(dispatches=[], preempt_s=[], backstops_s=0.0)
    i = 0
    while i < len(log):
        tag, t = log[i]
        if tag == "backstop_start":
            out["backstops_s"] += log[i + 1][1] - t
            i += 2
            continue
        if tag == "preempt_start":
            end = next(j for j in range(i, len(log))
                       if log[j][0] == "preempt_end")
            out["preempt_s"].append(log[end][1] - t)
            i = end + 1
            continue
        if tag != "gang_start":
            i += 1
            continue
        end = next(j for j in range(i, len(log)) if log[j][0] == "gang_end")
        ev = log[i:end + 1]
        scans = [(a[1], b[1]) for a, b in zip(ev, ev[1:])
                 if a[0] == "scan_start" and b[0] == "scan_end"]
        checks = [x[1] for x in ev if x[0] == "check"]
        d = dict(scan1_s=scans[0][1] - scans[0][0],
                 check_s=(scans[1][0] if len(scans) > 1 else checks[1])
                 - scans[0][1],
                 scan2_s=(scans[1][1] - scans[1][0]) if len(scans) > 1
                 else 0.0,
                 guard_s=ev[-1][1] - checks[-1],
                 total_s=ev[-1][1] - t, scans=len(scans))
        out["dispatches"].append(d)
        i = end + 1
    return out


def gangs_phase():
    """Phase 9: cfg11 gangs and preemption on the card."""
    import dataclasses

    import torch

    from karpenter_core_tpu_torch.metrics import wiring as m
    from karpenter_core_tpu_torch.models.provisioner import solve_batch
    from karpenter_core_tpu_torch.ops import cuda_ffd, gangsched

    problem = gangs_problem()
    pods = problem[3]
    sched = gang_scheduler(problem)
    rejected0 = dict(m.SOLVER_RESULT_REJECTED.values)
    times, stats, launches, rows = [], [], 0, 0
    for rep in range(3):  # one cold solve, two warm
        cuda_ffd.counter.reset()
        with plain_forbidden():
            t0 = time.perf_counter()
            res = sched.solve(pods)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        st = dict(sched.last_phase_stats)
        stats.append(st)
        launches += cuda_ffd.counter.total()
        rows += cuda_ffd.counter.rows
        # one gang dispatch a round (the 4096-slot round overflows and the
        # solve retries at 8192), each a rollback: two scans of one row
        if (cuda_ffd.counter.total() != 2 * st["rounds"]
                or cuda_ffd.counter.rows != 2 * st["rounds"]):
            raise AssertionError(
                f"gangs: solve {rep} launched {cuda_ffd.counter.launches}"
                f" over {cuda_ffd.counter.rows} rows in {st['rounds']}"
                " rounds")
        got = gang_summary(res, pods)
        if got != GANGS_EXPECTED:
            raise AssertionError(f"gangs: solve {rep} {got} !="
                                 f" {GANGS_EXPECTED}")
    # one more warm solve with every gang dispatch part and the
    # preemption pass timed apart (the marks synchronise the device)
    with plain_forbidden(), gang_spy() as log:
        t0 = time.perf_counter()
        spied = gang_summary(sched.solve(pods), pods)
        spied_s = time.perf_counter() - t0
    split = gang_split(log)
    split.update(wall_s=spied_s, phases=_phase_keys(sched.last_phase_stats))
    if spied != GANGS_EXPECTED:
        raise AssertionError(f"gangs (timed apart): {spied}")
    with plain_forbidden():
        idle = _idle_share(lambda: sched.solve(pods), cpu=False)
    if dict(m.SOLVER_RESULT_REJECTED.values) != rejected0:
        raise AssertionError("gangs: the verifier rejected a result")

    # both scans' inputs of a warm solve, held bit-equal to the plain scan
    wreq = first_request(sched, pods)
    args = (wreq.init_state, wreq.steps, wreq.statics, wreq.level_iters)
    J = int(wreq.steps.count.shape[0])
    err1, plain_ms = hold_bit_equal(wreq, "gangs scan 1", grids=(0, 2))
    _, takes1, _ = cuda_ffd.cuda_ffd_solve(*args)
    failed = gangsched._step_failed(takes1, wreq.gang_of_step, wreq.gang_min)
    if not bool(failed.any()):
        raise AssertionError("gangs: no gang rolled back")
    req2 = dataclasses.replace(wreq, steps=wreq.steps._replace(
        count=torch.where(failed, torch.zeros_like(wreq.steps.count),
                          wreq.steps.count)))
    err2, plain2_ms = hold_bit_equal(req2, "gangs scan 2", grids=(0, 2))
    ms = _time_ms(lambda: cuda_ffd.cuda_ffd_solve(*args), 5)
    blocks = cuda_ffd.counter.blocks  # the full grid's
    gang_ms = _time_ms(lambda: cuda_ffd.cuda_gang_solve(
        wreq.init_state, wreq.steps, wreq.statics, wreq.gang_of_step,
        wreq.gang_min, wreq.level_iters), 3)
    bound_ms, bound_by = _bound(wreq, *cuda_ffd.cuda_ffd_solve(*args))
    stages = _stage_stamps(
        lambda st: cuda_ffd.cuda_ffd_solve(*args, _stamps=st), J)
    N = int(wreq.init_state.kind.shape[0])
    print(f"gangs [cfg11, {len(pods)} pods, {len(problem[2])} existing"
          f" nodes]: {json.dumps(GANGS_EXPECTED)} on every solve (the JAX"
          " package's); two launches a"
          f" gang dispatch (a rollback), {st['rounds']} dispatches a solve"
          f" (slots {st['slots']}); cold"
          f" {times[0]:.3f} s, warm p50 {statistics.median(times[1:]):.3f} s;"
          f" phases cold {json.dumps(_phase_keys(stats[0]))} warm"
          f" {json.dumps(_phase_keys(stats[-1]))}; timed apart"
          f" {json.dumps(split)}; device idle share {idle}; both scans"
          f" bit-equal to the plain scan on {blocks} blocks and on 2 (J={J},"
          f" N={N}); scan {ms:.3f} ms ({ms / J * 1e3:.2f} us/step), gang"
          f" dispatch {gang_ms:.3f} ms, plain {plain_ms:.1f} ms; bound"
          f" {bound_ms:.4f} ms ({bound_by}); device us/step by stage"
          f" (stamps) {json.dumps(stages)}", flush=True)
    solo = dict(
        problem="cfg11_gangs", pods=len(pods), J=J, N=N,
        T=int(wreq.init_state.itmask.shape[1]), blocks=blocks,
        summary=GANGS_EXPECTED, rounds=st["rounds"], slots=st["slots"],
        cold_s=times[0],
        warm_p50_s=statistics.median(times[1:]), warm_s=times[1:],
        phases_cold=_phase_keys(stats[0]),
        phases_warm=_phase_keys(stats[-1]), timed_apart=split,
        device_idle_share=idle, launches=launches, rows=rows, unequal=0,
        max_abs_err=max(err1, err2), ms=ms, ms_per_step=ms / J,
        gang_dispatch_ms=gang_ms, plain_ms=plain_ms,
        plain2_ms=plain2_ms, bound_ms=bound_ms, bound_by=bound_by,
        stage_us_per_step=stages,
    )

    # four same-shaped gang tenants through solve_batch
    tenants = {n: gangs_problem(GANG_TENANT_PODS, pool=n)
               for n in GANG_TENANTS}
    alone = {}
    for n, prob in tenants.items():
        alone[n] = gang_summary(gang_scheduler(prob).solve(prob[3]), prob[3])
    entries = [(gang_scheduler(prob), prob[3]) for prob in tenants.values()]
    cuda_ffd.counter.reset()
    with plain_forbidden(), gang_spy() as blog:
        t0 = time.perf_counter()
        outcomes, bstats = solve_batch(entries)
        batch_s = time.perf_counter() - t0
    got = {}
    for n, (status, res) in zip(tenants, outcomes):
        if status != "ok":
            raise AssertionError(f"{n}: {status} {res!r}")
        got[n] = gang_summary(res, tenants[n][3])
    if got != alone:
        raise AssertionError(f"gang tenants batched {got} != alone {alone}")
    nodes = {n: s["nodes"] for n, s in got.items()}
    if nodes != GANG_TENANTS_EXPECTED:
        raise AssertionError(f"gang tenants {nodes} !="
                             f" {GANG_TENANTS_EXPECTED}")
    # one batched gang dispatch of 4 rows (two scans: a rollback), one
    # batched preemption pass
    if (cuda_ffd.counter.total() != 2 or cuda_ffd.counter.rows != 8
            or bstats["batched_problems"] != 8):
        raise AssertionError(
            f"gang tenants: {cuda_ffd.counter.launches} launches over"
            f" {cuda_ffd.counter.rows} rows, stats {bstats}")
    if dict(m.SOLVER_RESULT_REJECTED.values) != rejected0:
        raise AssertionError("gang tenants: the verifier rejected a result")
    bsplit = gang_split(blog)
    print(f"gang tenants [4 x {GANG_TENANT_PODS} pods]: one batched gang"
          " dispatch of 4 rows (2 launches, 8 rows) and one batched"
          f" preemption pass; each equals its solo solve; nodes {nodes};"
          f" {batch_s:.3f} s; stats {json.dumps(bstats)}; timed apart"
          f" {json.dumps(bsplit)}", flush=True)
    batched = dict(tenants=GANG_TENANTS, nodes=nodes, wall_s=batch_s,
                   stats=bstats, timed_apart=bsplit, launches=2, rows=8)
    return dict(solo=solo, batched=batched)


def _phase_keys(st):
    return {k: st.get(k) for k in ("plan_s", "prepare_s", "kernel_s",
                                   "decode_s", "verify_s")}


def topo_phase():
    """Phase 10: cfg18 rack-aware gangs on the card."""
    import torch

    from karpenter_core_tpu_torch.metrics import wiring as m
    from karpenter_core_tpu_torch.models.provisioner import _stack_trees
    from karpenter_core_tpu_torch.ops import cuda_ffd

    problem = topo_problem()
    pods, existing = problem[3], problem[2]
    sched = gang_scheduler(problem, max_slots=TOPO_SLOTS)
    rejected0 = dict(m.SOLVER_RESULT_REJECTED.values)
    ref = topo_summary(gang_scheduler(problem, "reference",
                                      max_slots=TOPO_SLOTS).solve(pods),
                       pods, existing)
    if ref != TOPO_EXPECTED:
        raise AssertionError(f"topo (reference backend): {ref} !="
                             f" {TOPO_EXPECTED}")
    times, launches, rows = [], 0, 0
    for rep in range(4):
        cuda_ffd.counter.reset()
        with plain_forbidden():
            t0 = time.perf_counter()
            res = sched.solve(pods)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        st = sched.last_phase_stats
        launches += cuda_ffd.counter.total()
        rows += cuda_ffd.counter.rows
        if st["rounds"] != 1 or cuda_ffd.counter.total() not in (1, 2):
            raise AssertionError(f"topo: solve {rep} launched"
                                 f" {cuda_ffd.counter.launches} in"
                                 f" {st['rounds']} rounds")
        got = topo_summary(res, pods, existing)
        if got != TOPO_EXPECTED:
            raise AssertionError(f"topo: solve {rep} {got} !="
                                 f" {TOPO_EXPECTED}")
    if dict(m.SOLVER_RESULT_REJECTED.values) != rejected0:
        raise AssertionError("topo: the verifier rejected a result")
    phases = _phase_keys(sched.last_phase_stats)

    req = first_request(sched, pods)
    if req.steps.topo_rank is None:
        raise AssertionError("topo: the scan carries no level plane")
    args = (req.init_state, req.steps, req.statics, req.level_iters)
    J = int(req.steps.count.shape[0])
    N = int(req.init_state.kind.shape[0])
    err, plain_ms = hold_bit_equal(req, "topo", grids=(0, 2))
    # two stacked rows: the request, and its steps with the levels reversed
    rev = req.steps._replace(
        topo_rank=(3 - req.steps.topo_rank).contiguous())
    state = _stack_trees([req.init_state, req.init_state])
    steps = _stack_trees([req.steps, rev])
    statics = _stack_trees([req.statics, req.statics])
    _, berr, bplain_ms = hold_batched_bit_equal(
        state, steps, statics, req.level_iters, ["topo", "topo-reversed"],
        grids=(0, 2))
    ms = _time_ms(lambda: cuda_ffd.cuda_ffd_solve(*args), 5)
    blocks = cuda_ffd.counter.blocks  # the full grid's
    classic = req.steps._replace(topo_rank=None)
    classic_ms = _time_ms(lambda: cuda_ffd.cuda_ffd_solve(
        req.init_state, classic, req.statics, req.level_iters), 5)
    bound_ms, bound_by = _bound(req, *cuda_ffd.cuda_ffd_solve(*args))
    stages = _stage_stamps(
        lambda st: cuda_ffd.cuda_ffd_solve(*args, _stamps=st), J)
    print(f"topo [cfg18, {len(pods)} pods, {len(existing)} racked nodes]:"
          f" {json.dumps(TOPO_EXPECTED)} on every solve (the JAX package's),"
          f" as through the plain version; launches {launches} over 4"
          f" solves; cold {times[0]:.3f} s, warm p50"
          f" {statistics.median(times[1:]):.3f} s; phases"
          f" {json.dumps(phases)}; the level-grouped scan bit-equal to the"
          f" plain scan on {blocks} blocks and on 2 (J={J}, N={N}), and"
          " batched (2 rows, one with the levels reversed) to the plain"
          " batched scan and row by row to the solo kernel; scan"
          f" {ms:.3f} ms ({ms / J * 1e3:.2f} us/step) vs the same steps"
          f" without the plane {classic_ms:.3f} ms, plain {plain_ms:.1f}"
          f" ms; bound {bound_ms:.4f} ms ({bound_by}); device us/step by"
          f" stage (stamps) {json.dumps(stages)}", flush=True)
    return dict(
        problem="cfg18_topoaware", pods=len(pods), J=J, N=N,
        T=int(req.init_state.itmask.shape[1]), blocks=blocks,
        summary=TOPO_EXPECTED, cold_s=times[0],
        warm_p50_s=statistics.median(times[1:]), warm_s=times[1:],
        phases_warm=phases, launches=launches, rows=rows, unequal=0,
        max_abs_err=max(err, berr), ms=ms, ms_per_step=ms / J,
        classic_ms=classic_ms, plain_ms=plain_ms,
        plain_batched_ms=bplain_ms, bound_ms=bound_ms, bound_by=bound_by,
        stage_us_per_step=stages,
    )


# ---------------------------------------------------------------------------
# the relax backend (phase 11); solverd (phase 12)

RELAX_PODS, RELAX_SLOTS = 5000, 4096
RELAX_MODES = ("ffd", "relax")
# cold, settle, three warm (bench.py _relax_bench's sequence)
RELAX_SOLVES = ("cold", "settle", "warm", "warm", "warm")


def _relax_expected(nodes, cost, digest, moves=None):
    """The summaries of one (problem, mode) over ``RELAX_SOLVES``: ffd mode
    (``moves`` None) has no relax outcome; relax mode wins cold and again
    at the settled slot width, then serves its cached verdict."""
    base = dict(nodes=nodes, cost=cost, unschedulable=0, digest=digest)
    if moves is None:
        return [dict(base, outcome=None, template_moves=None)
                for _ in RELAX_SOLVES]
    return ([dict(base, outcome="won", template_moves=moves)] * 2
            + [dict(base, outcome="cached_won", template_moves=None)] * 3)


# the JAX package's answer for every solve of phase 11 (its DeviceScheduler,
# xla backend, on the CPU): ``JAX_PLATFORMS=cpu python3 fleet_expected.py
# relax`` recomputes it
RELAX_EXPECTED = {
    "cfg3_shape": {
        "ffd": _relax_expected(588, 48.231, "0b31a0a9fdfe318a"),
        "relax": _relax_expected(301, 40.111, "f68352bf364488ac", moves=64),
    },
    "cfg11_shape": {
        "ffd": _relax_expected(565, 46.345, "a2f849b07d2d8b67"),
        "relax": _relax_expected(140, 34.451, "3c58ded48d292e21", moves=109),
    },
}


def relax_problems(n_pods=None):
    """problem -> pods factory: bench.py ``_relax_bench``'s two shapes."""
    n = RELAX_PODS if n_pods is None else n_pods
    return {
        "cfg3_shape": lambda: _topology_pods(n, n_deploys=max(n // 500, 2)),
        "cfg11_shape": lambda: _gang_tier_pods(n),
    }


def relax_scheduler(mode, kernel_backend="cuda"):
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler

    pools, its = relax_world()
    return DeviceScheduler(pools, its, max_slots=RELAX_SLOTS,
                           solver_mode=mode, kernel_backend=kernel_backend,
                           device="cuda")


def relax_summary(res, pods, stats):
    """What phase 11 holds a solve to: nodes, $-cost, unschedulable pods,
    the relax outcome and template moves (None in ffd mode), and a digest
    of the result (``_canonical``, errors keyed by pod name)."""
    name_of = {p.uid: p.name for p in pods}
    claims, bound, errors = _canonical(res)
    errors = sorted((name_of.get(u, u), msg) for u, msg in errors)
    rstats = stats.get("relax") or {}
    return dict(nodes=res.node_count(), cost=round(result_cost(res), 3),
                unschedulable=len(res.pod_errors),
                outcome=rstats.get("outcome"),
                template_moves=rstats.get("template_moves"),
                digest=_sha([claims, bound, errors]))


@contextlib.contextmanager
def relax_spy():
    """Record every dispatch the solve generators hand the solo and batched
    runners (kind, whether batched, rows, the kernel launches and rows it
    made, its wall with the device synchronised), keeping each request,
    and every ``relax_score`` (the two costs of each verdict)."""
    import torch

    from karpenter_core_tpu_torch.models import provisioner as prov
    from karpenter_core_tpu_torch.ops import cuda_ffd
    from karpenter_core_tpu_torch.ops import relax as relax_ops

    log = {"dispatches": [], "scores": []}
    solo, batched, score = (prov._run_kernel_solo, prov._run_kernel_batched,
                            relax_ops.relax_score)

    def record(reqs, fn, is_batched):
        n0, r0 = cuda_ffd.counter.total(), cuda_ffd.counter.rows
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        log["dispatches"].append(dict(
            kind=reqs[0].kind, batched=is_batched, rows=len(reqs),
            gang=reqs[0].gang_of_step is not None,
            launches=cuda_ffd.counter.total() - n0,
            launch_rows=cuda_ffd.counter.rows - r0,
            s=time.perf_counter() - t0, reqs=reqs))
        return out

    def spy_solo(req):
        return record([req], lambda: solo(req), False)

    def spy_batched(reqs):
        return record(list(reqs), lambda: batched(reqs), True)

    def spy_score(state, tmpl_price, unplaced_bc):
        out = score(state, tmpl_price, unplaced_bc)
        log["scores"].append(float(out[2]))
        return out

    prov._run_kernel_solo, prov._run_kernel_batched = spy_solo, spy_batched
    relax_ops.relax_score = spy_score
    try:
        yield log
    finally:
        prov._run_kernel_solo, prov._run_kernel_batched = solo, batched
        relax_ops.relax_score = score


def _solve_dispatches(dispatches):
    """A solve's dispatches as kinds, the scans named by role: a scan after
    a relax dispatch is the candidate."""
    kinds, after_relax = [], False
    for d in dispatches:
        if d["kind"] == "relax":
            kinds.append("relax")
            after_relax = True
        elif d["kind"] == "solve":
            kinds.append("candidate" if after_relax else "scan")
            after_relax = False
        else:
            kinds.append(d["kind"])
    return kinds


def _expected_kinds(outcome, rounds):
    """The dispatches of a solve of ``rounds`` rounds whose last round
    ended with this relax outcome: each earlier round overflowed its slot
    axis after its scan (the solve regrows it), so it made that scan
    alone."""
    per_round = {
        None: ["scan"], "cached_won": ["scan"], "cached_kept_ffd": ["scan"],
        "infeasible": ["scan"], "deadline": ["scan"],
        "noop": ["scan", "relax"],
        "won": ["scan", "relax", "candidate"],
        "lost": ["scan", "relax", "candidate"],
        "overflow": ["scan", "relax", "candidate"],
    }[outcome]
    return ["scan"] * (rounds - 1) + per_round


def check_relax_launches(log, start, outcome, rounds, what):
    """Raise unless the solve's dispatches are the ones its outcome makes
    and every scan went through the kernel: one launch a plain scan, one
    or two (a rollback) a gang dispatch, one problem row each."""
    mine = log["dispatches"][start:]
    kinds = _solve_dispatches(mine)
    for d, role in zip(mine, kinds):
        d["role"] = role
    if kinds != _expected_kinds(outcome, rounds):
        raise AssertionError(f"{what}: dispatches {kinds} for outcome"
                             f" {outcome} in {rounds} rounds")
    for d in mine:
        if d["kind"] != "solve":
            if d["launches"]:
                raise AssertionError(f"{what}: a {d['kind']} dispatch"
                                     " launched the scan kernel")
            continue
        allowed = (1, 2) if d["gang"] else (1,)
        if d["launches"] not in allowed or d["launch_rows"] != d["launches"]:
            raise AssertionError(f"{what}: a scan dispatch made"
                                 f" {d['launches']} launches over"
                                 f" {d['launch_rows']} rows")
    return kinds, sum(d["launches"] for d in mine)


def hold_scan_and_rollback(req, what, grids=(0, 2)):
    """Hold a scan request bit-equal to the plain scan on ``grids``; for a
    gang dispatch whose first scan fails a gang, its rollback scan too.
    Returns (largest abs error (0.0), plain ms, scans held)."""
    import dataclasses

    import torch

    from karpenter_core_tpu_torch.ops import cuda_ffd, gangsched

    err, plain_ms = hold_bit_equal(req, what, grids=grids)
    held = 1
    if req.gang_of_step is not None:
        _, takes1, _ = cuda_ffd.cuda_ffd_solve(
            req.init_state, req.steps, req.statics, req.level_iters)
        failed = gangsched._step_failed(takes1, req.gang_of_step,
                                        req.gang_min)
        if bool(failed.any()):
            req2 = dataclasses.replace(req, steps=req.steps._replace(
                count=torch.where(failed, torch.zeros_like(req.steps.count),
                                  req.steps.count)))
            err2, _ = hold_bit_equal(req2, f"{what} rollback", grids=grids)
            err, held = max(err, err2), 2
    return err, plain_ms, held


def _device_kernels(fn):
    """CUDA kernels one call of ``fn`` launches (torch.profiler); None when
    the profiler recorded no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA"))
    return n or None


def hold_relax_choose(req, what):
    """``relax_choose`` on the card against the port's on the CPU for the
    same planes: the integral outputs must be equal; returns the iterates'
    largest absolute drift, its time by CUDA events and the device kernels
    one call launches."""
    import torch

    from karpenter_core_tpu_torch.ops import relax as relax_ops

    kw = dict(iters=req.relax_iters, num_gangs=req.relax_gangs)
    on_card = relax_ops.relax_choose(*req.relax, **kw)
    cpu_planes = [x.cpu() for x in req.relax]
    on_cpu = relax_ops.relax_choose(*cpu_planes, **kw)
    for name, a, b in zip(("new_template", "kstar", "changed"), on_card,
                          on_cpu):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"{what}: relax_choose {name} on the card"
                                 " != on the CPU")

    def iterates(planes):
        viable, _kcs, k_node, podcost, counts, gang_id, _bt, _bk, warm = (
            planes[:9])
        topo = planes[9] if len(planes) > 9 else None
        return relax_ops._relax_iterates(
            *(None if x is None else x.unsqueeze(0) for x in (
                viable, k_node, podcost, counts, gang_id, warm, topo)),
            **kw)[0]

    drift = _max_abs_err(iterates(req.relax).cpu(), iterates(cpu_planes))
    ms = _time_ms(lambda: relax_ops.relax_choose(*req.relax, **kw), 5)
    kernels = _device_kernels(lambda: relax_ops.relax_choose(*req.relax,
                                                             **kw))
    C, S = (int(n) for n in req.relax[0].shape)
    return dict(C=C, S=S, iters=req.relax_iters, gangs=req.relax_gangs,
                changed=int(on_card[2]), max_float_drift=drift, ms=ms,
                device_kernels_per_call=kernels)


def relax_phase():
    """Phase 11: the relax backend on the card."""
    import torch

    from karpenter_core_tpu_torch.metrics import wiring as m
    from karpenter_core_tpu_torch.models.provisioner import solve_batch
    from karpenter_core_tpu_torch.ops import cuda_ffd
    from karpenter_core_tpu_torch.ops import relax as relax_ops

    rejected0 = dict(m.SOLVER_RESULT_REJECTED.values)
    rows, launches, cand_launches, cand_rows, relax_calls = {}, 0, 0, 0, 0
    margins = []
    held = {}
    for pname, make in relax_problems().items():
        pods = make()
        rows[pname] = {}
        for mode in RELAX_MODES:
            expected = RELAX_EXPECTED[pname][mode]
            sched = relax_scheduler(mode)
            times, phases, kinds = [], [], []
            with relax_spy() as log:
                for i, role in enumerate(RELAX_SOLVES):
                    start = len(log["dispatches"])
                    cuda_ffd.counter.reset()
                    with plain_forbidden():
                        t0 = time.perf_counter()
                        res = sched.solve(pods)
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                    st = dict(sched.last_phase_stats)
                    got = relax_summary(res, pods, st)
                    if got != expected[i]:
                        raise AssertionError(
                            f"relax [{pname} {mode}] {role} solve {i}:"
                            f" {got} != {expected[i]}")
                    k, n = check_relax_launches(
                        log, start, got["outcome"], st["rounds"],
                        f"relax [{pname} {mode}] solve {i}")
                    if n != cuda_ffd.counter.total():
                        raise AssertionError(f"relax [{pname} {mode}]: the"
                                             " counter disagrees")
                    kinds.append(k)
                    phases.append(_phase_keys(st))
                    launches += n
            scores = list(log["scores"])
            for a, b in zip(scores[::2], scores[1::2]):
                margins.append(abs(b - a) / a if a else None)
            cands = [d for d in log["dispatches"]
                     if d["role"] == "candidate"]
            cand_launches += sum(d["launches"] for d in cands)
            cand_rows += sum(d["launch_rows"] for d in cands)
            relax_calls += sum(d["kind"] == "relax"
                               for d in log["dispatches"])
            row = dict(
                summaries=expected, cold_s=times[0], settle_s=times[1],
                warm_s=times[2:], warm_p50_s=statistics.median(times[2:]),
                dispatches=kinds, phases_cold=phases[0],
                phases_warm=phases[-1])
            if mode == "relax":
                # the plain version's cold solve: the same answer
                ref = relax_scheduler(mode, "reference")
                ref_res = ref.solve(pods)
                ref_got = relax_summary(ref_res, pods, ref.last_phase_stats)
                if ref_got != expected[0]:
                    raise AssertionError(f"relax [{pname}] reference cold"
                                         f" {ref_got} != {expected[0]}")
                relax_req = next(d["reqs"][0] for d in log["dispatches"]
                                 if d["kind"] == "relax")
                cand = cands[0]["reqs"][0]
                err, plain_ms, n_held = hold_scan_and_rollback(
                    cand, f"relax [{pname}] candidate")
                args = (cand.init_state, cand.steps, cand.statics,
                        cand.level_iters)
                J = int(cand.steps.count.shape[0])
                N = int(cand.init_state.kind.shape[0])
                ms = _time_ms(lambda: cuda_ffd.cuda_ffd_solve(*args), 5)
                blocks = cuda_ffd.counter.blocks
                bound_ms, bound_by = _bound(
                    cand, *cuda_ffd.cuda_ffd_solve(*args))
                stages = _stage_stamps(
                    lambda st: cuda_ffd.cuda_ffd_solve(*args, _stamps=st), J)
                choose = hold_relax_choose(relax_req, f"relax [{pname}]")
                held[pname] = dict(
                    J=J, N=N, T=int(cand.init_state.itmask.shape[1]),
                    blocks=blocks, gang=cand.gang_of_step is not None,
                    scans_held=n_held, unequal=0, max_abs_err=err, ms=ms,
                    ms_per_step=ms / J, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    stage_us_per_step=stages, relax_choose=choose)
                row["candidate"] = held[pname]
            rows[pname][mode] = row
            print(f"relax [{pname} {mode}]: {len(pods)} pods, every solve"
                  " the JAX package's (nodes, cost, unschedulable, outcome,"
                  f" template moves, digest): {json.dumps(expected[0])} cold,"
                  f" {json.dumps(expected[-1])} warm; dispatches"
                  f" {json.dumps(kinds)}; cold {times[0]:.3f} s, settle"
                  f" {times[1]:.3f} s, warm p50 {row['warm_p50_s']:.4f} s;"
                  f" phases warm {json.dumps(phases[-1])}", flush=True)
            if mode == "relax":
                h = held[pname]
                print(f"relax [{pname}] candidate scan (J={h['J']},"
                      f" N={h['N']}, gang {h['gang']}): {h['scans_held']}"
                      " scan(s) bit-equal to the plain scan on"
                      f" {h['blocks']} blocks and on 2; {h['ms']:.3f} ms"
                      f" ({h['ms_per_step'] * 1e3:.2f} us/step) vs plain"
                      f" {h['plain_ms']:.1f} ms; bound {h['bound_ms']:.4f}"
                      f" ms ({h['bound_by']}); device us/step by stage"
                      f" (stamps) {json.dumps(h['stage_us_per_step'])};"
                      " relax_choose on the card equal to the CPU's"
                      f" integral outputs: {json.dumps(h['relax_choose'])};"
                      " the plain version's cold solve equal", flush=True)
    if dict(m.SOLVER_RESULT_REJECTED.values) != rejected0:
        raise AssertionError("relax: the verifier rejected a result")
    print(f"relax verdict margins |cost_r - cost_f| / cost_f:"
          f" {json.dumps(margins)}", flush=True)

    # the relax tenants through solve_batch: two of each problem
    tenants = [(p, k) for p in relax_problems() for k in range(2)]
    pods_of = {p: make() for p, make in relax_problems().items()}
    entries = [(relax_scheduler("relax"), pods_of[p]) for p, _k in tenants]
    cuda_ffd.counter.reset()
    with plain_forbidden(), relax_spy() as blog:
        t0 = time.perf_counter()
        outcomes, bstats = solve_batch(entries)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
    for (p, k), (sched, pods), (status, res) in zip(tenants, entries,
                                                     outcomes):
        if status != "ok":
            raise AssertionError(f"relax tenant {p}/{k}: {status} {res!r}")
        got = relax_summary(res, pods, sched.last_phase_stats)
        if got != RELAX_EXPECTED[p]["relax"][0]:
            raise AssertionError(f"relax tenant {p}/{k}: {got} != its solo"
                                 f" {RELAX_EXPECTED[p]['relax'][0]}")
    b_relax = [d for d in blog["dispatches"]
               if d["kind"] == "relax" and d["batched"]]
    b_scans = [d for d in blog["dispatches"]
               if d["kind"] == "solve" and d["batched"]]
    # the dispatcher answers every tenant's baseline before any relax
    # dispatch, and the candidates after them
    first_relax = next((i for i, d in enumerate(blog["dispatches"])
                        if d["kind"] == "relax"), len(blog["dispatches"]))
    b_cands = [d for d in blog["dispatches"][first_relax:]
               if d["kind"] == "solve" and d["batched"]]
    if len(b_relax) != 2 or len(b_scans) != 4 or len(b_cands) != 2:
        raise AssertionError(
            f"relax tenants: {len(b_relax)} batched relax dispatches and"
            f" {len(b_scans)} batched scan dispatches, stats {bstats}")
    for d in b_relax:  # each row of the batched choose equals its solo
        reqs = d["reqs"]
        stacked = [torch.stack([r.relax[i] for r in reqs])
                   for i in range(len(reqs[0].relax))]
        kw = dict(iters=reqs[0].relax_iters, num_gangs=reqs[0].relax_gangs)
        nt_b, ks_b, ch_b = relax_ops.relax_choose_batched(*stacked, **kw)
        for b, r in enumerate(reqs):
            nt, ks, ch = relax_ops.relax_choose(*r.relax, **kw)
            if not (torch.equal(nt, nt_b[b]) and torch.equal(ks, ks_b[b])
                    and int(ch) == int(ch_b[b])):
                raise AssertionError("relax tenants: a batched choose row"
                                     " != its solo choose")
    b_launches = sum(d["launches"] for d in b_scans)
    b_rows = sum(d["launch_rows"] for d in b_scans)
    print(f"relax tenants [2 x cfg3_shape, 2 x cfg11_shape]: each equals"
          f" its solo cold solve; 2 batched relax_choose dispatches (each"
          f" row equal to its solo choose) and 4 batched scans (baseline"
          f" and candidate of each pair), {b_launches} launches over"
          f" {b_rows} rows; {batch_s:.3f} s; stats {json.dumps(bstats)}",
          flush=True)
    for d in b_cands:
        cand_launches += d["launches"]
        cand_rows += d["launch_rows"]
    launches += b_launches
    first = held["cfg3_shape"]
    return dict(
        problems=rows, launches=launches, candidate_launches=cand_launches,
        candidate_rows=cand_rows, relax_dispatches=relax_calls,
        margins=margins, held=held, batched=dict(
            wall_s=batch_s, stats=bstats, launches=b_launches,
            rows=b_rows),
        ms=first["ms"], plain_ms=first["plain_ms"],
        bound_ms=first["bound_ms"], bound_by=first["bound_by"],
        blocks=first["blocks"], ms_per_step=first["ms_per_step"],
        stage_us_per_step=first["stage_us_per_step"],
        max_abs_err=max(h["max_abs_err"] for h in held.values()),
    )


def _solverd_problems():
    """problem -> (pools, instance types, pods factory, max_slots, mode):
    phase 4's two 5k shapes and phase 11's relax cfg3 shape."""
    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog

    out = {}
    for name in ("plain_5k_400", "topology_5k_400"):
        make, n_types, max_slots = problems()[name]
        pool = _pool()
        out[name] = ([pool], {pool.name: list(bench_catalog(n_types))},
                     make, max_slots, "ffd")
    pools, its = relax_world()
    out["relax_cfg3_shape"] = (pools, its,
                               relax_problems()["cfg3_shape"],
                               RELAX_SLOTS, "relax")
    return out


def _wire_view(data):
    """A solve-result wire without its timing field."""
    from karpenter_core_tpu_torch.solver import codec

    h = codec.decode_solve_results(data)
    h.pop("solve_seconds", None)
    return h


def _rpc_failures():
    """Every RPC failure the port's sidecar clients have counted."""
    from karpenter_core_tpu_torch.metrics import wiring as m

    return sum(m.SOLVER_RPC_FAILURES.values.values())


def _rpc_fallbacks():
    """Every solve or sweep the port's sidecar clients degraded to the
    host (the greedy Scheduler, the binary search). A member whose kernel
    fails to build or launch is answered so, so a sidecar phase holds this
    count still."""
    from karpenter_core_tpu_torch.metrics import wiring as m

    return sum(m.SOLVER_RPC_FALLBACKS.values.values())


def solverd_phase():
    """Phase 12: the port's solverd on the card: an in-process daemon on a
    loopback port against in-process solves, then the operator with a
    spawned sidecar."""
    import threading

    import torch

    from karpenter_core_tpu_torch.metrics import wiring as m
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler
    from karpenter_core_tpu_torch.operator import Options
    from karpenter_core_tpu_torch.ops import cuda_ffd
    from karpenter_core_tpu_torch.solver import codec, remote, service
    from karpenter_core_tpu_torch.solver import fleet as fleetmod

    # the CLI's gateway defaults (max batch 8, 2 ms window), device cuda,
    # kernel cuda
    daemon = service.SolverDaemon(gateway=fleetmod.FleetGateway(
        max_batch=fleetmod.DEFAULT_MAX_BATCH,
        batch_window=fleetmod.DEFAULT_BATCH_WINDOW_MS / 1000.0))
    daemon.warm_up()
    answers = []
    solve = daemon.solve

    def spy_solve(body, **kw):
        out = solve(body, **kw)
        answers.append(out[0])
        return out

    daemon.solve = spy_solve
    srv = service.serve(0, daemon=daemon)
    addr = f"127.0.0.1:{srv.server_address[1]}"
    rejected0 = dict(m.SOLVER_RESULT_REJECTED.values)
    failures0, fallbacks0 = _rpc_failures(), _rpc_fallbacks()
    rows, launches = {}, 0
    try:
        for name, (pools, its, make, max_slots, mode) in (
                _solverd_problems().items()):
            pods = make()
            reset_name_counters()
            sched = DeviceScheduler(pools, its, max_slots=max_slots,
                                    solver_mode=mode)
            with plain_forbidden():
                t0 = time.perf_counter()
                local = sched.solve(pods)
                torch.cuda.synchronize()
                local_s = time.perf_counter() - t0
            local_wire = _wire_view(codec.encode_solve_results(local, 0.0))
            reset_name_counters()
            client = remote.SolverClient(addr, timeout=600)
            rs = remote.RemoteScheduler(client, pools, its,
                                        device_scheduler_opts=dict(
                                            max_slots=max_slots,
                                            solver_mode=mode))
            n_answers = len(answers)
            cuda_ffd.counter.reset()
            with plain_forbidden():
                t0 = time.perf_counter()
                res = rs.solve(pods)
                rpc_s = time.perf_counter() - t0
            grew = cuda_ffd.counter.total()
            launches += grew
            if len(answers) != n_answers + 1:
                raise AssertionError(f"solverd [{name}]: the daemon did not"
                                     " answer the solve")
            if _wire_view(answers[-1]) != local_wire:
                raise AssertionError(f"solverd [{name}]: the daemon's wire"
                                     " != the in-process solve's")
            if (res.node_count() != local.node_count()
                    or set(res.pod_errors) != set(local.pod_errors)):
                raise AssertionError(f"solverd [{name}]: the materialized"
                                     " result differs")
            if grew < 1:
                raise AssertionError(f"solverd [{name}]: no kernel launch")
            if _rpc_fallbacks() != fallbacks0:
                raise AssertionError(f"solverd [{name}]: the solve degraded"
                                     " to the host greedy Scheduler")
            rows[name] = dict(nodes=res.node_count(), rpc_s=rpc_s,
                              inproc_s=local_s, launches=grew,
                              cuda_ffd_rows=cuda_ffd.counter.rows)
            print(f"solverd [{name}]: the daemon's wire equals the"
                  f" in-process solve's ({res.node_count()} nodes, mode"
                  f" {mode}); RPC wall {rpc_s:.3f} s vs in-process"
                  f" {local_s:.3f} s (both cold); {grew} kernel launches in"
                  " the daemon", flush=True)

        # the fleet batch's tenants at the same daemon at once
        tenants = fleet()
        results, errors = {}, []

        def one(name, make):
            try:
                pool = _pool(name)
                from karpenter_core_tpu_torch.cloudprovider.kwok import (
                    bench_catalog,
                )

                rs = remote.RemoteScheduler(
                    remote.SolverClient(addr, timeout=600, tenant=name),
                    [pool], {name: list(bench_catalog(FLEET_TYPES))},
                    device_scheduler_opts=dict(max_slots=FLEET_SLOTS))
                results[name] = rs.solve(make())
            except Exception as e:  # reported below, on the main thread
                errors.append((name, repr(e)))

        pods_of = {n: make for n, (make, _k) in tenants.items()}
        coalesced0 = daemon.gateway.batch_stats()["coalesced"]
        cuda_ffd.counter.reset()
        threads = [threading.Thread(target=one, args=(n, mk))
                   for n, mk in pods_of.items()]
        t0 = time.perf_counter()
        with plain_forbidden():
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        fleet_s = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"solverd fleet: {errors}")
        got = {n: r.node_count() for n, r in results.items()}
        if got != FLEET_EXPECTED_NODES:
            raise AssertionError(f"solverd fleet: {got} !="
                                 f" {FLEET_EXPECTED_NODES}")
        stats = daemon.gateway.batch_stats()
        coalesced = stats["coalesced"] - coalesced0
        if coalesced < 2:
            raise AssertionError(f"solverd fleet: the gateway coalesced"
                                 f" {coalesced} problems ({stats})")
        fleet_launches = cuda_ffd.counter.total()
        launches += fleet_launches
        if fleet_launches < 1:
            raise AssertionError("solverd fleet: no kernel launch")
        if _rpc_failures() != failures0:
            raise AssertionError(f"solverd: an RPC failed"
                                 f" ({dict(m.SOLVER_RPC_FAILURES.values)})")
        if _rpc_fallbacks() != fallbacks0:
            raise AssertionError(f"solverd: a solve degraded to greedy"
                                 f" ({dict(m.SOLVER_RPC_FALLBACKS.values)})")
        if dict(m.SOLVER_RESULT_REJECTED.values) != rejected0:
            raise AssertionError("solverd: the client's verifier rejected a"
                                 " result")
        print(f"solverd fleet [11 tenants at once]: each tenant's node count"
              f" the JAX package's; the gateway coalesced {coalesced}"
              f" problems onto leaders' grants ({json.dumps(stats)});"
              f" {fleet_launches} launches over {cuda_ffd.counter.rows} rows;"
              f" {fleet_s:.3f} s; no failed RPC, no fallback, no verifier"
              " rejection", flush=True)
    finally:
        srv.shutdown()
        srv.server_close()

    # the operator with a spawned sidecar (device cuda, kernel cuda)
    ns = port_classes()
    errors0 = dict(m.RECONCILE_ERRORS.values)
    rejected0 = dict(m.SOLVER_RESULT_REJECTED.values)
    failures0, fallbacks0 = _rpc_failures(), _rpc_fallbacks()
    reset_name_counters()
    t0 = time.perf_counter()
    op, run = provisioning_scenario(
        ns, Options(solver="tpu", solver_mode="sidecar"))
    spawn_s = time.perf_counter() - t0
    try:
        sup = op.solver_supervisor
        if sup is None or not sup.alive():
            raise AssertionError("solverd operator: no live sidecar")
        with operator_spy() as log:
            t0 = time.perf_counter()
            passes = run()
            wall = time.perf_counter() - t0
        check_operator_run(op, log, "solverd operator", errors0, rejected0,
                           0, launched=False)
        if log["solves"]:
            raise AssertionError("solverd operator: solved in process")
        outcome = operator_outcome(op)
        if not outcome[2] or list(outcome[:2]) != list(
                OPERATOR_EXPECTED["provisioning"]):
            raise AssertionError(f"solverd operator: {outcome}, the JAX"
                                 " operator's"
                                 f" {OPERATOR_EXPECTED['provisioning']}")
        if _rpc_failures() != failures0:
            raise AssertionError(f"solverd operator: an RPC failed"
                                 f" ({dict(m.SOLVER_RPC_FAILURES.values)})")
        if _rpc_fallbacks() != fallbacks0:
            raise AssertionError(f"solverd operator: a solve degraded to"
                                 f" greedy"
                                 f" ({dict(m.SOLVER_RPC_FALLBACKS.values)})")
        member_launches = _member_health(sup.addr)["kernel_launches"]
        if member_launches < 1:
            raise AssertionError("solverd operator: the sidecar launched"
                                 " no kernel")
        child = sup.command
    finally:
        op.shutdown()
    if op.solver_supervisor.alive():
        raise AssertionError("solverd operator: the sidecar outlived"
                             " shutdown")
    print(f"solverd operator [provisioning, spawned sidecar {child[2]}]:"
          f" {outcome[0]} nodes, {outcome[1]} cpu, every pod bound (the JAX"
          f" operator's); {passes} passes in {wall:.3f} s (spawn and"
          f" operator build {spawn_s:.3f} s); {member_launches} launches"
          " in the sidecar; no reconcile error, no verifier rejection, no"
          " failed RPC, no fallback, readyz true; the sidecar stopped with"
          " the operator", flush=True)
    return dict(problems=rows, launches=launches,
                fleet=dict(wall_s=fleet_s, coalesced=coalesced, stats=stats,
                           launches=fleet_launches),
                operator=dict(nodes=outcome[0], cpu=outcome[1],
                              passes=passes, wall_s=wall, spawn_s=spawn_s,
                              member_launches=member_launches))


# ---------------------------------------------------------------------------
# entry points and the twin (phase 13)

# the port's twin on the reference's macro scenario (tests/test_twin.py
# TestTwinSoak.test_macro_run_ledger_sane, with solver="tpu"): the JAX
# twin's ledger (JAX_PLATFORMS=cpu python3 fleet_expected.py twin)
TWIN_EXPECTED = {
    "ledger_sha256":
        "40a097428b8f8632df811f722c60cf80874dd4a97049c1d4b9ced377b824ff37",
    "bound": 1890, "peak_nodes": {"0": 44, "1": 12},
    "cost_dollar_hours": {"0": 50.030418, "1": 21.65484},
}
# phase 13d: the reference's storm fleet scenario (tests/test_twin.py
# _storm_fleet_scenario): the JAX twin's ledger and its greedy fallbacks
# (JAX_PLATFORMS=cpu python3 fleet_expected.py storm)
STORM_EXPECTED = {
    "ledger_sha256":
        "97c57116a32d0dbf678b1649c5e89a4bb28c0f87b328215020ebac8c392d1047",
    "bound": 40, "peak_nodes": {"0": 2, "1": 1},
    "cost_dollar_hours": {"0": 0.014719, "1": 0.027342},
    "rpc_fallbacks": 3,
}
# phase 13b: plain_5k_400's pod mix over HTTP, cut to its first 500 pods:
# the operator's host work over HTTP grows with pods x claims (PodEvents
# lists every NodeClaim on every pod event, one HTTP round trip and a
# decode of every claim each), too long at 5,000 for the smoke's budget
# (PERF.md)
HTTP_PODS, HTTP_TYPES = 500, 400
HTTP_EXPECTED = [17, 425.0]


def binary_run(solver="tpu"):
    """Run the port's binary as a user starts it, from the root of the
    checkout (``python -m karpenter_core_tpu_torch.main --solver <solver>
    --max-iters 3 --health-port -1 --poll-interval 0.5``); while it runs,
    GET its
    ``/healthz``, ``/readyz`` and ``/metrics`` at the listen address it
    logs. Returns its exit code, each route's status, whether stderr holds
    a traceback, the address and the wall."""
    import re
    import urllib.error
    import urllib.request

    cmd = [sys.executable, "-m", "karpenter_core_tpu_torch.main",
           "--solver", solver, "--max-iters", "3", "--health-port", "-1",
           "--poll-interval", "0.5"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines, routes, addr = [], {}, None
    try:
        for line in proc.stderr:
            lines.append(line)
            found = re.search(r"health/metrics on [^:\s]+:(\d+)", line)
            if found:
                addr = f"127.0.0.1:{found.group(1)}"
                break
        for path in ("/healthz", "/readyz", "/metrics"):
            if addr is None:
                break
            try:
                with urllib.request.urlopen(f"http://{addr}{path}",
                                            timeout=10) as r:
                    r.read()
                    routes[path] = r.status
            except urllib.error.HTTPError as e:
                routes[path] = e.code
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    stderr = "".join(lines) + (err or "")
    return dict(rc=proc.returncode, routes=routes, addr=addr,
                traceback="Traceback" in stderr, wall_s=time.perf_counter()
                - t0, stderr_tail=stderr[-2000:])


@contextlib.contextmanager
def http_apiserver():
    """The port's HTTP apiserver (``python -m
    karpenter_core_tpu_torch.kube.httpserver --port 0``) in a child
    process; yields its port and stops it on exit."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "karpenter_core_tpu_torch.kube.httpserver",
         "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        if "listening on" not in line:
            raise AssertionError(f"httpserver did not start: {line!r}")
        yield int(line.strip().rsplit(":", 1)[1])
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def http_operator_run(port, options, pods, catalog, pool=None):
    """``Operator(kube=HttpKubeClient(...), options=options)`` against the
    apiserver on ``port``: the pool and ``pods`` are created through the
    client, then ``run_until_idle(disrupt=False)``. A second, independent
    client reads the outcome back from the server. Returns the operator,
    the spy's log, the passes, the wall and the read-back
    (nodes, cpu, every pod bound, bound pods)."""
    from karpenter_core_tpu_torch.cloudprovider.kwok import KwokCloudProvider
    from karpenter_core_tpu_torch.kube.httpclient import HttpKubeClient
    from karpenter_core_tpu_torch.operator import Operator

    client = HttpKubeClient("127.0.0.1", port)
    client.create(pool or _pool())
    for pod in pods:
        client.create(pod)
    op = Operator(kube=client, options=options,
                  cloud_provider=KwokCloudProvider(client, catalog))
    try:
        with operator_spy() as log:
            t0 = time.perf_counter()
            passes = op.run_until_idle(disrupt=False)
            wall = time.perf_counter() - t0
    except BaseException:
        op.shutdown()
        raise
    probe = HttpKubeClient("127.0.0.1", port)
    nodes, bound = probe.list_nodes(), probe.list_pods()
    readback = (len(nodes), sum(n.status.capacity.get("cpu", 0)
                                for n in nodes),
                all(p.node_name for p in bound),
                sum(1 for p in bound if p.node_name))
    return op, log, passes, wall, readback


def twin_scenarios():
    """The reference twin's scenarios (tests/test_twin.py), built with the
    port's classes: ``clean`` (``_clean_scenario``), ``macro``
    (TestTwinSoak.test_macro_run_ledger_sane's, with ``solver="tpu"``),
    ``storm`` (``_storm_fleet_scenario``), ``elastic``
    (``_elastic_scenario``). Each is a function of keyword overrides."""
    from karpenter_core_tpu_torch.twin import (
        FleetFault,
        Scenario,
        Storm,
        WorkloadWave,
    )

    def clean(**overrides):
        base = dict(
            seed=3, clusters=2, duration=300.0, tick=30.0, solver="greedy",
            waves=(
                WorkloadWave(at=0.0, cluster=0, kind="serving", count=80,
                             min_available=4),
                WorkloadWave(at=0.0, cluster=1, kind="training", count=64,
                             gang_size=8, priority=100),
                WorkloadWave(at=30.0, cluster=0, kind="batch", count=80,
                             lifetime=180.0),
                WorkloadWave(at=60.0, cluster=1, kind="serving", count=48,
                             min_available=2),
                WorkloadWave(at=90.0, cluster=0, kind="batch", count=40),
            ),
        )
        base.update(overrides)
        return Scenario(**base)

    def macro(**overrides):
        base = dict(
            solver="tpu", duration=3600.0 * 8, tick=600.0,
            waves=tuple(
                WorkloadWave(
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
        base.update(overrides)
        return clean(**base)

    def storm(**overrides):
        base = dict(
            seed=5, clusters=2, duration=300.0, tick=30.0, solver="tpu",
            fleet=2, wire="delta",
            rates={
                "kube.create.conflict": 0.05,
                "kube.update.conflict": 0.04,
                "cloud.create.insufficient_capacity": 0.03,
            },
            storms=(Storm(start=60.0, duration=90.0, cluster=0, head=4),),
            waves=(
                WorkloadWave(at=0.0, cluster=0, kind="serving", count=12,
                             min_available=2),
                WorkloadWave(at=30.0, cluster=1, kind="batch", count=12),
                WorkloadWave(at=150.0, cluster=0, kind="batch", count=8),
                WorkloadWave(at=210.0, cluster=1, kind="serving", count=8),
            ),
            fleet_faults=(
                FleetFault(at=90.0, kind="amnesia", member=0),
                FleetFault(at=120.0, kind="murder", member=1),
                FleetFault(at=180.0, kind="partition", cluster=0,
                           duration=60.0),
            ),
        )
        base.update(overrides)
        return Scenario(**base)

    def elastic(**overrides):
        base = dict(
            seed=11, clusters=2, duration=300.0, tick=30.0, solver="tpu",
            fleet=1, wire="delta", autoscale=True, fleet_min=1, fleet_max=2,
            waves=(
                WorkloadWave(at=0.0, cluster=0, kind="serving", count=12,
                             min_available=2),
                WorkloadWave(at=0.0, cluster=1, kind="batch", count=12,
                             lifetime=120.0),
                WorkloadWave(at=30.0, cluster=0, kind="batch", count=10,
                             lifetime=90.0),
                WorkloadWave(at=240.0, cluster=1, kind="batch", count=6),
            ),
        )
        base.update(overrides)
        return Scenario(**base)

    return dict(clean=clean, macro=macro, storm=storm, elastic=elastic)


def twin_summary(result):
    """The numbers ``TWIN_EXPECTED`` pins, from a twin's result: the
    ledger JSON's sha256, the pods bound, peak nodes and $-hours by
    cluster."""
    ledger = result.ledger.encode()
    return dict(
        ledger_sha256=hashlib.sha256(
            result.ledger_json().encode()).hexdigest(),
        bound=sum(c["n"] for c in ledger["slo"].values()),
        peak_nodes=ledger["peak_nodes"],
        cost_dollar_hours=ledger["cost_dollar_hours"],
    )


def storm_summary(result):
    """The numbers ``STORM_EXPECTED`` pins: ``twin_summary`` and the
    solves the sidecar clients degraded to the host greedy Scheduler."""
    return dict(twin_summary(result),
                rpc_fallbacks=result.counters["rpc_fallbacks"])


@contextlib.contextmanager
def fresh_counters(wiring):
    """Run with the two counters a twin's ledger carries as deltas
    (``rpc_fallbacks``, ``host_fallback_pods``) empty, as in a fresh
    process, and add their earlier counts back after. The delta of a
    counter the process never counted is ``0``, of one it did ``0.0``, and
    the ledger's JSON spells the two apart. ``wiring`` is the package's
    ``metrics/wiring`` module."""
    counters = (wiring.SOLVER_RPC_FALLBACKS, wiring.SOLVER_HOST_FALLBACK_PODS)
    saved = [dict(c.values) for c in counters]
    for c in counters:
        c.values.clear()
    try:
        yield
    finally:
        for c, before in zip(counters, saved):
            for key, v in before.items():
                c.values[key] = c.values.get(key, 0.0) + v


@contextlib.contextmanager
def launch_threads():
    """Record the thread of every scan kernel launch (the wrappers' one
    entry to the card, ``cuda_ffd._launch_batched``)."""
    import threading

    from karpenter_core_tpu_torch.ops import cuda_ffd

    threads = []
    launch = cuda_ffd._launch_batched

    def spy(*args, **kwargs):
        threads.append(threading.current_thread() is threading.main_thread())
        return launch(*args, **kwargs)

    cuda_ffd._launch_batched = spy
    try:
        yield threads
    finally:
        cuda_ffd._launch_batched = launch


def twin_phase():
    """Phase 13: the port's entry points and its twin on the card."""
    import torch

    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.metrics import wiring as m
    from karpenter_core_tpu_torch.operator import Options
    from karpenter_core_tpu_torch.ops import cuda_ffd
    from karpenter_core_tpu_torch.twin.harness import run_scenario

    out = {}
    # a. the binary
    run = binary_run("tpu")
    if run["rc"] != 0 or run["traceback"] or run["routes"] != {
            "/healthz": 200, "/readyz": 200, "/metrics": 200}:
        raise AssertionError(f"binary: {run}")
    out["binary"] = dict(wall_s=run["wall_s"], routes=run["routes"])
    print(f"binary [--solver tpu --max-iters 3]: exit 0, no traceback;"
          f" /healthz /readyz /metrics answered {run['routes']} at"
          f" {run['addr']}; {run['wall_s']:.3f} s", flush=True)

    # b. the operator over HTTP, at plain_5k_400
    errors0 = dict(m.RECONCILE_ERRORS.values)
    rejected0 = dict(m.SOLVER_RESULT_REJECTED.values)
    reset_name_counters()
    t0 = time.perf_counter()
    with http_apiserver() as port:
        cuda_ffd.counter.reset()
        with plain_forbidden():
            op, log, passes, wall, readback = http_operator_run(
                port, Options(solver="tpu", batch_max_duration=0.0,
                              batch_idle_duration=0.0),
                _plain_pods(HTTP_PODS), list(bench_catalog(HTTP_TYPES)))
        torch.cuda.synchronize()
        launches = cuda_ffd.counter.total()
        try:
            check_operator_run(op, log, "http operator", errors0, rejected0,
                               0)
        finally:
            op.shutdown()
    total_s = time.perf_counter() - t0
    scans = sum(s["scans"] for s in log["solves"])
    if not readback[2] or readback[3] != HTTP_PODS or list(
            readback[:2]) != list(HTTP_EXPECTED):
        raise AssertionError(f"http operator: read back {readback}, the JAX"
                             f" operator's {HTTP_EXPECTED}")
    if launches != scans or scans < 1:
        raise AssertionError(f"http operator: {launches} launches for"
                             f" {scans} scans")
    solve_s = sum(s["s"] for s in log["solves"])
    out["http"] = dict(nodes=readback[0], cpu=readback[1], bound=readback[3],
                       passes=passes, wall_s=wall, solve_s=solve_s,
                       other_s=wall - solve_s, solves=len(log["solves"]),
                       scans=scans, launches=launches, total_s=total_s)
    print(f"http operator [plain_5k_400's first {HTTP_PODS} pods over"
          f" {HTTP_TYPES} types, over HttpKubeClient]: a second"
          f" client read back {readback[3]} pods bound, {readback[0]} nodes,"
          f" {readback[1]} cpu (the JAX operator's); {passes} passes in"
          f" {wall:.3f} s: solves {solve_s:.3f} s ({len(log['solves'])}"
          f" solves, {scans} scans), other {wall - solve_s:.3f} s;"
          f" {launches} launches; no reconcile error, no verifier"
          f" rejection, readyz true; {total_s:.3f} s with the apiserver's"
          " start and the creates", flush=True)

    # c. the twin in process, the reference's macro scenario
    scn = twin_scenarios()
    macro = scn["macro"]()
    reset_name_counters()
    cuda_ffd.counter.reset()
    with operator_spy() as log, plain_forbidden(), launch_threads() as thr, \
            fresh_counters(m):
        t0 = time.perf_counter()
        res = run_scenario(macro)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = cuda_ffd.counter.total()
    got = twin_summary(res)
    if res.violations or res.counters["rpc_fallbacks"] != 0:
        raise AssertionError(f"twin macro: {res.violations[:3]},"
                             f" {res.counters}")
    if got != TWIN_EXPECTED:
        raise AssertionError(f"twin macro: {got} != the JAX twin's"
                             f" {TWIN_EXPECTED}")
    if not all(s["frontier"] for s in log["sweeps"]):
        raise AssertionError("twin macro: a multi-node pass had no frontier")
    check_launches(log, "twin macro")
    if launches < 1 or launches != len(thr) or not all(thr):
        raise AssertionError(f"twin macro: {launches} launches")
    # the twin through the plain scan, held to the kernel's run on the
    # clean scenario with the tpu solver: the macro's 8 hours through the
    # plain scan took 77-105 s on one H100, of the smoke's time limit
    small = scn["clean"](solver="tpu")
    with plain_forbidden(), fresh_counters(m):
        kern = run_scenario(small)
    t1 = time.perf_counter()
    with fresh_counters(m):
        ref = run_scenario(small, kernel="reference")
    ref_s = time.perf_counter() - t1
    if (ref.ledger_json(), ref.trace_json()) != (kern.ledger_json(),
                                                 kern.trace_json()):
        raise AssertionError("twin clean [tpu]: the kernel's run != the"
                             " plain version's")
    profiled = []
    with fresh_counters(m):
        idle = _idle_share(lambda: profiled.append(run_scenario(macro)),
                           cpu=False)
    if profiled[0].ledger_json() != res.ledger_json():
        raise AssertionError("twin macro: the profiled run's ledger differs")
    solve_s = sum(s["s"] for s in log["solves"])
    sweep_s = sum(s["s"] for s in log["sweeps"])
    out["macro"] = dict(
        wall_s=wall, clean_reference_wall_s=ref_s,
        solves=len(log["solves"]),
        scans=sum(s["scans"] for s in log["solves"]),
        sweeps=len(log["sweeps"]), solve_s=solve_s, sweep_s=sweep_s,
        other_s=wall - solve_s - sweep_s, launches=launches,
        idle_share=idle, **got)
    print(f"twin macro [2 clusters, {got['bound']} pods bound,"
          f" {macro.duration / 3600:g} virtual"
          f" hours]: 0 violations, rpc_fallbacks 0; ledger sha256"
          f" {got['ledger_sha256']} (the JAX twin's), peak nodes"
          f" {got['peak_nodes']}; the clean scenario's run through the"
          f" kernel and the plain version's ({ref_s:.3f} s) give one trace"
          f" and ledger; wall {wall:.3f} s: solves"
          f" {solve_s:.3f} s ({len(log['solves'])} solves), sweeps"
          f" {sweep_s:.3f} s ({len(log['sweeps'])}), other"
          f" {wall - solve_s - sweep_s:.3f} s; {launches} launches;"
          f" device idle share {idle}", flush=True)

    # d. the twin over its in-thread solverd tier
    storm = scn["storm"]()
    runs = []
    for kernel in ("cuda", "cuda", "reference"):
        cuda_ffd.counter.reset()
        ctx = plain_forbidden() if kernel == "cuda" else (
            contextlib.nullcontext())
        with ctx, launch_threads() as thr, fresh_counters(m):
            t0 = time.perf_counter()
            res = run_scenario(storm, kernel=kernel)
            wall = time.perf_counter() - t0
        c, util = res.counters, res.ledger.utilization
        got = storm_summary(res)
        if (res.violations or c["host_fallback_pods"]
                or c["rpc_failures"] <= 0 or c["result_rejected"]
                or sum(util["member_solves"].values()) <= 0
                or got["bound"] != sum(w.count for w in storm.waves)):
            raise AssertionError(f"twin storm [{kernel}]: violations"
                                 f" {res.violations[:3]}, counters {c},"
                                 f" bound {got['bound']}")
        if got != STORM_EXPECTED:
            raise AssertionError(f"twin storm [{kernel}]: {got} != the JAX"
                                 f" twin's {STORM_EXPECTED}")
        n = cuda_ffd.counter.total()
        # the greedy solves of the degraded RPCs run on the operators'
        # thread and launch nothing
        if kernel == "cuda" and (n < 1 or n != len(thr) or any(thr)):
            raise AssertionError(f"twin storm: {n} launches, on the main"
                                 f" thread {sum(thr)}")
        runs.append((res, wall, n))
        print(f"twin storm [fleet 2, kernel {kernel}]: 0 violations,"
              f" rpc_fallbacks {c['rpc_fallbacks']} and ledger sha256"
              f" {got['ledger_sha256']} (the JAX twin's),"
              f" host_fallback_pods 0, rpc_failures {c['rpc_failures']},"
              f" member solves {util['member_solves']}, {got['bound']} pods"
              f" bound; {n} launches, all in the daemons' threads;"
              f" {wall:.3f} s", flush=True)
    first = (runs[0][0].trace_json(), runs[0][0].ledger_json())
    for k, (res, _, _) in enumerate(runs[1:], 1):
        if (res.trace_json(), res.ledger_json()) != first:
            at = next((i for i, (a, b) in enumerate(
                zip(runs[0][0].trace, res.trace)) if a != b),
                min(len(runs[0][0].trace), len(res.trace)))
            raise AssertionError(
                f"twin storm: run {k}'s trace or ledger differs from run"
                f" 0's (walls {[round(w, 3) for _, w, _ in runs]} s); first"
                f" differing trace entry {at}:"
                f" {runs[0][0].trace[at:at + 1]} vs {res.trace[at:at + 1]};"
                f" ledgers equal {res.ledger_json() == first[1]}")
    cuda_ffd.counter.reset()
    with plain_forbidden(), fresh_counters(m):
        t0 = time.perf_counter()
        el = run_scenario(scn["elastic"]())
        el_s = time.perf_counter() - t0
    decisions = [e[4] for e in el.trace if e[3] == "autoscale"]
    if el.violations or el.counters["rpc_fallbacks"] or not any(
            d.startswith("up ") for d in decisions) or not any(
            d.startswith("down ") for d in decisions):
        raise AssertionError(f"twin elastic: {el.violations[:3]},"
                             f" {el.counters}, {decisions}")
    el_launches = cuda_ffd.counter.total()
    out["storm"] = dict(
        walls_s=[w for _, w, _ in runs], launches=[n for _, _, n in runs],
        rpc_failures=runs[0][0].counters["rpc_failures"],
        rpc_fallbacks=runs[0][0].counters["rpc_fallbacks"],
        member_solves=runs[0][0].ledger.utilization["member_solves"],
        slo=runs[0][0].ledger.encode()["slo"])
    out["elastic"] = dict(wall_s=el_s, launches=el_launches,
                          peak_members=el.ledger.peak_members)
    print(f"twin storm: the three runs' traces and ledgers byte-identical;"
          f" twin elastic: 0 violations, the tier grew and shrank (peak"
          f" {el.ledger.peak_members} members), {el_launches} launches,"
          f" {el_s:.3f} s", flush=True)
    out["launches"] = (out["http"]["launches"] + out["macro"]["launches"]
                       + sum(out["storm"]["launches"][:2]) + el_launches)
    return out


# ---------------------------------------------------------------------------
# multi-device solves and the spawned fleet (phase 14)

# the virtual meshes of the sweep and of the batched solves: shards that
# share the one card, one after another on its stream
SWEEP_SHARDS = (2, 3, 4)
BATCH_SHARDS = (2, 4)


@contextlib.contextmanager
def virtual_mesh(n, kind="cuda"):
    """``n`` devices of ``kind`` laid over its physical ones for the length
    of the block (``parallel/mesh.force_virtual_mesh``); 1 is the physical
    count."""
    from karpenter_core_tpu_torch.parallel import mesh as pmesh

    pmesh.force_virtual_mesh(n if n > 1 else 0, kind)
    try:
        yield
    finally:
        pmesh.force_virtual_mesh(0, kind)


def mesh_scheduler(name, devices, kernel_backend="cuda", pool="default"):
    """A scheduler over one of ``problems()`` at ``devices``."""
    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.models.provisioner import DeviceScheduler

    _make, n_types, max_slots = problems()[name]
    pool = _pool(pool)
    return DeviceScheduler(
        [pool], {pool.name: list(bench_catalog(n_types))},
        max_slots=max_slots, devices=devices, device="cuda",
        kernel_backend=kernel_backend)


def _solve_wire(sched, make):
    """(result, wire without timing, wall s, launches, rows) of one solve
    of ``make()``'s pods through the kernel, with the plain step made to
    raise; the name and uid counters start from 1, so equal problems give
    equal wires."""
    import torch

    from karpenter_core_tpu_torch.ops import cuda_ffd
    from karpenter_core_tpu_torch.solver import codec

    reset_name_counters()
    pods = make()
    cuda_ffd.counter.reset()
    with plain_forbidden():
        t0 = time.perf_counter()
        res = sched.solve(pods)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return (res, _wire_view(codec.encode_solve_results(res, 0.0)), wall,
            cuda_ffd.counter.total(), cuda_ffd.counter.rows)


def mesh_device_counts():
    """14a: devices=0 and devices=8 resolve to the one card and solve
    plain_5k_400 with the wire of devices=1."""
    make = problems()["plain_5k_400"][0]
    out = {}
    for devices in (1, 0, 8):
        sched = mesh_scheduler("plain_5k_400", devices)
        res, wire, wall, launches, rows = _solve_wire(sched, make)
        st = sched.last_phase_stats
        out[devices] = wire
        if (sched.devices != 1 or st["n_devices"] != 1
                or res.node_count() != EXPECTED_NODES["plain_5k_400"]
                or res.pod_errors or launches != st["rounds"]
                or rows != st["rounds"] or wire != out[1]):
            raise AssertionError(
                f"devices={devices}: resolved to {sched.devices},"
                f" n_devices {st['n_devices']}, {res.node_count()} nodes,"
                f" {launches} launches over {rows} rows for {st['rounds']}"
                f" scans, wire equal {wire == out[1]}")
        print(f"mesh [devices={devices}, one H100]: resolves to 1 device,"
              f" {res.node_count()} nodes, the wire of devices=1; cold"
              f" {wall:.3f} s", flush=True)
    return dict(resolved={str(d): 1 for d in out})


def mesh_sweep():
    """14b: the config-4 sweep through ``frontier_core`` on virtual meshes
    of 2, 3 and 4 shards over the card: the frontier, one launch a shard
    over the padded prefixes, each shard's rows bit-equal to the single
    launch over the same stack (full grid and 2 blocks), one shard to the
    plain batched scan; the shards' scans, walls and bytes."""
    import torch

    from karpenter_core_tpu_torch.models import consolidation as cons
    from karpenter_core_tpu_torch.ops import cuda_ffd
    from karpenter_core_tpu_torch.parallel import mesh as pmesh

    inputs = sweep_inputs()
    P = len(inputs["candidate_pods"])
    walls, frontiers, launches, held = {}, {}, 0, None
    for n in (1,) + SWEEP_SHARDS:
        Pp = pmesh.pad_to_devices(P, n)
        runs = []
        with virtual_mesh(n):
            for rep in range(3):  # one cold, two warm
                cuda_ffd.counter.reset()
                with plain_forbidden():
                    t0 = time.perf_counter()
                    frontier = cons.frontier_core(
                        **inputs, max_slots=SWEEP_SLOTS, devices=n,
                        device="cuda", kernel_backend="cuda")
                    torch.cuda.synchronize()
                    runs.append(time.perf_counter() - t0)
                if (cuda_ffd.counter.launches
                        != dict.fromkeys(cuda_ffd.KERNELS, n)
                        or cuda_ffd.counter.prefix_launches != n
                        or cuda_ffd.counter.rows != Pp):
                    raise AssertionError(
                        f"sweep on {n} shards: {cuda_ffd.counter.launches}"
                        f" ({cuda_ffd.counter.prefix_launches} through"
                        f" cuda_ffd_solve_prefixes) over"
                        f" {cuda_ffd.counter.rows} rows, expected {n}"
                        f" launches of the sweep's entry over {Pp}")
                if n > 1:
                    launches += n
                if frontier is None or not frontier_equal(frontier,
                                                          SWEEP_EXPECTED):
                    raise AssertionError(
                        f"sweep on {n} shards: frontier"
                        f" {run_length(frontier or [])} != the JAX"
                        f" package's {SWEEP_EXPECTED}")
        frontiers[n], walls[n] = frontier, runs
        if frontier != frontiers[1]:
            raise AssertionError(f"sweep on {n} shards: frontier != the"
                                 " one-device frontier")

    sched, prep, classes, kind_batch, count_batch = cons.sweep_problem(
        **inputs, max_slots=SWEEP_SLOTS, device="cuda")
    rows = {}
    for n in SWEEP_SHARDS:
        stack = cons.prefix_stack(cuda_ffd.pack_state(prep.init_state),
                                  classes, prep.statics,
                                  pmesh.pad_rows(kind_batch, n),
                                  pmesh.pad_rows(count_batch, n))
        shards, last = hold_shards(stack, n, plain=n == SWEEP_SHARDS[-1],
                                   scan=cuda_ffd.cuda_ffd_solve_prefixes)
        rows[n] = dict(
            padded_prefixes=int(stack[0].kind.shape[0]), shards=shards,
            sweep_cold_s=walls[n][0], sweep_warm_s=walls[n][1:],
            sweep_bound_ms=sum(r["bound_ms"] for r in shards))
        held = last or held
        print(f"mesh sweep [config 4, {n} shards sharing one H100, not a"
              f" multi-GPU time]: frontier equals the JAX package's and the"
              f" one-device frontier; {n} launches over"
              f" {rows[n]['padded_prefixes']} prefixes a sweep; each shard's"
              f" rows bit-equal to the single launch (full grid and 2"
              f" blocks); shard scans"
              f" {json.dumps([round(r['ms'], 3) for r in shards])} ms,"
              f" stacked bytes {[r['stacked_bytes'] for r in shards]},"
              f" shard bounds"
              f" {json.dumps([round(r['bound_ms'], 4) for r in shards])}"
              f" ms; frontier_core cold {walls[n][0]:.3f} s, warm"
              f" {json.dumps(walls[n][1:])} s (1 device: cold"
              f" {walls[1][0]:.3f} s, warm {json.dumps(walls[1][1:])} s)",
              flush=True)
    return dict(meshes={str(n): r for n, r in rows.items()},
                one_device_s=walls[1], held=held, launches=launches)


def hold_shards(stack, n, plain=False, scan=None):
    """A stacked scan's rows on ``n`` shards of the card, as a mesh splits
    them: each shard's launch through ``scan`` (``cuda_ffd_solve_batched``
    by default; the sweep's packed stack through
    ``cuda_ffd_solve_prefixes``) on the full grid (timed, on a copy of its
    state made outside the window) and on 2 blocks bit-equal to the same
    rows of the single launch over the whole stack; with ``plain`` the
    last shard also to the plain batched scan. Returns (a row a shard, the
    last shard's row with its plain time, or None)."""
    from karpenter_core_tpu_torch.ops import cuda_ffd, ffd
    from karpenter_core_tpu_torch.ops.ffd import LEVEL_ITERS
    from karpenter_core_tpu_torch.parallel import mesh as pmesh

    li = LEVEL_ITERS
    scan = scan or cuda_ffd.cuda_ffd_solve_batched
    single = _planes(*scan(_copy(stack[0]), stack[1], stack[2], li))
    rows = []
    with virtual_mesh(n):
        mesh = pmesh.slot_mesh(n, stack[0].kind.device)
        for k, (lo, hi, dev) in enumerate(
                pmesh.row_shards(int(stack[0].kind.shape[0]), mesh)):
            shard = pmesh.split_rows(stack, lo, hi, dev)
            two = _planes(*scan(_copy(shard[0]), shard[1], shard[2], li,
                                _max_blocks=2))
            st = _copy(shard[0])
            out, ms = _time_once(lambda: scan(st, shard[1], shard[2], li))
            kp = _planes(*out)
            for what, got in (("full grid", kp), ("2 blocks", two)):
                bad = {key: c for key in got if (c := _unequal(
                    got[key], single[key][lo:hi].to(dev)))}
                if bad:
                    raise AssertionError(
                        f"{n} shards, shard {k} ({what}): rows {lo}..{hi - 1}"
                        f" != the single launch on {bad}")
            bound_ms, bound_by = _stack_bound(*shard, *out)
            rows.append(dict(shard=k, device=str(dev), rows=[lo, hi], ms=ms,
                             stacked_bytes=_stored_bytes(*shard),
                             bound_ms=bound_ms, bound_by=bound_by,
                             blocks=cuda_ffd.counter.blocks))
    if not plain:
        return rows, None
    p_out, plain_ms = _time_once(lambda: ffd.ffd_solve_batched(
        cuda_ffd.unpack_state(shard[0]), shard[1], shard[2], li))
    pp = _planes(*p_out)
    kp = _planes(cuda_ffd.unpack_state(out[0]), *out[1:])
    bad = {key: c for key in pp if (c := _unequal(kp[key], pp[key]))}
    if bad:
        raise AssertionError(f"{n} shards, shard {k}: kernel != plain on"
                             f" {bad}")
    last = dict(rows[-1], shards=n, plain_ms=plain_ms,
                max_abs_err=max(_max_abs_err(kp[key], pp[key]) for key in kp),
                ms_per_step=rows[-1]["ms"] / int(stack[1].count.shape[1]))
    print(f"mesh: shard {k} of {n} (rows {lo}..{hi - 1}) equal to the plain"
          f" batched scan; {last['ms']:.3f} ms vs plain {plain_ms:.1f} ms",
          flush=True)
    return rows, last


def mesh_batch():
    """14c: the fleet batch through ``solve_batch`` at devices=1, 2 and 4
    (virtual meshes over the card): every tenant's node count the JAX
    package's and its result the one-device result, one launch a shard of
    each batched dispatch; then plain_50k_800 at devices=4 and
    plain_5k_400 at devices=3 (its slot width padded to 2049) with the
    wire of devices=1, and the padded request held bit-equal to the plain
    scan."""
    import torch

    from karpenter_core_tpu_torch.models import provisioner as tprov
    from karpenter_core_tpu_torch.ops import cuda_ffd
    from karpenter_core_tpu_torch.parallel import mesh as pmesh

    tenants = fleet()
    canon, out = {}, {}
    split = tprov._shards
    shards_log, stacks = [], []

    def logged(mesh, n_rows, trees):
        got = split(mesh, n_rows, trees)
        shards_log.append((n_rows, len(got)))
        # the largest stack on the largest mesh, before its scans (they
        # write the stacked state in place), held below
        if not stacks or n_rows >= stacks[0][0]:
            stacks[:] = [(n_rows, mesh.size,
                          (_copy(trees[0]), *trees[1:3]))]
        return got

    tprov._shards = logged
    try:
        for devices in (1,) + BATCH_SHARDS:
            with virtual_mesh(devices):
                # the fleet's widths: bench_catalog(400), 2048 slots
                scheds = [mesh_scheduler("plain_5k_400", devices, pool=n)
                          for n in tenants]
                pods = [make() for make, _k in tenants.values()]
                del shards_log[:]
                cuda_ffd.counter.reset()
                with plain_forbidden():
                    t0 = time.perf_counter()
                    outcomes, stats = tprov.solve_batch(
                        list(zip(scheds, pods)))
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            solo = stats["dispatches"] - stats["batched_dispatches"]
            if devices == 1:
                want_launches = stats["dispatches"]
                want_rows = stats["padded_total_rows"] + solo
            else:
                want_launches = sum(k for _n, k in shards_log) + solo
                want_rows = sum(n for n, _k in shards_log) + solo
                if (len(shards_log) != stats["batched_dispatches"]
                        or any(k != min(devices, n)
                               for n, k in shards_log)):
                    raise AssertionError(f"devices={devices}: shards"
                                         f" {shards_log} for {stats}")
            if (cuda_ffd.counter.total() != want_launches
                    or cuda_ffd.counter.rows != want_rows):
                raise AssertionError(
                    f"devices={devices}: {cuda_ffd.counter.total()} launches"
                    f" over {cuda_ffd.counter.rows} rows, expected"
                    f" {want_launches} over {want_rows} ({stats})")
            for (name, _), (status, res), sched in zip(tenants.items(),
                                                       outcomes, scheds):
                if status != "ok" or res.pod_errors:
                    raise AssertionError(f"devices={devices} {name}:"
                                         f" {status} {res}")
                if res.node_count() != FLEET_EXPECTED_NODES[name]:
                    raise AssertionError(
                        f"devices={devices} {name}: {res.node_count()}"
                        f" nodes, the JAX package's"
                        f" {FLEET_EXPECTED_NODES[name]}")
                if canon.setdefault(name, _canonical(res)) != _canonical(
                        res):
                    raise AssertionError(f"devices={devices} {name}: != the"
                                         " one-device result")
                if sched.last_phase_stats["n_devices"] != devices:
                    raise AssertionError(f"devices={devices} {name}:"
                                         " n_devices"
                                         f" {sched.last_phase_stats}")
            out[devices] = dict(wall_s=wall, stats=stats,
                                launches=cuda_ffd.counter.total(),
                                rows=cuda_ffd.counter.rows,
                                shards=list(shards_log))
            print(f"mesh batch [{len(tenants)} tenants, devices={devices}"
                  f"{' shards sharing one H100' if devices > 1 else ''}]:"
                  f" every tenant's node count the JAX package's and its"
                  f" one-device result; {cuda_ffd.counter.total()} launches"
                  f" over {cuda_ffd.counter.rows} rows (batched dispatches"
                  f" as (rows, shards) {shards_log}); cold round"
                  f" {wall:.3f} s", flush=True)
    finally:
        tprov._shards = split
    n_rows, n, stack = stacks[0]
    shards, held = hold_shards(stack, n, plain=True)
    held["all_shards"] = shards
    print(f"mesh batch: the {n_rows}-row stack on {n} shards sharing one"
          f" H100: each shard's rows bit-equal to the single launch (full"
          f" grid and 2 blocks); shard scans"
          f" {json.dumps([round(r['ms'], 3) for r in shards])} ms, bounds"
          f" {json.dumps([round(r['bound_ms'], 4) for r in shards])} ms",
          flush=True)

    solo = {}
    for name, devices in (("plain_50k_800", 4), ("plain_5k_400", 3)):
        make = problems()[name][0]
        one = mesh_scheduler(name, 1)
        r1, w1, wall1, _l, _r = _solve_wire(one, make)
        with virtual_mesh(devices):
            sched = mesh_scheduler(name, devices)
            req = first_request(sched, make())
            width = int(req.init_state.kind.shape[0])
            if width != pmesh.pad_to_devices(one.max_slots, devices):
                raise AssertionError(f"{name} devices={devices}: slot width"
                                     f" {width}")
            err = plain_ms = None
            if width != one.max_slots:  # the kernel on the padded width
                err, plain_ms = hold_bit_equal(
                    req, f"{name} devices={devices}")
            res, wire, wall, launches, rows = _solve_wire(sched, make)
        st, st1 = sched.last_phase_stats, one.last_phase_stats
        if (wire != w1 or res.node_count() != EXPECTED_NODES[name]
                or st["n_devices"] != devices
                or any(st[k] != st1[k] for k in ("slots", "rounds",
                                                  "used_slots"))
                or launches != st["rounds"] or rows != st["rounds"]):
            raise AssertionError(
                f"{name} devices={devices}: {res.node_count()} nodes, wire"
                f" equal {wire == w1}, stats {st} vs {st1}, {launches}"
                f" launches")
        solo[name] = dict(devices=devices, width=width, nodes=res.node_count(),
                          slots=st["slots"], cold_s=wall,
                          one_device_cold_s=wall1, plain_ms=plain_ms,
                          max_abs_err=err)
        print(f"mesh solve [{name}, devices={devices} shards sharing one"
              f" H100]: n_devices {devices}, {res.node_count()} nodes, the"
              f" wire of devices=1, slots {st['slots']} (the request's slot"
              f" width {width}"
              f"{', kernel bit-equal to the plain scan on it' if err is not None else ''});"
              f" cold {wall:.3f} s vs {wall1:.3f} s on one device",
              flush=True)
    return dict(batch={str(d): r for d, r in out.items()}, solo=solo,
                held=held,
                launches=sum(r["launches"] for d, r in out.items()
                             if d > 1))


def mesh_gangs():
    """14c: phase 9's four gang tenants through ``solve_batch`` at
    devices=1, 2 and 4 (virtual meshes over the card): each tenant's node
    count GANG_TENANTS_EXPECTED's and its summary the one-device one; the
    batched gang dispatch through ``cuda_gang_solve_sharded``, one shard a
    device, every shard's first scan launched before the first rollback
    scan and two launches a rolled-back shard (every tenant rolls back);
    the last shard of 4 held to the plain gang solve
    (``gangsched.gang_solve_batched``) on the same inputs: its first scan,
    its rollback scan and its answer bit-equal."""
    import torch

    from karpenter_core_tpu_torch.models.provisioner import solve_batch
    from karpenter_core_tpu_torch.ops import cuda_ffd, ffd, gangsched

    tenants = {n: gangs_problem(GANG_TENANT_PODS, pool=n)
               for n in GANG_TENANTS}
    scan0, sharded0 = cuda_ffd._gang_scan, cuda_ffd.cuda_gang_solve_sharded
    log = []  # a gang dispatch: [shards, answers, [(statics, planes)]]

    def snap(out):
        return {k: v.clone() for k, v in _planes(*out).items()
                if v is not None}

    def scan(state, steps, statics, li):
        out = scan0(state, steps, statics, li)
        log[-1][2].append((statics, snap(out)))
        return out

    def sharded(shards, level_iters=ffd.LEVEL_ITERS):
        log.append([shards, None, []])
        outs = sharded0(shards, level_iters)
        log[-1][1] = [snap(o) for o in outs]
        return outs

    summaries, out, launches, held = {}, {}, 0, None
    cuda_ffd._gang_scan, cuda_ffd.cuda_gang_solve_sharded = scan, sharded
    try:
        for devices in (1,) + BATCH_SHARDS:
            with virtual_mesh(devices):
                entries = [(gang_scheduler(p, devices=devices), p[3])
                           for p in tenants.values()]
                del log[:]
                cuda_ffd.counter.reset()
                with plain_forbidden():
                    t0 = time.perf_counter()
                    outcomes, stats = solve_batch(entries)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            for n, (status, res) in zip(tenants, outcomes):
                if status != "ok":
                    raise AssertionError(f"devices={devices} {n}: {status}"
                                         f" {res!r}")
                got = gang_summary(res, tenants[n][3])
                if got["nodes"] != GANG_TENANTS_EXPECTED[n]:
                    raise AssertionError(
                        f"devices={devices} {n}: {got['nodes']} nodes, the"
                        f" JAX package's {GANG_TENANTS_EXPECTED[n]}")
                if summaries.setdefault(n, got) != got:
                    raise AssertionError(f"devices={devices} {n}: {got} !="
                                         f" the one-device {summaries[n]}")
            if len(log) != 1:
                raise AssertionError(f"devices={devices}: {len(log)} gang"
                                     " dispatches, expected one")
            shards, answers, scans = log[0]
            firsts = [id(sh[2]) for sh in shards]
            order = [id(statics) for statics, _p in scans]
            rolled = [bool(gangsched._step_failed(
                scans[k][1]["takes"], sh[3], sh[4]).any())
                for k, sh in enumerate(shards)]
            rows = sum(int(sh[3].shape[0]) for sh in shards)
            if (len(shards) != devices or order[:devices] != firsts
                    or order[devices:] != firsts or not all(rolled)
                    or cuda_ffd.counter.total() != 2 * devices
                    or cuda_ffd.counter.rows != 2 * rows
                    or rows != len(tenants)):
                raise AssertionError(
                    f"devices={devices}: {len(shards)} shards, scans in the"
                    f" order {[firsts.index(i) for i in order]}, rolled back"
                    f" {rolled}, {cuda_ffd.counter.launches} launches over"
                    f" {cuda_ffd.counter.rows} rows")
            if devices > 1:
                launches += cuda_ffd.counter.total()
            out[devices] = dict(wall_s=wall, stats=stats,
                                launches=cuda_ffd.counter.total(),
                                rows=cuda_ffd.counter.rows,
                                shards=len(shards))
            print(f"mesh gangs [{len(tenants)} x {GANG_TENANT_PODS} pods,"
                  f" devices={devices}"
                  f"{' shards sharing one H100' if devices > 1 else ''}]:"
                  " every tenant's node count the JAX package's and its"
                  " summary the one-device one; one gang dispatch on"
                  f" {len(shards)} shards, every first scan launched before"
                  f" the first rollback scan, {cuda_ffd.counter.total()}"
                  f" launches over {cuda_ffd.counter.rows} rows; cold round"
                  f" {wall:.3f} s", flush=True)
    finally:
        cuda_ffd._gang_scan, cuda_ffd.cuda_gang_solve_sharded = scan0, sharded0

    # the last shard of the largest mesh against the plain gang solve
    shard, k = shards[-1], len(shards) - 1
    kscans = [p for statics, p in scans if statics is shard[2]]
    pscans = []
    plain_scan = gangsched.ffd_solve_batched

    def recorded(state, steps, statics, li):
        o = plain_scan(state, steps, statics, li)
        pscans.append(snap(o))
        return o

    li = ffd.LEVEL_ITERS
    gangsched.ffd_solve_batched = recorded
    try:
        p_out, plain_ms = _time_once(
            lambda: gangsched.gang_solve_batched(*shard, level_iters=li))
    finally:
        gangsched.ffd_solve_batched = plain_scan
    _o, ms = _time_once(lambda: sharded0([shard], li))
    pairs = [("first scan", kscans[0], pscans[0]),
             ("rollback scan", kscans[1], pscans[1]),
             ("answer", answers[k], snap(p_out))]
    if len(kscans) != 2 or len(pscans) != 2:
        raise AssertionError(f"gang shard {k}: {len(kscans)} kernel scans,"
                             f" {len(pscans)} plain scans")
    for what, kp, pp in pairs:
        bad = {key: c for key in pp if (c := _unequal(kp[key], pp[key]))}
        if bad or kp.keys() != pp.keys():
            raise AssertionError(f"gang shard {k} of {len(shards)} ({what}):"
                                 f" kernel != plain on {bad}")
    err = max(_max_abs_err(kp[key], pp[key])
              for _w, kp, pp in pairs for key in pp)
    held = dict(shard=k, shards=len(shards), rows=int(shard[3].shape[0]),
                gang_dispatch_ms=ms, plain_ms=plain_ms, max_abs_err=err)
    print(f"mesh gangs: shard {k} of {len(shards)} held to the plain gang"
          " solve on the same inputs: first scan, rollback scan and answer"
          f" bit-equal; gang dispatch {ms:.3f} ms vs plain {plain_ms:.1f}"
          " ms", flush=True)
    return dict(batch={str(d): r for d, r in out.items()}, held=held,
                launches=launches)


def _member_health(addr, timeout=120.0):
    """A solverd member's /healthz body, once it reports ok."""
    from urllib.request import urlopen

    deadline = time.monotonic() + timeout
    while True:
        try:
            with urlopen(f"http://{addr}/healthz", timeout=5) as r:
                body = json.loads(r.read())
                if body.get("ok"):
                    return body
        except OSError:
            pass
        if time.monotonic() > deadline:
            raise AssertionError(f"member {addr}: not ready in {timeout} s")
        time.sleep(0.05)


def _member_memory(pids):
    """(pid -> device memory MiB from nvidia-smi's compute apps, None where
    it lists no such pid (a container's pids may not be the driver's);
    the card's memory in use, MiB)."""
    def smi(query):
        return subprocess.run(
            ["nvidia-smi", query, "--format=csv,noheader,nounits"],
            capture_output=True, text=True).stdout.splitlines()

    used = {}
    for line in smi("--query-compute-apps=pid,used_memory"):
        parts = [x.strip() for x in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            used[int(parts[0])] = int(parts[1])
    card = int(smi("--query-gpu=memory.used")[0].strip())
    return {pid: used.get(pid) for pid in pids}, card


def mesh_fleet():
    """14d: the operator's spawned fleet of two solverd members on the card
    provisions phase 8's pods; the fleet batch's 11 tenants through its
    FleetRouter at once, both members launching the kernel; a third member
    added (the autoscaler's scale-up) answers plain_5k_400 as the
    in-process solve and is retired through the drain path."""
    import threading

    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.metrics import wiring as m
    from karpenter_core_tpu_torch.operator import Options
    from karpenter_core_tpu_torch.solver import remote
    from karpenter_core_tpu_torch.solver.supervisor import DRAIN_EXIT_CODE

    ns = port_classes()
    errors0 = dict(m.RECONCILE_ERRORS.values)
    rejected0 = dict(m.SOLVER_RESULT_REJECTED.values)
    failures0, fallbacks0 = _rpc_failures(), _rpc_fallbacks()
    card = {"before": _member_memory([])[1]}
    reset_name_counters()
    t0 = time.perf_counter()
    op, run = provisioning_scenario(
        ns, Options(solver="tpu", solver_mode="sidecar", solver_fleet=2))
    build_s = time.perf_counter() - t0
    sup = op.solver_supervisor
    try:
        if len(sup.members) != 2 or sup.alive_count() != 2:
            raise AssertionError(f"fleet: {sup.alive_count()} live members")
        # spawn to first seen ready: the members spawn one after another,
        # so the first one's is an upper bound
        ready_s = []
        for mem in sup.members:
            _member_health(mem.addr)
            ready_s.append(mem.time_fn() - mem._last_spawn_at)
        card["two_ready"] = _member_memory([])[1]
        with operator_spy() as log:
            t0 = time.perf_counter()
            passes = run()
            wall = time.perf_counter() - t0
        check_operator_run(op, log, "fleet operator", errors0, rejected0, 0,
                           launched=False)
        if log["solves"]:
            raise AssertionError("fleet operator: solved in process")
        outcome = operator_outcome(op)
        if not outcome[2] or list(outcome[:2]) != list(
                OPERATOR_EXPECTED["provisioning"]):
            raise AssertionError(f"fleet operator: {outcome}, the JAX"
                                 " operator's"
                                 f" {OPERATOR_EXPECTED['provisioning']}")
        # the fleet batch's tenants through the operator's router at once
        results, errors = {}, []

        def one(name, make):
            try:
                pool = _pool(name)
                rs = remote.RemoteScheduler(
                    op.solver_client, [pool],
                    {name: list(bench_catalog(FLEET_TYPES))},
                    device_scheduler_opts=dict(max_slots=FLEET_SLOTS))
                results[name] = rs.solve(make())
            except Exception as e:  # reported below, on the main thread
                errors.append((name, repr(e)))

        threads = [threading.Thread(target=one, args=(n, mk))
                   for n, (mk, _k) in fleet().items()]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        fleet_s = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"fleet batch: {errors}")
        got = {n: r.node_count() for n, r in results.items()}
        if got != FLEET_EXPECTED_NODES:
            raise AssertionError(f"fleet batch: {got} !="
                                 f" {FLEET_EXPECTED_NODES}")
        member_launches = [_member_health(mem.addr)["kernel_launches"]
                           for mem in sup.members]
        if min(member_launches) < 1:
            raise AssertionError(f"fleet: member launches {member_launches}")
        memory, card["after_batch"] = _member_memory(
            [mem.proc.pid for mem in sup.members])
        # the autoscaler's scale-up actuator: a third member
        t0 = time.perf_counter()
        i = sup.add_member()
        third = sup.members[i]
        _member_health(third.addr)
        third_ready_s = time.perf_counter() - t0
        make, n_types, max_slots = problems()["plain_5k_400"]
        local, _w, local_s, _l, _r = _solve_wire(
            mesh_scheduler("plain_5k_400", 1), make)
        pool = _pool()
        rs = remote.RemoteScheduler(
            remote.SolverClient(third.addr, timeout=600), [pool],
            {pool.name: list(bench_catalog(n_types))},
            device_scheduler_opts=dict(max_slots=max_slots))
        reset_name_counters()
        pods = make()
        t0 = time.perf_counter()
        res = rs.solve(pods)
        rpc_s = time.perf_counter() - t0
        third_launches = _member_health(third.addr)["kernel_launches"]
        if _canonical(res) != _canonical(local) or third_launches < 1:
            raise AssertionError(f"third member: {res.node_count()} nodes"
                                 f" vs {local.node_count()} in process,"
                                 f" {third_launches} launches")
        third_memory, card["three_after_solve"] = _member_memory(
            [third.proc.pid])
        memory.update(third_memory)
        proc = third.proc
        clean = sup.retire_member(i)
        if not clean or proc.returncode != DRAIN_EXIT_CODE:
            raise AssertionError(f"third member: retired clean={clean},"
                                 f" exit {proc.returncode}")
        if _rpc_failures() != failures0:
            raise AssertionError(f"fleet: an RPC failed"
                                 f" ({dict(m.SOLVER_RPC_FAILURES.values)})")
        if _rpc_fallbacks() != fallbacks0:
            raise AssertionError(f"fleet: a solve degraded to greedy"
                                 f" ({dict(m.SOLVER_RPC_FALLBACKS.values)})")
        pids = [mem.proc.pid for mem in sup.members] + [proc.pid]
    finally:
        op.shutdown()
    if sup.alive_count():
        raise AssertionError("fleet: a member outlived shutdown")
    row = dict(nodes=outcome[0], cpu=outcome[1], passes=passes, wall_s=wall,
               build_s=build_s, ready_s=ready_s, third_ready_s=third_ready_s,
               fleet_s=fleet_s, member_launches=member_launches,
               third_launches=third_launches,
               memory_mib={str(p): memory.get(p) for p in pids},
               card_memory_mib=card,
               rpc_s=rpc_s, inproc_s=local_s)
    print(f"mesh fleet [2 spawned solverd members on one H100]: spawn to"
          f" ready {json.dumps(ready_s)} s (the first an upper bound;"
          f" operator build {build_s:.3f} s);"
          f" provisioning {outcome[0]} nodes, {outcome[1]} cpu, every pod"
          f" bound (the JAX operator's) in {wall:.3f} s; {len(results)} tenants"
          f" through the FleetRouter at once in {fleet_s:.3f} s, each the JAX"
          f" package's node count, member launches {member_launches};"
          f" third member ready in {third_ready_s:.3f} s, plain_5k_400 over"
          f" RPC {rpc_s:.3f} s vs in process {local_s:.3f} s, the same"
          f" result, retired by drain (exit {DRAIN_EXIT_CODE}); device"
          f" memory MiB by pid {json.dumps(row['memory_mib'])}, the card's"
          f" in use {json.dumps(card)}; no"
          f" reconcile error, no failed RPC, no fallback, readyz true;"
          " every member stopped", flush=True)
    return row


def mesh_phase():
    """Phase 14: device counts on the card, the sweep and batched solves
    on virtual meshes over it, and the spawned fleet."""
    t0 = time.perf_counter()
    out = dict(device_counts=mesh_device_counts(), sweep=mesh_sweep(),
               batch=mesh_batch(), gangs=mesh_gangs(), fleet=mesh_fleet())
    out["launches"] = sum(out[k]["launches"]
                          for k in ("sweep", "batch", "gangs"))
    out["wall_s"] = time.perf_counter() - t0
    return out


# configs whose readings count no kernel launch: the fast twin runs only
# greedy-solver scenarios, and the incremental engine's replayed rounds
# re-solve their dirty classes on the host (solver/incremental.py
# _replay_partial)
BENCH_NO_KERNEL = ("cfg14_twin", "cfg15_incremental")


def _walk(tree, path=()):
    """(path, dict) of every dict in a JSON tree."""
    if isinstance(tree, dict):
        yield path, tree
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))


def bench_child():
    """``python3 bench_torch.py`` under BENCH_FAST=1 (bench.py's fast sizes)
    in a child process: (its process result, its last JSON line or None,
    wall seconds)."""
    import os
    from pathlib import Path

    root = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items()
           if k not in ("BENCH_PODS", "BENCH_TYPES")}
    env["BENCH_FAST"] = "1"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(root / "bench_torch.py")],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    line = None
    for cand in reversed(proc.stdout.strip().splitlines()):
        try:
            line = json.loads(cand)
            break
        except ValueError:
            continue
    return proc, line, wall


def bench_phase(card_name):
    """Phase 15: the port's answer check (``bench_torch.py``) under
    BENCH_FAST=1 in a child process on the card, its last JSON line held
    to the card, the JAX package's answers and the kernel; then cfg7
    (``bench_fleet``), which BENCH_FAST's set leaves out."""
    proc, line, wall = bench_child()
    if line is None:
        raise AssertionError(f"bench_torch.py printed no JSON line (rc"
                             f" {proc.returncode}): {proc.stderr[-2000:]}")
    out = hold_bench_line(line, proc.returncode, card_name, wall,
                          proc.stderr)
    out["cfg7_fleet"] = bench_fleet()
    return out


def bench_fleet():
    """15b: ``bench_torch.py``'s cfg7_fleet judged in this process on the
    card, at bench.py's sizes (8 tenants of 1,000 pods over 200 types on
    one in-process sidecar): each tenant's node count the JAX package's,
    the shed solves degraded to greedy and counted
    (``greedy_fallbacks``), the forced shed's greedy answer the host
    Scheduler's (``shed_parity_ok``), no verifier rejection."""
    import bench_torch

    out = bench_torch._judged("cfg7_fleet", bench_torch._fleet_bench)
    if not out["correct"] or not out["shed_parity_ok"]:
        raise AssertionError(f"bench cfg7_fleet: correct {out['correct']},"
                             f" shed_parity_ok {out['shed_parity_ok']},"
                             f" answers {out['answers']}, expected"
                             f" {out['expected']}")
    row = {k: out[k] for k in ("correct", "shed_parity_ok",
                               "greedy_fallbacks", "shed_total", "answers")}
    row["readings"] = out.get("readings")
    print(f"bench cfg7_fleet [8 tenants x 1000 pods]: correct, node counts"
          f" {json.dumps(out['answers'])} (the JAX package's);"
          f" {out['shed_total']} sheds, greedy_fallbacks"
          f" {out['greedy_fallbacks']}, shed_parity_ok true", flush=True)
    return row


def hold_bench_line(line, rc, card_name, wall, stderr=""):
    """Phase 15's checks of bench_torch.py's JSON line and exit code."""
    dev = line["device"]
    if dev["platform"] != "gpu" or dev["name"] != card_name:
        raise AssertionError(f"bench_torch.py device block {dev}, expected"
                             f" the card {card_name!r}")
    wrong = [n for n, c in line["detail"].items() if not c["correct"]]
    if wrong or not line["correct"]:
        raise AssertionError(f"bench_torch.py: configs not correct {wrong}:"
                             + json.dumps({n: [line["detail"][n]["answers"],
                                               line["detail"][n]["expected"]]
                                           for n in wrong}))
    backends, launches = {}, {}
    for name, cfg in line["detail"].items():
        for path, d in _walk(cfg):
            where = ".".join(map(str, (name,) + path))
            # cfg17 runs the plain scan on purpose as the kernel's oracle
            plain = "reference" in path
            if "kernel_backend" in d:
                backends[where] = d["kernel_backend"]
                if d["kernel_backend"] != ("reference" if plain else "cuda"):
                    raise AssertionError(f"{where}: kernel_backend"
                                         f" {d['kernel_backend']}")
            if "kernel_launches" in d:
                launches[where] = d["kernel_launches"]
                if plain and d["kernel_launches"]:
                    raise AssertionError(f"{where}: the plain scan launched"
                                         f" the kernel")
    ran = [n for n in line["detail"] if n not in BENCH_NO_KERNEL]
    missing = [n for n in ran if not any(w.split(".")[0] == n and v > 0
                                         for w, v in launches.items())]
    if missing:
        raise AssertionError(f"bench_torch.py: no kernel launches counted"
                             f" for {missing}")
    if rc != 0:
        raise AssertionError(f"bench_torch.py exited {rc}, expected 0:"
                             f" {stderr[-2000:]}")
    out = dict(wall_s=wall, rc=rc, configs=list(line["detail"]),
               primary_launches=line["detail"]["primary"]["phases"][
                   "kernel_launches"],
               launches=sum(launches.values()),
               source_digest=line["source_digest"])
    print(f"bench [BENCH_FAST=1]: {len(line['detail'])} configs correct on"
          f" {dev['name']} ({dev['power_limit_w']} W); kernel_backend cuda"
          f" on {sum(1 for v in backends.values() if v == 'cuda')} phases"
          f" blocks; kernel launches {json.dumps(launches)}; rc {rc};"
          f" {wall:.1f} s", flush=True)
    return out


# the preemption pass timed for an A/B of two trees (PERF.md):
#   python3 chip_smoke.py --preempt-times capture PATH
#   python3 chip_smoke.py --preempt-times time TREE PATH [REPS]
# ``capture`` builds the kernel, runs phase 9's two preemption routes and
# saves each pass's inputs to PATH (torch.save, on the CPU); ``time``
# imports TREE's package (a checkout of another commit, e.g. ``git
# archive`` of the parent under ``local/``) and prints one JSON line of
# ``preempt_times`` with the card's nvidia-smi line. Run each tree in its
# own process, in turns (parent, change, change, parent), in one call.

PREEMPT_ARGS = ("state", "steps", "statics", "step_tier", "step_gang",
                "unplaced", "ev")


def _cpu(x):
    """A pass argument as (leaf tensors on the CPU, or one tensor)."""
    if isinstance(x, tuple):
        return [None if t is None else t.detach().cpu() for t in x]
    return x.detach().cpu()


def preempt_capture(path):
    """Phase 9's two preemption routes, their inputs saved: the four gang
    tenants through ``solve_batch`` (one batched pass, B = 4) and the
    cfg11 solve (the solo pass)."""
    import torch

    from karpenter_core_tpu_torch.models.provisioner import solve_batch
    from karpenter_core_tpu_torch.ops import cuda_ffd, gangsched

    cuda_ffd.build()
    saved = {}

    def spy(name, fn):
        def run(*args, **kwargs):
            saved[name] = dict(args=[_cpu(a) for a in args],
                               node_rounds=kwargs["node_rounds"])
            return fn(*args, **kwargs)
        return run

    real = gangsched.preempt_pass_batched, gangsched.preempt_pass
    gangsched.preempt_pass_batched = spy("batched", real[0])
    gangsched.preempt_pass = spy("solo", real[1])
    try:
        tenants = [gangs_problem(GANG_TENANT_PODS, pool=n)
                   for n in GANG_TENANTS]
        outcomes, _ = solve_batch([(gang_scheduler(p), p[3])
                                   for p in tenants])
        if any(status != "ok" for status, _ in outcomes):
            raise AssertionError(f"gang tenants: {outcomes}")
        problem = gangs_problem()
        gang_scheduler(problem).solve(problem[3])
    finally:
        gangsched.preempt_pass_batched, gangsched.preempt_pass = real
    if set(saved) != {"batched", "solo"}:
        raise AssertionError(f"captured {sorted(saved)}")
    torch.save(saved, path)
    return {k: dict(B=int(v["args"][3].shape[0]) if k == "batched" else 1,
                    J=int(v["args"][3].shape[-1]),
                    N=int(v["args"][6][1].shape[-2]),
                    P=int(v["args"][6][1].shape[-1]))
            for k, v in saved.items()}


def _preempt_trees(args, dev):
    """The saved arguments as the imported tree's types on ``dev``."""
    from karpenter_core_tpu_torch.ops.ffd import (
        ClassStep,
        FFDStatics,
        SlotState,
    )
    from karpenter_core_tpu_torch.ops.gangsched import EvPlanes

    types = dict(state=SlotState, steps=ClassStep, statics=FFDStatics,
                 ev=EvPlanes)
    out = []
    for name, a in zip(PREEMPT_ARGS, args):
        if name in types:
            out.append(types[name](*(None if t is None else t.to(dev)
                                     for t in a)))
        else:
            out.append(a.to(dev))
    return out


def _out_digest(outs):
    h = hashlib.sha256()
    for t in outs:
        h.update(t.cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def preempt_times(root, inputs, reps):
    """The ``preempt_pass_batched`` and ``preempt_pass`` of the package
    under ``root`` on the saved inputs: the host wall of a call,
    synchronised (the pass reads its step tiers back, so the host sets its
    pace), over ``reps`` calls after a warm-up; the device kernels of one
    call and the device's idle share over one; a sha256 of the outputs,
    equal across trees whose answers are."""
    from pathlib import Path

    sys.path.insert(0, root)
    import torch

    from karpenter_core_tpu_torch.ops import gangsched

    if not Path(gangsched.__file__).resolve().is_relative_to(
            Path(root).resolve()):
        raise AssertionError(f"imported {gangsched.__file__}, not {root}'s")
    saved = torch.load(inputs)
    dev = torch.device("cuda")
    out = dict(root=root, gangsched=gangsched.__file__, reps=reps)
    for name, fn in (("batched", gangsched.preempt_pass_batched),
                     ("solo", gangsched.preempt_pass)):
        args = _preempt_trees(saved[name]["args"], dev)
        rounds = saved[name]["node_rounds"]

        def call():
            return fn(*args, node_rounds=rounds)

        res = call()  # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        walls.sort()
        out[name] = dict(rows=int(args[3].shape[0]) if name == "batched"
                         else 1, ms=walls, p50_ms=walls[len(walls) // 2],
                         device_kernels=_device_kernels(call),
                         device_idle_share=_idle_share(call),
                         digest=_out_digest(res))
    return out


# ---------------------------------------------------------------------------
# a real device fault in a child process (phase 16)

# 16a: plain_5k_400's first FAULT_PODS pods over HTTP_TYPES types, through
# the binary over the HTTP apiserver; the JAX operator's node count and
# summed node cpu on them, over its own apiserver
# (fleet_expected.ref_http_run; tests/test_torch_device_fault.py holds the
# pinned value to it on the CPU)
FAULT_PODS = 200
FAULT_EXPECTED = [7, 174.0]
# 16b: the operator's solves at this slot width, and the pods of its
# second wave (after the respawn)
FAULT_SLOTS = 256
FAULT_WAVE_PODS = 50
# the most a faulted child may take from its fault to its exit: the
# binary's /healthz grace and teardown bound (main.FAULT_EXIT_GRACE_S,
# TEARDOWN_TIMEOUT_S) and the interpreter's exit
FAULT_EXIT_BOUND_S = 10.0
# the binary as phase 16a's children run it
FAULT_BINARY_FLAGS = ["--solver", "tpu", "--health-port", "-1",
                      "--poll-interval", "0.1", "--batch-max-duration", "2",
                      "--batch-idle-duration", "0.1"]


def device_assert():
    """A real device-side assert on the card: a gather far out of the
    bounds of a CUDA tensor, synchronised. The CUDA runtime raises its
    sticky ``device-side assert triggered``, and the process's context is
    poisoned from here on."""
    import torch

    x = torch.zeros(4, device="cuda")
    x[torch.full((1,), 1 << 20, dtype=torch.long, device="cuda")]
    torch.cuda.synchronize()
    raise AssertionError("the out-of-bounds gather did not fault")


def _poison_seam(mark):
    """Wrap the kernel seam of this process (the solo and batched scan
    wrappers of ``ops/cuda_ffd``): while the file ``mark`` does not exist,
    the next call creates it and raises a real device-side assert before
    its launch. The first child to reach the seam faults; its respawned
    successor, the same command, does not."""
    import os

    from karpenter_core_tpu_torch.ops import cuda_ffd

    def wrap(fn):
        def poisoned(*args, **kwargs):
            if not os.path.exists(mark):
                open(mark, "w").close()
                device_assert()
            return fn(*args, **kwargs)
        return poisoned

    cuda_ffd.cuda_ffd_solve = wrap(cuda_ffd.cuda_ffd_solve)
    cuda_ffd.cuda_ffd_solve_batched = wrap(cuda_ffd.cuda_ffd_solve_batched)


def fault_child(argv):
    """The entry point of phase 16's children, ``python3 chip_smoke.py
    --fault-child ...``, with the kernel seam poisoned by the mark file:
    ``operator <apiserver port> <mark>`` runs the binary (``python -m
    karpenter_core_tpu_torch.main`` with ``FAULT_BINARY_FLAGS``: in
    process, on cuda) with its Operator over the apiserver; ``solverd
    <mark> [solverd flags]`` runs solverd (``python -m
    karpenter_core_tpu_torch.solver.service``)."""
    import runpy

    kind, args = argv[0], argv[1:]
    if kind == "solverd":
        _poison_seam(args[0])
        from karpenter_core_tpu_torch.solver import service

        sys.argv = ["solverd"] + args[1:]
        return service.main()
    port, mark = int(args[0]), args[1]
    _poison_seam(mark)
    from karpenter_core_tpu_torch import operator as opmod
    from karpenter_core_tpu_torch.cloudprovider.kwok import (
        KwokCloudProvider,
        bench_catalog,
    )
    from karpenter_core_tpu_torch.kube.httpclient import HttpKubeClient

    real = opmod.Operator

    def over_http(options=None):
        client = HttpKubeClient("127.0.0.1", port)
        return real(kube=client, options=options,
                    cloud_provider=KwokCloudProvider(
                        client, list(bench_catalog(HTTP_TYPES))))

    # the binary imports Operator from the operator module when it runs
    opmod.Operator = over_http
    sys.argv = ["karpenter"] + FAULT_BINARY_FLAGS
    runpy.run_module("karpenter_core_tpu_torch.main", run_name="__main__",
                     alter_sys=True)
    return 0


class _Child:
    """A child process from the root of the checkout, its stderr read on
    a thread into (monotonic time, line) pairs."""

    def __init__(self, cmd):
        import threading
        from pathlib import Path

        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            cmd, cwd=Path(__file__).resolve().parent,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        self.lines = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stderr:
            self.lines.append((time.monotonic(), line))

    def first(self, text):
        """The time of the first stderr line holding ``text``, or None."""
        return next((t for t, ln in list(self.lines) if text in ln), None)

    def health_addr(self):
        import re

        for _, ln in list(self.lines):
            found = re.search(r"health/metrics on [^:\s]+:(\d+)", ln)
            if found:
                return f"127.0.0.1:{found.group(1)}"
        return None

    def stderr(self):
        return "".join(ln for _, ln in self.lines)

    def finish(self, timeout):
        """Wait for the exit (killing the child past ``timeout``) and for
        the last stderr line; returns the exit code."""
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self._reader.join(10)
        return self.proc.returncode


def _http_status(url):
    """A GET's status, or None when nothing answers."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=2) as r:
            r.read()
            return r.status
    except urllib.error.HTTPError as e:
        return e.code
    except OSError:
        return None


def _readback(port):
    """(pods bound, nodes, the nodes' summed cpu) read from the
    apiserver."""
    from karpenter_core_tpu_torch.kube.httpclient import HttpKubeClient

    probe = HttpKubeClient("127.0.0.1", port)
    nodes = probe.list_nodes()
    return (sum(1 for p in probe.list_pods() if p.node_name), len(nodes),
            sum(n.status.capacity.get("cpu", 0) for n in nodes))


def fault_operator():
    """16a: the binary in a child over the apiserver; the child's first
    provisioning solve raises a real device-side assert at the kernel
    seam. It must log the sticky error, answer /healthz 503 and exit
    ``DEVICE_FAULT_EXIT_CODE`` within ``FAULT_EXIT_BOUND_S`` of the fault;
    the same command respawned (the pod's restart) must bind every pod
    with the JAX operator's node count and exit 0 on SIGINT."""
    import os
    import signal
    import tempfile

    from karpenter_core_tpu_torch.kube.httpclient import HttpKubeClient
    from karpenter_core_tpu_torch.main import DEVICE_FAULT_EXIT_CODE

    mark = os.path.join(tempfile.mkdtemp(prefix="chip-smoke-fault-"),
                        "faulted")
    cmd = [sys.executable, "chip_smoke.py", "--fault-child", "operator"]
    with http_apiserver() as port:
        client = HttpKubeClient("127.0.0.1", port)
        client.create(_pool())
        reset_name_counters()
        for pod in _plain_pods(FAULT_PODS):
            client.create(pod)
        cmd += [str(port), mark]

        # the faulted child: poll /healthz until it exits
        child = _Child(cmd)
        health = []
        while child.proc.poll() is None:
            if time.monotonic() - child.t0 > 180:
                child.finish(0)
                raise AssertionError("faulted operator: no exit in 180 s:"
                                     f" {child.stderr()[-2000:]}")
            addr = child.health_addr()
            if addr:
                health.append((time.monotonic(),
                               _http_status(f"http://{addr}/healthz")))
            time.sleep(0.05)
        exit_at = time.monotonic()
        rc = child.finish(10)
        err = child.stderr()
        fault_at = child.first("sticky CUDA error")
        if (rc != DEVICE_FAULT_EXIT_CODE or fault_at is None
                or "device-side assert triggered" not in err):
            raise AssertionError(f"faulted operator: exit {rc}, expected"
                                 f" {DEVICE_FAULT_EXIT_CODE} after a"
                                 f" device-side assert: {err[-3000:]}")
        exit_s = exit_at - fault_at
        fault_s = fault_at - child.t0
        unhealthy = [t for t, st in health if st == 503 and t >= fault_at]
        if exit_s > FAULT_EXIT_BOUND_S or not unhealthy:
            raise AssertionError(
                f"faulted operator: exit {exit_s:.3f} s after the fault"
                f" (bound {FAULT_EXIT_BOUND_S} s), /healthz after it"
                f" {[st for t, st in health if t >= fault_at]}")
        after_fault = _readback(port)
        if after_fault[0] or after_fault[1]:
            raise AssertionError(f"faulted operator: bound or created"
                                 f" {after_fault} before its exit")

        # the respawn: the same command, the mark now present
        child = _Child(cmd)
        ready_s = None
        while True:
            now = time.monotonic()
            if child.proc.poll() is not None or now - child.t0 > 180:
                child.finish(0)
                raise AssertionError(f"respawned operator: exited or timed"
                                     f" out: {child.stderr()[-3000:]}")
            addr = child.health_addr()
            if ready_s is None and addr and _http_status(
                    f"http://{addr}/readyz") == 200:
                ready_s = now - child.t0
            if ready_s is not None and _readback(port)[0] == FAULT_PODS:
                bound_s = time.monotonic() - child.t0
                break
            time.sleep(0.1)
        child.proc.send_signal(signal.SIGINT)
        rc2 = child.finish(60)
        err2 = child.stderr()
        got = _readback(port)
    if rc2 != 0 or "sticky" in err2 or "Traceback" in err2:
        raise AssertionError(f"respawned operator: exit {rc2}:"
                             f" {err2[-3000:]}")
    if [got[1], got[2]] != FAULT_EXPECTED or got[0] != FAULT_PODS:
        raise AssertionError(f"respawned operator: {got[0]} pods bound,"
                             f" {got[1]} nodes, {got[2]} cpu; the JAX"
                             f" operator's [nodes, cpu] {FAULT_EXPECTED}")
    return dict(exit_code=rc, exit_s=exit_s, fault_s=fault_s,
                healthz_after_fault=sorted({st for t, st in health
                                            if t >= fault_at}, key=str),
                respawn_exit_code=rc2, respawn_ready_s=ready_s,
                respawn_bound_s=bound_s, pods_bound=got[0], nodes=got[1],
                cpu=got[2])


def fault_solverd():
    """16b: an operator in sidecar mode (``Options(solver="tpu",
    solver_mode="sidecar")``) whose spawned solverd member meets a real
    device-side assert at the kernel seam on its first solve. The
    operator's solve that met it degrades to the host greedy Scheduler:
    one fallback, its placements the host Scheduler's over the same pods.
    The member exits ``WATCHDOG_EXIT_CODE``, the supervisor respawns it in
    the operator's next pass, and the next wave's solve goes through the
    respawned member's kernel (launches on its /healthz), its wire that of
    an in-process daemon on the same request bytes. Every pod ends bound,
    with no reconcile error and ``readyz()`` true. Prints the ``degraded``
    line. The operator sends the full wire (``solver_wire="full"``), so
    each request stands alone."""
    import copy
    import os
    import tempfile

    from karpenter_core_tpu_torch.cloudprovider.kwok import bench_catalog
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.scheduler import (
        Scheduler,
    )
    from karpenter_core_tpu_torch.metrics import wiring as m
    from karpenter_core_tpu_torch.operator import Options
    from karpenter_core_tpu_torch.solver import remote, service
    from karpenter_core_tpu_torch.solver import supervisor as supmod
    from karpenter_core_tpu_torch.solver.supervisor import WATCHDOG_EXIT_CODE

    pool, catalog = _pool(), list(bench_catalog(HTTP_TYPES))
    tmp = tempfile.mkdtemp(prefix="chip-smoke-solverd-")
    mark = os.path.join(tmp, "faulted")
    default_command = supmod.default_command

    def fault_command(*args, **kwargs):
        # the operator's own argv, run by the poisoned child entry
        argv = default_command(*args, **kwargs)
        return [sys.executable, "chip_smoke.py", "--fault-child", "solverd",
                mark] + argv[3:]

    solves = []
    real_solve = remote.RemoteScheduler.solve

    def spy_solve(self, pods, *args, **kwargs):
        before = m.SOLVER_RPC_FALLBACKS.value({"endpoint": "solve"})
        asked = copy.deepcopy(pods)
        res = real_solve(self, pods, *args, **kwargs)
        solves.append(dict(pods=asked, res=res, at=time.time(),
                           fell=m.SOLVER_RPC_FALLBACKS.value(
                               {"endpoint": "solve"}) - before))
        return res

    ns = port_classes()
    errors0 = dict(m.RECONCILE_ERRORS.values)
    crashes0 = m.SOLVERD_RESTARTS.value({"cause": "crash"})
    supmod.default_command = fault_command
    t0 = time.monotonic()
    try:
        op = _new_operator(ns, catalog, Options(
            solver="tpu", solver_mode="sidecar", solver_wire="full",
            solver_quarantine_journal=os.path.join(tmp, "poison.json"),
            batch_max_duration=0.0, batch_idle_duration=0.0,
            device_scheduler_opts={"max_slots": FAULT_SLOTS}))
    finally:
        supmod.default_command = default_command
    sup = op.solver_supervisor
    remote.RemoteScheduler.solve = spy_solve
    try:
        faulted = sup.proc
        _member_health(sup.addr)
        up_s = time.monotonic() - t0
        op.kube.create(pool)
        reset_name_counters()
        for pod in _plain_pods(FAULT_PODS):
            op.kube.create(pod)
        op.run_until_idle(disrupt=False)
        if not os.path.exists(mark) or not solves:
            raise AssertionError("solverd: the member's seam never faulted")
        fault_at = os.path.getmtime(mark)
        first = solves[0]
        if first["fell"] != 1 or sum(s["fell"] for s in solves) != 1:
            raise AssertionError(f"solverd: fallbacks"
                                 f" {[s['fell'] for s in solves]}, expected"
                                 " one, on the faulted solve")
        host = Scheduler([copy.deepcopy(pool)], {pool.name: catalog}).solve(
            copy.deepcopy(first["pods"]))
        if _canonical(first["res"]) != _canonical(host):
            raise AssertionError("solverd: the degraded solve's placements"
                                 " != the host Scheduler's")
        rc = faulted.wait(timeout=FAULT_EXIT_BOUND_S)
        if rc != WATCHDOG_EXIT_CODE:
            raise AssertionError(f"solverd: the member exited {rc},"
                                 f" expected {WATCHDOG_EXIT_CODE}")
        # the operator's passes poll the supervisor and follow the respawn
        t2 = time.monotonic()
        while sup.proc is faulted or not sup.alive():
            if time.monotonic() - t2 > 120:
                raise AssertionError("solverd: no respawn in 120 s")
            op.reconcile_once(disrupt=False)
            time.sleep(0.05)
        launches0 = _member_health(sup.addr)["kernel_launches"]
        respawn_s = time.time() - fault_at
        if sup.restarts != 1 or m.SOLVERD_RESTARTS.value(
                {"cause": "crash"}) != crashes0 + 1:
            raise AssertionError(f"solverd: {sup.restarts} restarts")

        # the next wave through the respawned member, its request kept
        calls = []
        client_call = op.solver_client.call

        def spy_call(path, body, headers=None, **kwargs):
            out = client_call(path, body, headers, **kwargs)
            calls.append((path, body, dict(headers or {}), out[0]))
            return out

        op.solver_client.call = spy_call
        n_first = len(solves)
        for pod in _plain_pods(FAULT_WAVE_PODS):
            pod.metadata.name = "q" + pod.metadata.name[1:]
            op.kube.create(pod)
        op.run_until_idle(disrupt=False)
        op.solver_client.call = client_call
        later = solves[n_first:]
        launches = _member_health(sup.addr)["kernel_launches"] - launches0
        if not later or any(s["fell"] for s in later) or launches < 1:
            raise AssertionError(f"solverd: after the respawn"
                                 f" {len(later)} solves, fallbacks"
                                 f" {[s['fell'] for s in later]}, {launches}"
                                 " member launches")
        kernel_at = later[0]["at"]
        path, body, headers, data = next(c for c in calls
                                         if c[0] == "/solve")
        reset_name_counters()
        local, _ = service.SolverDaemon().solve(
            body, tenant=headers.get("X-Solver-Tenant"),
            solver_mode=headers.get("X-Solver-Mode"))
        if _wire_view(data) != _wire_view(local):
            raise AssertionError("solverd: the respawned member's wire !="
                                 " the in-process daemon's")
        outcome = operator_outcome(op)
        bound = sum(1 for p in op.kube.list_pods() if p.node_name)
        if (not outcome[2] or bound != FAULT_PODS + FAULT_WAVE_PODS
                or dict(m.RECONCILE_ERRORS.values) != errors0
                or op._controller_faults or not op.readyz()):
            raise AssertionError(f"solverd operator: {bound} pods bound,"
                                 f" reconcile errors"
                                 f" {dict(m.RECONCILE_ERRORS.values)},"
                                 f" faults {op._controller_faults}, readyz"
                                 f" {op.readyz()}")
    finally:
        remote.RemoteScheduler.solve = real_solve
        op.shutdown()
    if sup.alive():
        raise AssertionError("solverd: the member outlived shutdown")
    degraded = dict(fallbacks=1, fault_to_greedy_s=first["at"] - fault_at,
                    fault_to_kernel_solve_s=kernel_at - fault_at)
    print("degraded " + json.dumps(degraded), flush=True)
    return dict(exit_code=rc, spawn_ready_s=up_s,
                fault_to_respawn_ready_s=respawn_s,
                restarts=sup.restarts, greedy_nodes=host.node_count(),
                respawn_launches=launches, nodes=outcome[0],
                cpu=outcome[1], pods_bound=bound, wire_equal=True,
                **degraded)


def fault_phase():
    """Phase 16: a real device-side assert in child processes, the
    in-process operator's binary (16a) and a spawned solverd member
    (16b); prints the ``device_fault`` line."""
    t0 = time.perf_counter()
    out = dict(operator=fault_operator(), solverd=fault_solverd())
    out["wall_s"] = time.perf_counter() - t0
    print("device_fault " + json.dumps(out), flush=True)
    return out


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

    def done(phase):
        print(f"phase {phase} done, {time.perf_counter() - t0:.1f} s since"
              " the build began", flush=True)

    done(2)
    # 3. kernel against its plain version
    krows = kernel_phase()
    done(3)
    # 4. the main path
    mrows, launches = main_path_phase()
    done(4)
    # 5. the batched kernel against its plain version and the solo kernel
    brows = batched_kernel_phase()
    done(5)
    # 6. the batched main path
    bmain = batched_main_path_phase()
    done(6)
    # 7. the consolidation sweep kernel at config 4
    sweep = sweep_phase()
    done(7)
    # 8. the operator on the card
    operator = operator_phase()
    done(8)
    # 9. gangs, priority tiers and preemption
    gangs = gangs_phase()
    done(9)
    # 10. rack-aware gangs: the kernel's level-grouped first-fit
    topo = topo_phase()
    done(10)
    # 11. the relax backend: its candidate scan through the kernel
    relax = relax_phase()
    done(11)
    # 12. solverd: the daemon in process, then the operator's sidecar
    solverd = solverd_phase()
    done(12)
    launches[cuda_ffd.KERNELS[0]] += solverd["launches"]
    # 13. entry points and the twin: the binary, the operator over HTTP,
    # the twin in process and over its in-thread solverd tier
    twin = twin_phase()
    done(13)
    launches[cuda_ffd.KERNELS[0]] += twin["launches"]
    # 14. multi-device solves on virtual meshes over the card, and the
    # spawned fleet
    mesh = mesh_phase()
    done(14)
    # 15. the port's bench under BENCH_FAST=1, in a child
    bench = bench_phase(smi.rsplit(",", 1)[0].strip())
    done(15)
    # 16. a real device fault in children: the binary's crash-only exit
    # and its respawn, and a solverd member's
    fault = fault_phase()
    done(16)
    held = mesh["sweep"]["held"]

    k50 = krows[0]
    kp = next(r for r in brows if r["tenants"] == FLEET_GROUPS[0])
    kernels = {"kernels": [{
        "name": "ffd_step",
        "route": "cuda",
        "source": "karpenter_core_tpu_torch/csrc/ffd_step.cu",
        "replaces": "karpenter_core_tpu/ops/pallas_ffd.py:135",
        "launches": sum(launches.values()),
        "launches_by_kernel": launches,
        "operator_launches": sum(r["scans"] for r in operator.values()),
        "solverd_launches": solverd["launches"],
        "solverd": solverd,
        "twin_launches": twin["launches"],
        "twin": twin,
        "blocks": k50["blocks"],
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
        # the wrapper's passes around the launch, inside "ms"
        "pack_ms": k50["pack_ms"],
        "unpack_ms": k50["unpack_ms"],
        "shapes": krows,
        "main_path": mrows,
        # phase 15's child process: its own launches, not in this count
        "bench": bench,
        # phase 16's children: their own contexts, not in this count
        "device_fault": fault,
    }, {
        "name": "ffd_step_batched",
        "route": "cuda",
        "source": "karpenter_core_tpu_torch/csrc/ffd_step.cu",
        "replaces": "karpenter_core_tpu/ops/pallas_ffd.py:135",
        "replaces_route": "batched: _pallas_ffd_solve_batched_impl"
                          " (pallas_ffd.py:197-216)",
        "launches": sum(bmain["launches"].values()),
        "launches_by_kernel": bmain["launches"],
        "rows": bmain["rows"],
        "blocks": kp["blocks"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in brows + bmain["warm_bit_equal"]),
        "ms": kp["ms"],
        "plain_ms": kp["plain_ms"],
        "bound_ms": kp["bound_ms"],
        "bound_by": kp["bound_by"],
        "library_ms": None,
        "unequal": sum(r["unequal"]
                       for r in brows + bmain["warm_bit_equal"]),
        "solo_sum_ms": kp["solo_sum_ms"],
        "ms_per_step": kp["ms_per_step"],
        "stage_us_per_step": kp["stage_us_per_step"],
        "groups": brows,
        "main_path": bmain,
    }, {
        "name": "ffd_step_sweep",
        "route": "cuda",
        "source": "karpenter_core_tpu_torch/csrc/ffd_step.cu",
        "replaces": "karpenter_core_tpu/ops/pallas_ffd.py:135",
        "replaces_route": "the consolidation sweep's batched scan:"
                          " models/consolidation.py _prefix_scan (:61-72),"
                          " on the problem axis of _pallas_ffd_solve_batched"
                          "_impl (pallas_ffd.py:197-216)",
        "entry": "ops/cuda_ffd.cuda_ffd_solve_prefixes",
        "launches": sum(r["launches"] - r["scans"]
                        for r in operator.values()),
        "prefix_launches": sum(r["prefix_launches"]
                               for r in operator.values()),
        "rows": sum(r["rows"] - r["scans"] for r in operator.values()),
        "blocks": sweep["blocks"],
        "max_abs_err": max([sweep["max_abs_err"]] + [
            h["max_abs_err"] for r in operator.values() for h in r["held"]]),
        "ms": sweep["ms"],
        "plain_ms": sweep["plain_ms"],
        "bound_ms": sweep["bound_ms"],
        "bound_by": sweep["bound_by"],
        "old_bound_ms": sweep["old_bound_ms"],
        "old_bound_by": sweep["old_bound_by"],
        "unique_bound_ms": sweep["unique_bound_ms"],
        "unique_bound_by": sweep["unique_bound_by"],
        "frontier_peak_over_base_bytes":
            sweep["frontier_peak_over_base_bytes"],
        "library_ms": None,
        "unequal": sweep["unequal"] + sum(
            h["unequal"] for r in operator.values() for h in r["held"]),
        "ms_per_step": sweep["ms_per_step"],
        "stage_us_per_step": sweep["stage_us_per_step"],
        "config4": sweep,
        "operator": operator,
    }, {
        "name": "ffd_step_gang",
        "route": "cuda",
        "source": "karpenter_core_tpu_torch/csrc/ffd_step.cu",
        "replaces": "karpenter_core_tpu/ops/pallas_ffd.py:135",
        "replaces_route": "the gang-atomic solve's scans: ops/gangsched.py"
                          " _gang_solve_impl (:99-143) and its batched twin"
                          " (:176-212), each scan the fused FFD step",
        "launches": gangs["solo"]["launches"] + gangs["batched"]["launches"],
        "rows": gangs["solo"]["rows"] + gangs["batched"]["rows"],
        "blocks": gangs["solo"]["blocks"],
        "max_abs_err": gangs["solo"]["max_abs_err"],
        "ms": gangs["solo"]["ms"],
        "plain_ms": gangs["solo"]["plain_ms"],
        "bound_ms": gangs["solo"]["bound_ms"],
        "bound_by": gangs["solo"]["bound_by"],
        "library_ms": None,
        "unequal": gangs["solo"]["unequal"],
        "ms_per_step": gangs["solo"]["ms_per_step"],
        "stage_us_per_step": gangs["solo"]["stage_us_per_step"],
        "gang_dispatch_ms": gangs["solo"]["gang_dispatch_ms"],
        "cfg11": gangs,
    }, {
        "name": "ffd_step_topo",
        "route": "cuda",
        "source": "karpenter_core_tpu_torch/csrc/ffd_step.cu",
        "replaces": "karpenter_core_tpu/ops/pallas_ffd.py:135",
        "replaces_route": "the level-grouped first-fit of ClassStep.topo_rank"
                          " (ops/ffd.py:509-530) inside the fused step",
        "launches": topo["launches"],
        "rows": topo["rows"],
        "blocks": topo["blocks"],
        "max_abs_err": topo["max_abs_err"],
        "ms": topo["ms"],
        "plain_ms": topo["plain_ms"],
        "bound_ms": topo["bound_ms"],
        "bound_by": topo["bound_by"],
        "library_ms": None,
        "unequal": topo["unequal"],
        "ms_per_step": topo["ms_per_step"],
        "stage_us_per_step": topo["stage_us_per_step"],
        "classic_ms": topo["classic_ms"],
        "cfg18": topo,
    }, {
        "name": "ffd_step_relax",
        "route": "cuda",
        "source": "karpenter_core_tpu_torch/csrc/ffd_step.cu",
        "replaces": "karpenter_core_tpu/ops/pallas_ffd.py:135",
        "replaces_route": "the relax candidate scan: models/provisioner.py"
                          " _relax_improve's second dispatch (:1562-1575),"
                          " the override riding ClassStep.new_template/kstar"
                          " (_override_steps :1442-1454), solo and batched",
        "launches": relax["candidate_launches"],
        "rows": relax["candidate_rows"],
        "blocks": relax["blocks"],
        "max_abs_err": relax["max_abs_err"],
        "ms": relax["ms"],
        "plain_ms": relax["plain_ms"],
        "bound_ms": relax["bound_ms"],
        "bound_by": relax["bound_by"],
        "library_ms": None,
        "unequal": 0,
        "ms_per_step": relax["ms_per_step"],
        "stage_us_per_step": relax["stage_us_per_step"],
        "relax_choose": {p: h["relax_choose"]
                         for p, h in relax["held"].items()},
        "relax_choose_dispatches": relax["relax_dispatches"],
        "cfg12": relax,
    }, {
        "name": "ffd_step_multi_device",
        "route": "cuda",
        "source": "karpenter_core_tpu_torch/csrc/ffd_step.cu",
        "replaces": "karpenter_core_tpu/ops/pallas_ffd.py:135",
        "replaces_route": "the multi-device route: the sweep's prefix axis"
                          " split over a mesh (models/consolidation.py"
                          " frontier_core :266-281, parallel/mesh.py"
                          " batch_sharding) and batched problems split over"
                          " it, here as shards of a virtual mesh that share"
                          " one card (the timed shard: the last of 4)",
        "launches": mesh["launches"],
        "blocks": held["blocks"],
        "max_abs_err": held["max_abs_err"],
        "ms": held["ms"],
        "plain_ms": held["plain_ms"],
        "bound_ms": held["bound_ms"],
        "bound_by": held["bound_by"],
        "library_ms": None,
        "unequal": 0,
        "ms_per_step": held["ms_per_step"],
        "phase14": mesh,
    }]}
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def preempt_main(argv):
    """``--preempt-times capture PATH`` / ``time TREE PATH [REPS]``."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]
    if argv[0] == "capture":
        line = dict(captured=preempt_capture(argv[1]))
    else:
        line = preempt_times(argv[1], argv[2],
                             int(argv[3]) if len(argv) > 3 else 5)
    line["device"] = smi.strip()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fault-child"]:
        sys.exit(fault_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--preempt-times"]:
        sys.exit(preempt_main(sys.argv[2:]))
    sys.exit(main())
