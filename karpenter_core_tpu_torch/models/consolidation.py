"""Batched multi-node consolidation prefix evaluation — hot loop #2.

Port of ``karpenter_core_tpu/models/consolidation.py``. The reference
binary-searches the largest candidate prefix whose removal still schedules
everything (multinodeconsolidation.go:110-162): ~log2(100) full
Scheduler.Solve() simulations, each over the whole cluster. Here every
prefix is evaluated in ONE device scan: the FFD scan runs over a prefix
axis where

* candidate slots are masked out per prefix (kind=0 — the scan never
  places onto them), and
* the removed candidates' reschedulable pods join the pod classes with
  per-prefix counts,

so prefix p's scan sees exactly the cluster SimulateScheduling would build
for candidates[:p]. The returned schedulability frontier (all pods placed,
new-node count) is the quantity the binary search was probing; the exact
host pipeline (price filters, spot rules) then runs once at the frontier.

The prefix axis is the FFD kernel's problem axis: ``_prefix_scan`` stacks
the one prepared problem P times (only ``kind`` and ``count`` differ per
row) and answers it with one ``cuda_ffd_solve_prefixes`` launch (B = P),
or with the plain ``ffd_solve_batched`` for ``kernel_backend="reference"``.
The slot state, which the kernel writes, is P real copies, its
requirement plane bit-packed for the kernel's route; the class steps and
statics, which it only reads, are one copy each expanded over the prefix
axis (stride 0), as the JAX package's vmap shares them. The verdicts
(``next_free``, unplaced pods, ``overflow``, the fresh slots' price lower
bound) are torch reductions over the final stacked state.

Pods with topology constraints take the host path (callers fall back to
binary search when any candidate carries them). Behind the solverd
sidecar (an operator with a ``solver_client``) the sweep crosses the RPC
seam (solver/remote.remote_frontier) and the sidecar runs this module.
A device count that resolves above 1 splits the prefix axis over a mesh
(``frontier_core``), as the JAX package does: each device scans its
contiguous prefixes with no exchange between devices.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from karpenter_core_tpu_torch import tracing
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (
    Topology,
    has_topology_constraints,
)
from karpenter_core_tpu_torch.models.provisioner import (
    DeviceScheduler,
    _SlotOverflow,
)
from karpenter_core_tpu_torch.ops import cuda_ffd
from karpenter_core_tpu_torch.ops.ffd import (
    LEVEL_ITERS,
    ClassStep,
    FFDStatics,
    SlotState,
    ffd_solve_batched,
)
from karpenter_core_tpu_torch.parallel import mesh as pmesh
from karpenter_core_tpu_torch.solver.snapshot import _spec_signature
from karpenter_core_tpu_torch.utils.device import DEFAULT_DEVICE


def _repeat(tree, P: int):
    """Each leaf stacked P times along a new leading axis, as real copies
    (the batched kernel writes its final state into its input)."""
    return type(tree)(*(
        None if x is None else x.unsqueeze(0).repeat(P, *([1] * x.dim()))
        for x in tree
    ))


def _share(tree, P: int):
    """Each leaf copied once and expanded over a new leading axis of P
    rows with stride 0: one storage that every row reads (the kernel and
    the plain scan only read these trees)."""
    return type(tree)(*(
        None if x is None else x.clone().unsqueeze(0).expand(P, *x.shape)
        for x in tree
    ))


def prefix_stack(state: SlotState, classes: ClassStep, statics: FFDStatics,
                 kind_batch, count_batch):
    """The [P]-stacked problem of the sweep: row p is the prepared problem
    with slot kinds ``kind_batch[p]`` and class counts ``count_batch[p]``.
    The slot state is P real copies of ``state`` as given (the kernel
    writes it; the kernel's route hands it with its plane packed,
    ``cuda_ffd.pack_state``); the class steps (less ``count``) and the
    statics are one copy each, expanded with stride 0. Fresh tensors
    throughout, so the prepared problem is never written."""
    P = int(kind_batch.shape[0])
    dev = state.kind.device
    st = _repeat(state, P)._replace(kind=torch.as_tensor(
        kind_batch, dtype=state.kind.dtype, device=dev).clone())
    cl = _share(classes, P)._replace(count=torch.as_tensor(
        count_batch, dtype=classes.count.dtype, device=dev).clone())
    return st, cl, _share(statics, P)


def _prefix_scan(state: SlotState, classes: ClassStep, statics: FFDStatics,
                 kind_batch, count_batch, it_price, n_existing: int,
                 kernel_backend: str = "cuda"):
    """The FFD scan over the prefix axis: only the slot kinds and the class
    counts vary per prefix; masks/capacities/statics are shared. One
    batched scan answers every prefix: ``"cuda"`` is one kernel launch
    through ``cuda_ffd_solve_prefixes`` over packed state (the plain
    version for tensors on the CPU), ``"reference"`` the plain batched
    scan. The prepared ``state`` is left as it is (the stack is a
    copy): it is ``prep.init_state`` from the DeviceScheduler's prepared
    cache.

    Returns, per prefix: (next_free [P] int32, unplaced pods [P] int32,
    overflow [P] bool, fresh-node price lower bound [P] float32). The price
    lower bound of the fresh nodes a prefix would launch: each fresh slot's
    cheapest still-viable type (its final option set is a SUPERSET of the
    claim the host would build, so this never exceeds the true replacement
    price — a sound skip-filter for the host's cheaper-than-candidates
    rule, SURVEY §7.7's device price tensors)."""
    if kernel_backend == "cuda":
        # the requirement plane packed once, then copied P times
        final, _takes, unplaced = cuda_ffd.cuda_ffd_solve_prefixes(
            *prefix_stack(cuda_ffd.pack_state(state), classes, statics,
                          kind_batch, count_batch), LEVEL_ITERS)
    else:
        final, _takes, unplaced = ffd_solve_batched(
            *prefix_stack(state, classes, statics, kind_batch, count_batch),
            LEVEL_ITERS)
    # (the sweep reads the final state's kinds, next free slot, overflow
    # and itmask, never its requirement plane, which stays packed)
    P, N = final.kind.shape
    E = int(n_existing)
    idx = torch.arange(E, N, device=final.kind.device)
    fresh = idx < final.next_free[:, None]
    # the fresh slots' cheapest viable type, over the slots past the
    # existing ones only; a fill on the device, not a host copy: no host
    # wait between the shards' launches
    inf = it_price.new_full((), float("inf"))
    tail = torch.where(final.itmask[:, E:], it_price, inf).amin(2)
    # summed over all N slots (0 outside the fresh range), in the order of
    # the full-width sum
    price_lb = torch.zeros((P, N), dtype=tail.dtype, device=tail.device)
    price_lb[:, E:] = torch.where(fresh, tail, torch.zeros_like(tail))
    return (final.next_free,
            unplaced.sum(1, dtype=torch.int64).to(torch.int32),
            final.overflow, price_lb.sum(1))


def prefix_batches(
    prep, base_pods: List, candidate_pods: List[List]
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-prefix slot kinds and class counts for the batched sweep.

    Prefix p removes candidate slots [0, p] (kind=0) and adds candidates
    0..p's reschedulable pods to the class counts; base pods always count.
    Candidate slots must occupy the first len(candidate_pods) positions of
    prep.init_state (candidate-first existing-node order)."""
    P = len(candidate_pods)
    C = len(prep.classes)

    base_kind = prep.init_state.kind.cpu().numpy()
    kind_batch = np.tile(base_kind, (P, 1))
    for p in range(P):
        kind_batch[p, : p + 1] = 0

    # label_aware=False matches the empty Topology() the sweep's prep was
    # grouped under (the frontier bails on any topology-coupled pod)
    sig_to_ci = {
        _spec_signature(cls.pods[0], False): ci
        for ci, cls in enumerate(prep.classes)
    }
    base_counts = np.zeros((C,), dtype=np.int32)
    for pod in base_pods:
        base_counts[sig_to_ci[_spec_signature(pod, False)]] += 1
    count_batch = np.tile(base_counts, (P, 1))
    for i, pods in enumerate(candidate_pods):
        for pod in pods:
            count_batch[i:, sig_to_ci[_spec_signature(pod, False)]] += 1
    return kind_batch, count_batch


def schedulability_frontier(
    provisioner,
    cluster,
    candidates: List,
    max_slots: int = 1024,
) -> Optional[List[Tuple[bool, int, float]]]:
    """Per-prefix (all pods scheduled, new nodes needed, fresh-node price
    lower bound) for prefixes 1..len(candidates). The price bound is the
    sum over fresh slots of the cheapest still-viable type — a true lower
    bound only when the device packed the fresh nodes like the host
    simulation would (callers must treat bound-failing sizes as
    deprioritized, not impossible). None when the batched path can't
    represent the problem (topology-coupled pods) — callers binary-search
    instead."""
    base_pods = provisioner.pending_pods() + provisioner.deleting_node_pods()
    if any(has_topology_constraints(p) for p in base_pods):
        return None
    for c in candidates:
        if any(has_topology_constraints(p) for p in c.reschedulable_pods):
            return None

    excluded = {c.name for c in candidates}
    keep_nodes = [n for n in cluster.sim_nodes() if n.name not in excluded]
    cand_nodes = []
    for c in candidates:
        for n in cluster.sim_nodes():
            if n.name == c.name:
                cand_nodes.append(n)
                break
    if len(cand_nodes) != len(candidates):
        return None

    nodepools = provisioner.ready_nodepools()
    instance_types = {
        np_.name: provisioner.cloud_provider.get_instance_types(np_)
        for np_ in nodepools
    }
    # the sweep's price bound and repack viability must see the same ICE'd
    # offerings the solve does, or consolidation plans a replacement onto a
    # stocked-out offering that the launch then fails
    cache = getattr(provisioner, "unavailable_offerings", None)
    if cache is not None:
        from karpenter_core_tpu_torch.cloudprovider.types import apply_unavailable

        instance_types = apply_unavailable(instance_types, cache.snapshot())
    candidate_pods = [c.reschedulable_pods for c in candidates]
    daemonset_pods = provisioner.daemonset_pods()

    # sidecar mode: the sweep crosses the same RPC seam as the solve; a
    # dead/slow sidecar degrades to the host binary search (None), exactly
    # like an unrepresentable problem
    client = getattr(provisioner, "solver_client", None)
    if client is not None:
        from karpenter_core_tpu_torch.solver.remote import remote_frontier

        return remote_frontier(
            client,
            nodepools,
            instance_types,
            cand_nodes,
            keep_nodes,
            daemonset_pods,
            base_pods,
            candidate_pods,
            max_slots=max_slots,
        )
    # in-proc sweeps follow the solve path's device, kernel and device
    # count (the operator threads them through device_scheduler_opts)
    dev_opts = getattr(provisioner, "device_scheduler_opts", None) or {}
    frontier = frontier_core(
        nodepools,
        instance_types,
        cand_nodes,
        keep_nodes,
        daemonset_pods,
        base_pods,
        candidate_pods,
        max_slots=max_slots,
        devices=dev_opts.get("devices", 1),
        device=dev_opts.get("device", DEFAULT_DEVICE),
        kernel_backend=dev_opts.get("kernel_backend", "cuda"),
    )
    # a structural trust anchor: a defective frontier degrades to the
    # caller's host binary search, never into a disruption command
    from karpenter_core_tpu_torch.solver.verify import verify_frontier

    defect = verify_frontier(frontier)
    if defect is not None:
        from karpenter_core_tpu_torch.metrics import wiring as m

        m.SOLVER_RESULT_REJECTED.inc(
            {"reason": "structure", "path": "frontier"}
        )
        return None
    return frontier


def sweep_problem(
    nodepools,
    instance_types,
    cand_nodes,
    keep_nodes,
    daemonset_pods,
    base_pods: List,
    candidate_pods: List[List],
    max_slots: int = 1024,
    device=DEFAULT_DEVICE,
    kernel_backend: str = "cuda",
):
    """The sweep's prepared problem: (scheduler, prep, class steps,
    kind_batch [P, N], count_batch [P, Jp]), or None when the cluster is
    wider than ``max_slots``. Spans: ``sweep.problem`` over
    ``sweep.scheduler``, ``prepare`` and ``sweep.batches``."""
    all_pods = list(base_pods)
    for pods in candidate_pods:
        all_pods.extend(pods)

    with tracing.span("sweep.problem"):
        with tracing.span("sweep.scheduler"):
            # candidate slots first so prefix p masks slots [0, p)
            sched = DeviceScheduler(
                nodepools,
                instance_types,
                existing_nodes=cand_nodes + keep_nodes,
                daemonset_pods=daemonset_pods,
                max_slots=max_slots,
                devices=1,
                kernel_backend=kernel_backend,
                device=device,
            )
            # DeviceScheduler sorts existing nodes; force candidate-first
            # order back
            sched.existing_nodes = cand_nodes + keep_nodes
        try:
            with tracing.span("prepare"):
                prep = sched._prepare(all_pods, max_slots, Topology())
        except _SlotOverflow:
            return None  # cluster wider than the slot array: binary search

        with tracing.span("sweep.batches"):
            kind_batch, count_batch = prefix_batches(
                prep, base_pods, candidate_pods)
            classes = sched._class_steps(prep)
            Jp = int(classes.count.shape[0])
            if count_batch.shape[1] < Jp:  # steps pad to a bucketed count
                count_batch = np.pad(
                    count_batch, ((0, 0), (0, Jp - count_batch.shape[1]))
                )
    return sched, prep, classes, kind_batch, count_batch


def frontier_core(
    nodepools,
    instance_types,
    cand_nodes,
    keep_nodes,
    daemonset_pods,
    base_pods: List,
    candidate_pods: List[List],
    max_slots: int = 1024,
    devices: int = 1,
    device=DEFAULT_DEVICE,
    kernel_backend: str = "cuda",
) -> Optional[List[Tuple[bool, int, float]]]:
    """The device sweep proper, over already-gathered inputs, through
    ``kernel_backend`` (``"cuda"``: the hand kernel, one launch for all
    prefixes; ``"reference"``: its plain version).

    With ``devices`` resolving above 1 the INDEPENDENT prefix axis splits
    over a mesh of ``device``'s kind, as in the JAX package: P pads to a
    multiple of the mesh with copies of the last prefix, the read-only
    state, class and static planes go to each device once, each device
    scans its contiguous prefixes (one launch a shard, every shard launched
    before any host read), and the verdicts come back in order on the lead
    device, the pad rows sliced off.

    The call is one request: the span ``sweep`` over ``sweep.problem``, one
    ``sweep.scan`` a shard (with the shard's device seconds, ``device_s``,
    from a CUDA event pair read after the readback) and
    ``sweep.readback``."""
    rid = tracing.new_request()
    try:
        with tracing.span("sweep", rid):
            return _frontier(
                nodepools, instance_types, cand_nodes, keep_nodes,
                daemonset_pods, base_pods, candidate_pods, max_slots,
                devices, device, kernel_backend)
    finally:
        # the verdicts' readback waited for every shard's scan
        tracing.settle(rid)


def _frontier(nodepools, instance_types, cand_nodes, keep_nodes,
              daemonset_pods, base_pods, candidate_pods, max_slots, devices,
              device, kernel_backend):
    n_dev = pmesh.resolve_devices(devices, device)
    problem = sweep_problem(
        nodepools, instance_types, cand_nodes, keep_nodes, daemonset_pods,
        base_pods, candidate_pods, max_slots=max_slots, device=device,
        kernel_backend=kernel_backend,
    )
    if problem is None:
        return None
    sched, prep, classes, kind_batch, count_batch = problem
    P = len(candidate_pods)
    if P == 0:
        return []
    E = len(sched.existing_nodes)
    it_price = torch.as_tensor(_it_price_vector(prep), device=sched.device)
    mesh = pmesh.slot_mesh(n_dev, sched.device)
    kind_batch = pmesh.pad_rows(kind_batch, n_dev)
    count_batch = pmesh.pad_rows(count_batch, n_dev)
    planes = pmesh.on_each(
        mesh, (prep.init_state, classes, prep.statics, it_price))
    parts = []
    for k, (lo, hi, dev) in enumerate(
            pmesh.row_shards(len(kind_batch), mesh)):
        with tracing.span("sweep.scan") as sp:
            timer = tracing.DeviceTimer.begin(torch.device(dev), sp)
            parts.append(_prefix_scan(
                *planes[k][:3], kind_batch[lo:hi], count_batch[lo:hi],
                planes[k][3], E, sched.kernel_backend))
            if timer is not None:
                timer.stop()
    verdicts = pmesh.gather_rows(mesh, parts)
    with tracing.span("sweep.readback"):
        next_free, unplaced, overflow, price_lb = [
            x.cpu().numpy()[:P] for x in verdicts]
    # an overflowed prefix silently counted spilled pods as placed — it is
    # NOT schedulable evidence
    return [
        (
            int(unplaced[p]) == 0 and not bool(overflow[p]),
            int(next_free[p]) - E,
            float(price_lb[p]),
        )
        for p in range(P)
    ]


def _it_price_vector(prep) -> np.ndarray:
    """Cheapest available offering price per catalog type, padded to the
    statics' bucketed T axis with +inf (never cheapest)."""
    Tp = int(prep.statics.it_alloc.shape[0])
    out = np.full((Tp,), np.inf, dtype=np.float32)
    for ti, it in enumerate(prep.catalog):
        available = it.offerings.available()
        if available:
            out[ti] = min(o.price for o in available)
    return out
