"""The device provisioning solver in PyTorch — the port's flagship model.

Port of ``karpenter_core_tpu/models/provisioner.py`` (its main-path slice):
a drop-in counterpart of the greedy host scheduler
(controllers/provisioning/scheduling/scheduler.py) with the same inputs
(nodepools, instance-type catalog, existing nodes, pending pods) and the
same Results, but the FFD loop runs on the device as a class-batched scan
(``ops/cuda_ffd.py``, the hand CUDA kernel, or its plain version
``ops/ffd.py``) after feasibility is precomputed as tensor ops
(``ops/masks.py``).

Pipeline per solve:
 1. host: pods → equivalence classes, sorted cpu/memory-descending
 2. host: snapshot encode over a closed-world vocab (solver/snapshot.py)
 3. device: class×IT / class×template compatibility + fresh-node viability
 4. device: FFD scan over classes → per-slot take counts, summed per class
 5. host: decode — merge each slot's class groups through the exact host
    algebra, yielding the same InFlightNodeClaim objects the greedy path
    produces
 6. host: relaxation outer loop re-runs 1-5 for still-unschedulable pods

Every tensor shape, pad and bucket matches the JAX package's, so each
device plane compares one to one with the reference's. NodePool limits
are enforced at claim creation (provision()), exactly as there.

``solve_batch(entries)`` solves several independent problems together,
answering equal-shape scan dispatches from one batched kernel launch
sequence (``cuda_ffd.cuda_ffd_solve_batched``).

Priority tiers, gangs and preemption (``ops/gangsched.py``): classes run
tier-first with gang members adjacent; kernel-enforced gangs scan through
the gang-atomic solve (a second scan rolls failed gangs back), whose
scans on the card are the hand kernel (``cuda_ffd.cuda_gang_solve``);
rack-labelled fleets give each gang class a per-slot network-level plane
(``ClassStep.topo_rank``) that the kernel's level-grouped first-fit
follows; still-unplaced positive-tier classes get a preemption pass over
the existing nodes' evictable pods, returned as ``Results.evictions``.

``solver_mode="relax"`` layers the convex-relaxation template optimizer
(``ops/relax.py``) over the same scan: the plain FFD answer is dispatched
first (the anytime answer), then the assignment and rounding, then a
candidate FFD scan with the rounded (new_template, kstar) override riding
``ClassStep`` — through the same kernel — adopted only when its score
strictly wins; the verdict caches on the class batch, so a warm solve of
the same problem is one dispatch.

``devices`` resolves as in the JAX package (``parallel/mesh.
resolve_devices``: 0 = every device of the kind, a larger count clamps).
Above 1 the scheduler prepares its planes on the lead device of a mesh
(``parallel/mesh.slot_mesh``) and pads its slot width to a multiple of the
mesh, as JAX does. The kernel takes whole
planes, as JAX's Pallas route does, so a solo scan, the preemption pass and
``relax_choose`` run on the mesh's lead device; a batched dispatch's scans
split the problem axis into contiguous shards, one launch a shard, and
gather the rows back on the lead device.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.nodepool import NodePool
from karpenter_core_tpu_torch.api.objects import Pod
from karpenter_core_tpu_torch.cloudprovider.types import InstanceType
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (
    ExistingNodeSim,
    IncompatibleError,
    InFlightNodeClaim,
    SimNode,
)
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.nodeclaimtemplate import (
    NodeClaimTemplate,
    filter_instance_types,
)
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.preferences import (
    Preferences,
)
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.queue import (
    by_cpu_and_memory_descending,
)
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.scheduler import (
    Results,
    _daemon_compatible,
    node_daemon_pods,
    place_pod,
)
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (
    TYPE_ANTI_AFFINITY,
    TYPE_SPREAD,
    Topology,
    domain_universe,
)
from karpenter_core_tpu_torch import tracing
from karpenter_core_tpu_torch.ops import cuda_ffd
from karpenter_core_tpu_torch.ops import gangsched
from karpenter_core_tpu_torch.ops import masks as mops
from karpenter_core_tpu_torch.ops import relax as relax_ops
from karpenter_core_tpu_torch.ops import topoplan
from karpenter_core_tpu_torch.ops.ffd import (
    BIG,
    BIGI,
    RANK_NONE,
    ClassStep,
    FFDStatics,
    SlotState,
    aggregate_takes,
    aggregate_takes_batched,
    ffd_solve,
    ffd_solve_batched,
)
from karpenter_core_tpu_torch.scheduling import Requirement, Requirements
from karpenter_core_tpu_torch.solver import gangs as gangmod
from karpenter_core_tpu_torch.solver.snapshot import PodClass, group_pods
from karpenter_core_tpu_torch.solver.vocab import (
    EntityMasks,
    GT_NONE,
    LT_NONE,
    decode_requirements,
)
from karpenter_core_tpu_torch.utils import resources as resutil
from karpenter_core_tpu_torch.parallel import mesh as pmesh
from karpenter_core_tpu_torch.utils.device import (
    is_sticky_cuda_error,
    resolve_device,
)

KERNEL_BACKENDS = ("cuda", "reference")
_NARROW = {
    np.dtype(np.int64): np.int32,
    np.dtype(np.uint64): np.uint32,
    np.dtype(np.float64): np.float32,
}

# Densification deferral knobs (see _decode_topo): fresh topology slots at
# or below DENSIFY_THRESHOLD x median pod count drain through the host
# repair path, capped at DENSIFY_CAP of the fresh slots AND at
# DENSIFY_POD_BUDGET total pods per solve (the repair is ~ms/pod of host
# algebra, so the budget bounds the decode-time cost at any scale).
# Deliberately conservative: the pass exists to recover genuinely sparse
# tail slots. Uniform thinness (every slot near the median, the cfg3-5k
# +5% equilibrium of class-batched packing) is NOT repairable this way —
# sweeping thresholds showed median-wide deferral either re-creates the
# same slots (spread/anti constraints force fresh hosts) or devolves into
# a full host re-solve at ~ms/pod.
DENSIFY_THRESHOLD = 0.5
DENSIFY_CAP = 0.125
DENSIFY_POD_BUDGET = 256


def _neutralize(masks: EntityMasks) -> EntityMasks:
    """Apply the neutral-where-undefined invariant required by ffd_step."""
    d = masks.defines
    return EntityMasks(
        mask=np.where(d[:, :, None], masks.mask, True),
        defines=d,
        concrete=np.where(d, masks.concrete, False),
        negative=np.where(d, masks.negative, True),
        gt=masks.gt,
        lt=masks.lt,
    )


def _label_alias(labels: dict) -> bool:
    """True when the labels hold both a deprecated key and the key it
    normalizes to (``Requirement.new``), so ``Requirements.from_labels``
    intersects their two values into one requirement."""
    norm = apilabels.NORMALIZED_LABELS
    return any(norm[k] in labels for k in labels if k in norm)


def _tolerates_taints(tolerations, taints) -> bool:
    return all(any(tol.tolerates(t) for tol in tolerations) for t in taints)


def _bucket(n: int, lo: int = 8) -> int:
    """Next power of two (>= lo): device-array axes pad to bucketed sizes,
    the JAX package's exact shapes (where buckets keep its jit cache warm),
    so every plane compares one to one with the reference's."""
    return max(lo, 1 << max(n - 1, 1).bit_length())


def _bucket_steps(n: int, lo: int = 8) -> int:
    """Half-octave bucket (… 8, 12, 16, 24, 32 …) for the SCAN STEP axis
    only. Scan length costs wall-clock linearly — a diverse 50k topology
    mix lands ~11.5k steps, and a pure power-of-two pad burns 40% of the
    kernel on inert steps — so the step axis takes half octaves for a <=33%
    (avg ~17%) pad ceiling. Tensor axes keep the pure power-of-two buckets:
    their padding costs memory, not scan iterations."""
    p = _bucket(n, lo)
    half = (p // 4) * 3
    if half >= lo and n <= half:
        return half
    return p


def _same_template_gang_ids(classes, Cp: int):
    """[Cp] int32 gang index per class for gangs declaring same-template
    co-location (-1 outside any), plus the gang count — the gang_id input
    of ops/masks.gang_joint_templates. The flag ORs across members (any
    member asking binds the gang), so an unflagged class of a flagged gang
    is constrained too."""
    flagged = {
        g[0]
        for cls in classes
        if (g := getattr(cls, "gang", None)) is not None and g[3]
    }
    by_name: Dict[str, int] = {}
    gid = np.full((Cp,), -1, dtype=np.int32)
    for ci, cls in enumerate(classes):
        g = getattr(cls, "gang", None)
        if g is not None and g[0] in flagged:
            gid[ci] = by_name.setdefault(g[0], len(by_name))
    return gid, len(by_name)


def _pad_cols(t: torch.Tensor, n: int) -> torch.Tensor:
    """Zero/False-pad a device [rows, cols] tensor to n columns."""
    if t.shape[1] >= n:
        return t
    out = torch.zeros((t.shape[0], n), dtype=t.dtype, device=t.device)
    out[:, : t.shape[1]] = t
    return out


def _pad(a: np.ndarray, targets: dict, fill) -> np.ndarray:
    """Pad axes of a to targets {axis: size} with a constant fill."""
    widths = [(0, 0)] * a.ndim
    for axis, size in targets.items():
        widths[axis] = (0, max(size - a.shape[axis], 0))
    if all(w == (0, 0) for w in widths):
        return a
    return np.pad(a, widths, constant_values=fill)


def _refit_slot(
    overhead64q: np.ndarray,
    class_requests64q: np.ndarray,
    takes: List[Tuple[int, int]],
    it_alloc64q: np.ndarray,
    viable: np.ndarray,
) -> Tuple[np.ndarray, List[int]]:
    """One slot's quantized refit: its request vector (the template's
    overhead plus k of each class's request, for each (class, k) in takes)
    and the viable types whose allocatable holds it, in ascending order.
    The quantized vectors are integer-valued float64 far below 2**53, so
    k * request is exactly the k-fold repeated sum."""
    req_vec = overhead64q.copy()
    for ci, k in takes:
        req_vec += k * class_requests64q[ci]
    fits = (req_vec[None, :] <= it_alloc64q[viable]).all(axis=1)
    return req_vec, viable[fits].tolist()


class _SlotOverflow(Exception):
    """More slots needed than max_slots — caller doubles and retries."""


# one slot per pod is the true worst case; 1M slots is far past any
# realistic solve and bounds the doubling loop
_SLOT_HARD_CAP = 1 << 20


@dataclass
class _Prepared:
    vocab: object
    resource_names: List[str]
    catalog: List[InstanceType]
    class_masks: EntityMasks
    class_requests: np.ndarray  # [C, R]
    classes: List[PodClass]
    templates: List[NodeClaimTemplate]
    # DEVICE-RESIDENT until the post-scan fetch (tensors at BUCKETED
    # shapes): class_it [Cp, Tp], tmpl_ok [Cp, Sp], new_template/kstar [Cp]
    # (ops/masks.fresh_viability outputs). _solve_once swaps class_it for
    # the fetched numpy [Cp, T] right before decode — the only host reader.
    class_it: object
    tmpl_ok: object
    new_template: object
    kstar: object
    statics: FFDStatics
    init_state: SlotState
    exist_taint_ok: np.ndarray  # [C, N]
    # the solve round's sims (_solve_once_gen), which its fetch and decode
    # read; empty from _prepare, whose sweep never reads them
    existing_sims: List[ExistingNodeSim]
    n_slots: int
    topo: Topology
    plan: topoplan.TopoPlan
    smask: np.ndarray  # [C, K, V] strict (pod_domains) value masks
    # float64 decode twins, quantized to the device's integer units
    # (unclamped — float64 is exact to 2^53): every decode refit runs in
    # the SAME arithmetic regime as the kernel, so slots the kernel packed
    # exactly full are never rejected over raw-float drift (repeated raw
    # adds drift ~1e-13 at exact boundaries, and whole slots would defer
    # to the per-pod host path).
    # Ceil-requests/floor-capacity stays conservative vs true decimal
    # quantities (k8s resource.Quantity is fixed-point, resources.go:28-66).
    it_alloc64q: np.ndarray  # [pad_T, R] float64 (floor-quantized)
    class_requests64q: np.ndarray  # [C, R] float64 (ceil-quantized)
    tmpl_overhead64q: np.ndarray  # [pad_S, R] float64 (ceil-quantized)
    off_avail_np: np.ndarray  # [pad_T, Z, CT] bool
    tmpl_it_np: np.ndarray  # [pad_S, pad_T] bool
    tmpl_mask_np: np.ndarray  # [pad_S, K, V] bool
    zone_kid: int
    ct_kid: int
    n_zones: int
    n_cts: int
    level_iters: int = 32
    # prepared-state reuse plumbing: Cp is the bucketed class axis
    # the decision planes aggregate to; _batch is the prepared-cache entry
    # the per-class tensors came from (ClassStep device arrays are cached
    # on it by _class_steps); step_class is the device [Jp] step->class
    # index driving the on-device takes aggregation.
    n_classes_padded: int = 8
    _batch: dict = field(default_factory=dict)
    step_class: object = None
    # gangs and tiers — all None/empty for plain problems, whose dispatch
    # then takes the plain scan. gangs: GangSpecs fully on the device path
    # (a gang spanning a fallback class is left to the host backstop,
    # solver/gangs.enforce_atomicity); step_tier/step_gang: device [Jp]
    # rows aligned with the scanned ClassStep; gang_min: device [Gp]
    # per-gang min-count; ev/ev_uids/ev_freed: the evictable-capacity
    # planes and their host uid / request tables
    gangs: list = field(default_factory=list)
    step_tier: object = None
    step_gang: object = None
    gang_min: object = None
    ev: object = None
    ev_uids: list = field(default_factory=list)
    ev_freed: list = field(default_factory=list)
    # relax: the candidate dispatch re-runs the FFD scan from a FRESH init
    # state (the baseline's scan updated its own), so the builder args are
    # kept here; tmpl_price_d is the [Sp] per-template min node price the
    # scored fallback ranks candidates with
    init_args: tuple = None
    tmpl_price_d: object = None
    # rack-aware gangs: per-gang anchor domain ids into the fp entry's
    # RackPlan — None whenever the catalog carries no rack labels
    topo_anchors: dict = None


# ---------------------------------------------------------------------------
# the kernel-dispatch seam
#
# DeviceScheduler.solve runs as a generator that YIELDS one _KernelRequest
# per device dispatch; a dispatcher answers each request with (final
# SlotState, takes-by-class, unplaced-by-class, seconds), or for the
# preemption pass (extra takes-by-class, unplaced-by-class, evicted
# [N, P], seconds). The solo
# dispatcher (_drive_solo) answers one problem's requests one by one; the
# batch dispatcher (solve_batch) interleaves several problems' generators,
# groups their outstanding requests by exact shape (shape_key), and answers
# each group of two or more from one batched scan (_run_kernel_batched).


@dataclass
class _KernelRequest:
    """One device dispatch, reified so a dispatcher outside the generator
    can answer it — solo, or stacked into a batch of problems.

    ``kind`` selects the family: ``"solve"`` (the FFD scan — the
    gang-atomic solve when gang_of_step is set), ``"preempt"`` (the
    eviction pass over a finished solve's state) or ``"relax"`` (the
    relax assignment and rounding, ops/relax.relax_choose, answered with
    (new_template [Cp], kstar [Cp], n_changed, seconds))."""

    init_state: SlotState
    steps: ClassStep
    statics: FFDStatics
    level_iters: int
    step_class: torch.Tensor  # [Jp] step -> class index
    num_classes: int  # Cp, the bucketed class axis
    n_slots: int
    # the dispatch family: "solve", "preempt" or "relax"
    kind: str = "solve"
    # the solver backend that made the request ("ffd" | "relax"): part of
    # the shape key, so a relax problem's dispatches — its plain baseline
    # scan included — never stack with an ffd problem's
    mode: str = "ffd"
    # "cuda": the hand kernel (ops/cuda_ffd.py); "reference": the plain
    # torch scan (ops/ffd.py), the kernel's oracle
    backend: str = "cuda"
    devices: int = 1
    # gang-atomic solve (both None for plain problems): [Jp] int32 gang
    # index of each step (gangmod.GANG_FREE outside any gang,
    # gangmod.GANG_FALLBACK_STRADDLING for host-enforced gangs) and [Gp]
    # int32 per-gang min-count
    gang_of_step: object = None
    gang_min: object = None
    # preemption pass inputs (kind == "preempt")
    step_tier: object = None  # [Jp] int32
    step_gang: object = None  # [Jp] int32
    unplaced: object = None  # [Jp] int32 still-unplaced per step
    ev: object = None  # ops/gangsched.EvPlanes
    node_rounds: int = gangsched.NODE_ROUNDS
    # relax assignment inputs (kind == "relax"): the ops/relax constraint
    # planes (viable, k_cs, k_node, podcost, counts, gang_id,
    # base_template, base_kstar, warm_template[, topo_cost]) and the
    # iteration / gang counts
    relax: tuple = None
    relax_iters: int = 0
    relax_gangs: int = 0
    # the solve's request id (tracing.new_request), named by the dispatch's
    # span, under which its device timer is filed until the solve settles
    request: Optional[int] = None

    def shape_key(self) -> tuple:
        """Exact shape identity: requests with equal keys stack into one
        batched dispatch. Every tensor axis is padded to a power-of-two
        bucket upstream (_bucket), so equal keys across tenants are the
        common case. Each leaf's device is part of the key, so a CPU and a
        CUDA problem never stack, and the backend is, so a "cuda" request
        never rides a "reference" one's dispatch. The gang and preemption
        tensors join the leaf walk, so a gang problem never stacks with a
        plain one, and two same-shaped gang problems do."""
        leaves = [
            x for tree in (self.init_state or (), self.steps or (),
                           self.statics or (),
                           (self.gang_of_step, self.gang_min,
                            self.step_tier, self.step_gang, self.unplaced),
                           self.ev or (), self.relax or ())
            for x in tree if x is not None
        ]
        return (
            self.kind,
            self.mode,
            self.backend,
            tuple(
                (tuple(x.shape), str(x.dtype), str(x.device)) for x in leaves
            ),
            self.level_iters,
            self.num_classes,
            self.devices,
            self.node_rounds,
            self.relax_iters,
            self.relax_gangs,
        )


def _lead_device(req: _KernelRequest) -> torch.device:
    """The device the scheduler prepared the request's planes on."""
    return (req.relax[0] if req.init_state is None
            else req.init_state.kind).device


def _mesh_of(req: _KernelRequest) -> pmesh.SlotMesh:
    """The request's device mesh: ``req.devices`` devices of its kind, led
    by the device the scheduler prepared its planes on (one device: that
    device alone)."""
    return pmesh.slot_mesh(req.devices, _lead_device(req))


def _run_kernel_solo(req: _KernelRequest):
    """Answer one request; the trailing element is the dispatch seconds
    (host enqueue time on the card — the fetch that follows waits for the
    device). On a mesh everything runs whole on the lead device, where the
    scheduler prepared it (JAX's replicated commit before the Pallas
    call). The span ``dispatch`` covers it, and a CUDA event pair its
    device work."""
    t0 = time.perf_counter()
    with tracing.span("dispatch", req.request) as sp:
        timer = tracing.DeviceTimer.begin(_lead_device(req), sp)
        out = _answer_solo(req)
        if timer is not None:
            timer.stop()
    return (*out, time.perf_counter() - t0)


def _answer_solo(req: _KernelRequest):
    if req.kind == "relax":
        nt, ks, changed = relax_ops.relax_choose(
            *req.relax, iters=req.relax_iters, num_gangs=req.relax_gangs
        )
        return nt, ks, int(changed)
    if req.kind == "preempt":
        extra, m_left, evicted = gangsched.preempt_pass(
            req.init_state, req.steps, req.statics,
            req.step_tier, req.step_gang, req.unplaced, req.ev,
            node_rounds=req.node_rounds,
        )
        extra_bc, mleft_bc = aggregate_takes(
            extra, m_left, req.step_class, num_classes=req.num_classes
        )
        return extra_bc, mleft_bc, evicted
    if req.gang_of_step is not None:
        gang_solve = (cuda_ffd.cuda_gang_solve if req.backend == "cuda"
                      else gangsched.gang_solve)
        state, takes, unplaced = gang_solve(
            req.init_state, req.steps, req.statics,
            req.gang_of_step, req.gang_min, level_iters=req.level_iters,
        )
    elif req.backend == "cuda":
        state, takes, unplaced = cuda_ffd.cuda_ffd_solve(
            req.init_state, req.steps, req.statics,
            level_iters=req.level_iters,
        )
    else:
        state, takes, unplaced = ffd_solve(
            req.init_state, req.steps, req.statics,
            level_iters=req.level_iters,
        )
    takes_bc, unplaced_bc = aggregate_takes(
        takes, unplaced, req.step_class, num_classes=req.num_classes
    )
    return state, takes_bc, unplaced_bc


def _drive_solo(gen):
    """Run one problem's solve generator to completion with direct kernel
    dispatches — the single-problem production path."""
    out = None
    while True:
        try:
            req = gen.send(out)
        except StopIteration as stop:
            return stop.value
        out = _run_kernel_solo(req)


def _stack_trees(trees):
    return type(trees[0])(*(
        None if xs[0] is None else torch.stack(xs) for xs in zip(*trees)
    ))


# batch-axis pad floor: padded batch sizes are powers of two (2, 4, 8, ...),
# the JAX package's, so the batch stats agree with it
_BATCH_PAD_LO = 1


def _run_kernel_batched(reqs: List[_KernelRequest]):
    """Answer N equal-shape requests from ONE batched scan.

    The problem axis pads to a power of two with copies of the first
    request's tensors (their outputs are sliced off before anyone reads
    them). On a mesh the scans split the padded axis into contiguous
    shards, one launch a shard, each shard's first launch before any host
    read, and the rows come back in order on the lead device (JAX
    replicates the problem axis and splits slots; splitting problems needs
    no exchange inside a scan, and gives the same rows); the preemption
    pass and ``relax_choose`` run whole on the lead device. Returns
    (per-request (state, takes_bc, unplaced_bc, seconds) list, padded B).
    One ``dispatch`` span names every member's request, and one CUDA
    event pair times the device work, each member taking a 1/B share."""
    B = len(reqs)
    t0 = time.perf_counter()
    with tracing.span("dispatch", tuple(
            r.request for r in reqs if r.request is not None)) as sp:
        timer = tracing.DeviceTimer.begin(_lead_device(reqs[0]), sp, B)
        rows, Bp = _answer_batched(reqs)
        if timer is not None:
            timer.stop()
    # each member's kernel share is an equal split of the batched dispatch
    # (every row does the same padded work)
    share = (time.perf_counter() - t0) / B
    return [(*row, share) for row in rows], Bp


def _answer_batched(reqs: List[_KernelRequest]):
    head = reqs[0]
    B = len(reqs)
    Bp = _bucket(B, lo=_BATCH_PAD_LO)
    reqs_p = list(reqs) + [head] * (Bp - B)
    if head.kind == "relax":
        # the assignment planes carry no slot axis: stack the problem axis
        # and answer every row from one batched pass
        stacked = tuple(
            torch.stack([r.relax[i] for r in reqs_p])
            for i in range(len(head.relax))
        )
        nt_b, ks_b, changed_b = relax_ops.relax_choose_batched(
            *stacked, iters=head.relax_iters, num_gangs=head.relax_gangs
        )
        changed_h = changed_b.cpu().tolist()
        return [
            (nt_b[b], ks_b[b], int(changed_h[b])) for b in range(B)
        ], Bp
    # the stack is a fresh copy, so the kernel updates it in place
    with tracing.span("dispatch.stack"):
        state = _stack_trees([r.init_state for r in reqs_p])
        steps = _stack_trees([r.steps for r in reqs_p])
        statics = _stack_trees([r.statics for r in reqs_p])
        step_class = torch.stack([r.step_class for r in reqs_p])
    if head.kind == "preempt":
        extra_b, mleft_b, evicted_b = gangsched.preempt_pass_batched(
            state, steps, statics,
            torch.stack([r.step_tier for r in reqs_p]),
            torch.stack([r.step_gang for r in reqs_p]),
            torch.stack([r.unplaced for r in reqs_p]),
            _stack_trees([r.ev for r in reqs_p]),
            node_rounds=head.node_rounds,
        )
        extra_bc, mleft_bc = aggregate_takes_batched(
            extra_b, mleft_b, step_class, num_classes=head.num_classes
        )
        return [
            (extra_bc[b], mleft_bc[b], evicted_b[b]) for b in range(B)
        ], Bp
    cuda = head.backend == "cuda"
    mesh = _mesh_of(head)
    if head.gang_of_step is not None:
        gang_sharded = (cuda_ffd.cuda_gang_solve_sharded if cuda
                        else gangsched.gang_solve_sharded)
        trees = (state, steps, statics,
                 torch.stack([r.gang_of_step for r in reqs_p]),
                 torch.stack([r.gang_min for r in reqs_p]))
        parts = gang_sharded(_shards(mesh, Bp, trees),
                             level_iters=head.level_iters)
    else:
        scan = cuda_ffd.cuda_ffd_solve_batched if cuda else ffd_solve_batched
        parts = [scan(*shard, level_iters=head.level_iters)
                 for shard in _shards(mesh, Bp, (state, steps, statics))]
    with tracing.span("dispatch.gather"):
        state_b, takes_b, unplaced_b = pmesh.gather_rows(mesh, parts)
        takes_bc, unplaced_bc = aggregate_takes_batched(
            takes_b, unplaced_b, step_class, num_classes=head.num_classes
        )
        rows = [
            (SlotState(*(x[b] for x in state_b)), takes_bc[b],
             unplaced_bc[b])
            for b in range(B)
        ]
    return rows, Bp


def _shards(mesh, n_rows, trees):
    """``trees`` split into the mesh's contiguous row shards, each on its
    device."""
    return [pmesh.split_rows(trees, lo, hi, dev)
            for lo, hi, dev in pmesh.row_shards(n_rows, mesh)]


def solve_batch(entries):
    """Solve N independent problems together, coalescing compatible scan
    dispatches into batched ones.

    ``entries``: ``[(scheduler, pods), ...]`` — one DISTINCT DeviceScheduler
    per problem (a scheduler carries per-solve mutable state and is not
    reentrant).

    Every problem runs the identical per-problem pipeline as
    ``scheduler.solve(pods)`` — same host prepare, same decode, same
    relaxation loop, same verification — only equal-shape scan dispatches
    are answered together. Problems whose shapes diverge (different
    buckets, or one needs an overflow-retry round the others don't) fall
    back to solo dispatches inside the same call.

    Failure is per-problem: a member whose dispatch or decode raises gets
    an ("error", exc) outcome while its batch-mates complete ("ok",
    Results). A failing batched dispatch (which cannot attribute blame) is
    retried solo per member, so the poisoned problem fails alone. A sticky
    CUDA error (``utils/device.is_sticky_cuda_error``) poisons the process's
    context instead: it goes to every member of the failed dispatch with no
    solo re-run, and every problem still pending in the call gets it in
    place of a launch.

    Returns (outcomes, stats): outcomes aligned with entries; stats counts
    dispatches, batched problems, and batch-axis padding.

    The span ``batch`` covers the call. On exit it names every member's
    request, as a batched dispatch does, and counts the call's stats and
    ``solo_retries``, the members re-run solo after a failed batched
    dispatch.
    """
    if len({id(s) for s, _ in entries}) != len(entries):
        raise ValueError(
            "solve_batch requires a distinct DeviceScheduler per problem"
            " (schedulers are single-solve stateful)"
        )
    # no request while open, so no member span takes it for a parent
    with tracing.span("batch", ()) as sp:
        return _solve_batch(entries, sp)


def _solve_batch(entries, sp: tracing.Span):
    """``solve_batch``'s body; ``sp``, its span, takes the members'
    requests and the call's counts at the end."""

    def _gen_for(scheduler, pods):
        if hasattr(scheduler, "_solve_gen"):
            return scheduler._solve_gen(pods)

        # duck-typed scheduler (test fakes, alternate backends): no kernel
        # seam to interleave, so it runs whole at its batch slot — a
        # zero-yield generator keeps the dispatch loop uniform
        def _compat():
            return scheduler.solve(pods)
            yield  # unreachable; makes _compat a generator

        return _compat()

    gens = []
    outcomes: List[Optional[tuple]] = [None] * len(entries)
    pending: Dict[int, _KernelRequest] = {}
    for i, (scheduler, pods) in enumerate(entries):
        gen = _gen_for(scheduler, pods)
        gens.append(gen)
        try:
            pending[i] = gen.send(None)
        except StopIteration as stop:
            outcomes[i] = ("ok", stop.value)
        except Exception as e:  # per-problem isolation
            outcomes[i] = ("error", e)
    stats = {
        "problems": len(entries),
        "dispatches": 0,
        "batched_dispatches": 0,
        "batched_problems": 0,
        "padded_rows": 0,
        "padded_total_rows": 0,
    }
    requests = tuple(r.request for r in pending.values()
                     if r.request is not None)
    solo_retries = 0
    sticky = None  # the call's first sticky CUDA error: no launch after it
    while pending:
        groups: Dict[tuple, List[int]] = {}
        for i in sorted(pending):
            groups.setdefault(pending[i].shape_key(), []).append(i)
        answers: Dict[int, tuple] = {}
        for idxs in groups.values():
            if sticky is not None:
                for i in idxs:
                    answers[i] = ("error", sticky)
                continue
            if len(idxs) == 1:
                i = idxs[0]
                stats["dispatches"] += 1
                try:
                    answers[i] = ("ok", _run_kernel_solo(pending[i]))
                except Exception as e:
                    answers[i] = ("error", e)
                    if is_sticky_cuda_error(e):
                        sticky = e
                continue
            stats["dispatches"] += 1
            try:
                outs, padded = _run_kernel_batched(
                    [pending[i] for i in idxs]
                )
            except Exception as e:
                if is_sticky_cuda_error(e):
                    # the context is poisoned: a solo re-run can only fail
                    sticky = e
                    for i in idxs:
                        answers[i] = ("error", e)
                    continue
                # the batched dispatch failed as a unit — blame is
                # unattributable, so re-run each member solo inside the
                # same call: the poison fails alone, the rest still solve
                for i in idxs:
                    if sticky is not None:
                        answers[i] = ("error", sticky)
                        continue
                    stats["dispatches"] += 1
                    solo_retries += 1
                    try:
                        answers[i] = ("ok", _run_kernel_solo(pending[i]))
                    except Exception as e2:
                        answers[i] = ("error", e2)
                        if is_sticky_cuda_error(e2):
                            sticky = e2
            else:
                stats["batched_dispatches"] += 1
                stats["batched_problems"] += len(idxs)
                stats["padded_rows"] += padded - len(idxs)
                stats["padded_total_rows"] += padded
                for i, out in zip(idxs, outs):
                    answers[i] = ("ok", out)
        nxt: Dict[int, _KernelRequest] = {}
        for i, (status, out) in answers.items():
            gen = gens[i]
            try:
                if status == "ok":
                    nxt[i] = gen.send(out)
                else:
                    # surface the kernel failure INSIDE the generator so
                    # its cleanup runs and the error lands per-problem
                    nxt[i] = gen.throw(out)
            except StopIteration as stop:
                outcomes[i] = ("ok", stop.value)
            except Exception as e:
                outcomes[i] = ("error", e)
        pending = nxt
    sp.requests = requests
    sp.counts = dict(stats, solo_retries=solo_retries)
    return outcomes, stats


class DeviceScheduler:
    """Same construction surface as the greedy Scheduler, device solve."""

    def __init__(
        self,
        nodepools: List[NodePool],
        instance_types: Dict[str, List[InstanceType]],
        existing_nodes: Optional[List[SimNode]] = None,
        daemonset_pods: Optional[List[Pod]] = None,
        max_slots: int = 256,
        topology: Optional[Topology] = None,
        unavailable_offerings: "frozenset | set" = frozenset(),
        devices: int = 1,
        verify: bool = True,
        recorder=None,
        solver_mode: str = "ffd",
        relax_iters: Optional[int] = None,
        relax_budget_s: Optional[float] = None,
        kernel_backend: str = "cuda",
        device="cuda",
    ):
        # "ffd" is the classic first-fit-decreasing backend; "relax" layers
        # the convex-relaxation template optimizer over the same scan
        # (ops/relax.py) with the FFD result as the scored/anytime
        # fallback. relax_budget_s is the wall budget (from solve start)
        # after which relax work is skipped and the FFD answer serves.
        if solver_mode not in ("ffd", "relax"):
            raise ValueError(f"unknown solver mode {solver_mode!r}")
        self.solver_mode = solver_mode
        self.relax_iters = (
            relax_iters
            if relax_iters is not None
            else relax_ops.DEFAULT_ITERS
        )
        self.relax_budget_s = relax_budget_s
        # incremental warm start: {class signature -> nodepool name} from
        # the packing ledger's prior accepted packing, set by
        # solver/incremental before a solve; _relax_improve lowers it to
        # the per-class warm_template vector. None keeps the cold start.
        self._relax_warm: Optional[Dict] = None
        # kernel backend: "cuda" answers the FFD-scan dispatches with the
        # hand kernel (ops/cuda_ffd.py); "reference" with its plain torch
        # version (ops/ffd.py) — the oracle the tests and the chip smoke
        # compare against. On CPU tensors the kernel wrapper itself runs
        # the plain version.
        if kernel_backend not in KERNEL_BACKENDS:
            raise ValueError(f"unknown kernel backend {kernel_backend!r}")
        self.kernel_backend = kernel_backend
        # explicit device, no fallback: CUDA without a GPU raises here
        self.device = resolve_device(device)
        # ICE'd offerings project onto the catalog exactly like the greedy
        # path (apply_unavailable), so the host-side machinery — template
        # prefilter, decode refit, host fallback, price ordering — all see
        # the stockout; the device side additionally masks the offerings
        # tensor (off_avail in _prepare_with_vocab) so in-kernel zone/ct
        # viability excludes the stocked-out rows
        from karpenter_core_tpu_torch.cloudprovider.types import apply_unavailable

        instance_types = apply_unavailable(instance_types, unavailable_offerings)
        self.unavailable_offerings = frozenset(unavailable_offerings)
        # the device count resolves as in the JAX package (0 = every device
        # of the kind, larger requests clamp to what exists); above 1 the
        # mesh's lead device holds every plane the solve prepares (the
        # batched scans split their problem axis over the mesh)
        self.devices = pmesh.resolve_devices(devices, self.device)
        self.device = pmesh.slot_mesh(self.devices, self.device).lead
        # a supplied Topology carries cluster context (existing pods,
        # exclusions); its groups are rebuilt fresh each solve round, so only
        # the constructor inputs are kept
        self._topology_context = topology
        self.nodepools = sorted(nodepools, key=lambda n: (-n.spec.weight, n.name))
        self.instance_types = instance_types
        # initialized nodes first, then by name (scheduler.go:344-354) —
        # must match the greedy oracle's fill order
        self.existing_nodes = sorted(
            existing_nodes or [], key=lambda n: (not n.initialized, n.name)
        )
        self.daemonset_pods = list(daemonset_pods or [])
        self.max_slots = max_slots
        # NodePool limits minus existing usage (scheduler.go:85-88,336-340)
        self.remaining_resources: Dict[str, dict] = {
            np_.name: dict(np_.spec.limits)
            for np_ in self.nodepools
            if np_.spec.limits
        }
        for node in self.existing_nodes:
            if node.nodepool_name in self.remaining_resources:
                self.remaining_resources[node.nodepool_name] = resutil.subtract(
                    self.remaining_resources[node.nodepool_name],
                    node.capacity or node.available,
                )
        self.domains_universe = domain_universe(
            nodepools, instance_types, self.existing_nodes
        )

        tolerate_pns = any(
            t.effect == "PreferNoSchedule"
            for np_ in self.nodepools
            for t in np_.spec.template.taints
        )
        self.preferences = Preferences(tolerate_pns)

        self.templates: List[NodeClaimTemplate] = []
        for np_ in self.nodepools:
            nct = NodeClaimTemplate.from_nodepool(np_)
            nct.instance_type_options = filter_instance_types(
                instance_types.get(np_.name, []), nct.requirements, {}
            ).remaining
            if nct.instance_type_options:
                self.templates.append(nct)

        # daemon overhead per template (scheduler.go:358-364)
        self.daemon_overhead = [
            resutil.requests_for_pods(
                *[p for p in self.daemonset_pods if _daemon_compatible(nct, p)]
            )
            for nct in self.templates
        ]

        # -- prepared-state caches (incremental re-solve) ------------------
        # Everything encoded over a frozen vocab is a pure function of
        # (vocab fingerprint, entity): catalog/template/existing-node
        # tensors cache per fingerprint (_fp_cache), per-class rows cache
        # per (fingerprint, class signature) (_row_cache), and the fully
        # stacked class batch — including the device-resident ClassStep —
        # caches per (fingerprint, slot count, topology-plan digest, class
        # signature+count tuple) (_batch_cache). Relaxation rounds union
        # the prior round's vocab (_round_frozen) so spec-shrinking relaxes
        # keep the fingerprint and rebuild only the classes they mutated.
        self._catalog = None
        self._universe = None
        self._base_resources = None
        self._fp_ids: Dict[tuple, int] = {}
        self._fp_cache: Dict[int, dict] = {}
        self._row_cache: Dict[tuple, dict] = {}
        self._batch_cache: Dict[tuple, dict] = {}
        self._round_frozen = None
        # adaptive slot-axis sizing: warm solves start at a bucket sized
        # from the previous solve's observed usage instead of max_slots
        self._slots_hint: Optional[int] = None
        self._h2d_bytes = 0
        self._h2d_dev_bytes = 0
        self.last_phase_stats: Dict[str, float] = {}
        # the request id of the solve in progress (tracing.new_request)
        self._request: Optional[int] = None
        # host-side result verification (models/verify_pass.py over the
        # verbatim solver/verify.py): an independent O(pods) constraint
        # re-check over the final Results — the trust anchor between the
        # device kernels and NodeClaim creation. A
        # rejected result degrades THIS solve to the greedy host path
        # (metrics + Warning event via the recorder when one is wired).
        self.verify = verify
        self.recorder = recorder
        # built lazily ONCE: the verifier's setup (domain universe,
        # per-pool catalog name sets) is invariant for this scheduler's
        # lifetime — only the topology context swaps per request
        self._verifier = None

    _FP_CACHE_CAP = 4
    _BATCH_CACHE_CAP = 4
    # entry-count bound on the per-class row cache: each row carries two
    # [K,V] bool planes plus small vectors (~10-20KB at production K/V),
    # so 20k entries stays in the low hundreds of MB — far above any real
    # class-mix working set (the diverse 50k bench lands ~6k classes) but
    # safely below sidecar OOM territory under label-churn signatures
    _ROW_CACHE_CAP = 20_000

    def update_topology_context(self, topology: Optional[Topology]) -> None:
        """Swap the cluster topology context in place. Per-round Topology
        state is rebuilt from the context on every solve, so a cached
        scheduler (solverd reuses them across RPC calls keyed on the
        problem fingerprint, which ignores the pod-derived excluded-uid
        list) takes the request's live context here instead of rebuilding
        the whole scheduler."""
        self._topology_context = topology

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """Host->device copy with byte accounting for the phase breakdown.
        64-bit host arrays land as 32-bit tensors, as JAX's default dtype
        canonicalization lands them in the reference."""
        a = np.asarray(a)
        self._h2d_bytes += a.nbytes
        self._h2d_dev_bytes += a.nbytes
        if a.dtype in _NARROW:
            a = a.astype(_NARROW[a.dtype])
        return torch.tensor(np.array(a, order="C"), device=self.device)

    def _scalar(self, value, dtype=torch.int32) -> torch.Tensor:
        return torch.tensor(value, dtype=dtype, device=self.device)

    def prewarm(self, class_buckets: Sequence[int] = (8, 64, 256)) -> None:
        """Run a synthetic solve at each common class-count bucket before
        the first real batch, so the first real solve finds the CUDA
        context, the kernel library and the allocator's pools ready.
        Kernel shapes bucket on the class axis (_bucket), so a solve with
        N distinct pod shapes exercises the shapes a real N-class batch
        hits."""
        GIB = 2.0**30
        from karpenter_core_tpu_torch.api.objects import ObjectMeta

        for target in class_buckets:
            pods = [
                Pod(
                    metadata=ObjectMeta(name=f"prewarm-{target}-{i}"),
                    resource_requests={
                        "cpu": 0.001 * (1 + i % 64),
                        "memory": 0.125 * GIB * (1 + i // 64),
                    },
                )
                for i in range(target)
            ]
            self.solve(pods)

    def solve(self, pods: List[Pod]) -> Results:
        """Device solve + host decode + relaxation outer loop.

        Each relaxation round re-solves the FULL pod set (relaxations mutate
        only previously-failed pods' specs), so placements from earlier rounds
        are never dropped — the same world-re-solve the reference reaches via
        requeue-on-relax (scheduler.go:251-258).

        Implemented as a driven generator (_solve_gen): the generator runs
        every host phase and YIELDS at each kernel dispatch, which the solo
        dispatcher answers."""
        return _drive_solo(self._solve_gen(pods))

    def _solve_gen(self, pods: List[Pod]):
        """The solve under one request id: the span ``solve`` and every
        span of its phases and dispatches carry it. Its dispatches' device
        seconds are read at its end, every one of them waited for by a
        host read of its results."""
        self._request = rid = tracing.new_request()
        try:
            with tracing.span("solve", rid):
                return (yield from self._solve_rounds_gen(pods))
        finally:
            device_s = tracing.settle(rid)
            if device_s is not None:
                self.last_phase_stats["device_s"] = device_s

    def _solve_rounds_gen(self, pods: List[Pod]):
        # refreshed by _sorted_classes each round; False covers the
        # no-template/no-existing early return, where nothing places and
        # the gang backstop has nothing to strip
        self._gangsched_engaged = False
        all_pods = list(pods)
        errors: Dict[str, str] = {}
        claims: List[InFlightNodeClaim] = []
        # fresh per-solve copy: place_pod subtracts from it as fallback
        # claims open, and a reused scheduler must not accumulate rounds
        self._round_remaining = {
            k: dict(v) for k, v in self.remaining_resources.items()
        }
        existing_sims: List[ExistingNodeSim] = []
        E = len(self.existing_nodes)
        base_slots = self.max_slots
        while base_slots < E:
            base_slots *= 2
        # Adaptive slot axis: every kernel plane is [N, ...], so running a
        # 235-node solve at the caller's 4096-slot ceiling wastes ~16x the
        # per-step HBM traffic on slots that can never take. Warm solves
        # start at a bucket sized from the last solve's observed usage
        # (2x headroom); an overflow costs one cheap small-N scan and
        # retries larger, so the packing is identical — padding slots are
        # inert by construction (kind=0 never takes; tested by the
        # slot-axis-invariance parity test).
        if self._slots_hint:
            max_slots = min(
                base_slots,
                max(_bucket(max(2 * self._slots_hint, E + 1)), 64),
            )
        else:
            max_slots = base_slots
        self._round_frozen = None  # vocab union seed is per solve() call
        # anytime clock: every relax-budget check measures from the moment
        # THIS solve started, so "budget expired" always leaves the
        # already-computed FFD answer as the serve
        self._solve_t0 = time.perf_counter()
        # plan_s, prepare_s, decode_s and verify_s are the sums of the
        # solve's spans of those names; kernel_s is the host wall time of
        # the dispatches and fetches, and device_s (on the card only) the
        # device's own time of the dispatches, by CUDA events
        self.last_phase_stats = stats = {
            "plan_s": 0.0, "prepare_s": 0.0, "kernel_s": 0.0,
            "decode_s": 0.0, "fetch_bytes": 0, "h2d_bytes": 0,
            "rounds": 0, "slots": max_slots, "used_slots": 0,
            "prep_cache_hits": 0, "prep_cache_misses": 0,
            # per-device h2d/fetch bytes: the bytes the port puts on (and
            # fetches from) its lead device, which holds every prepared
            # plane whole, so they equal the totals on a mesh too (JAX
            # counts its sharded slot planes at 1/n)
            "n_devices": self.devices,
            "h2d_dev_bytes": 0, "fetch_dev_bytes": 0,
            # which backend served this solve (bench/ops attribution)
            "solver_mode": self.solver_mode,
            # ... and which kernel backend answered its scan dispatches
            "kernel_backend": self.kernel_backend,
            "request": self._request,
        }
        if self.solver_mode == "relax":
            stats["relax"] = {}

        from karpenter_core_tpu_torch.metrics import wiring as m

        # relaxation terminates naturally: each relax() strips one soft term
        # (preferences.go:38-57); the greedy oracle loops the same way
        first_round = True
        while True:
            if not first_round:
                m.SOLVER_RELAX_ROUNDS.inc()
            first_round = False
            stats["rounds"] += 1
            stats["slots"] = max_slots
            # per-round solve duration = this round's OWN phase work
            # (plan/prepare/kernel/decode deltas), not wall across the
            # yield, so a batching dispatcher cannot charge other problems'
            # work to this one
            r0 = {
                k: stats[k]
                for k in ("plan_s", "prepare_s", "kernel_s", "decode_s")
            }
            result = yield from self._solve_once_gen(all_pods, max_slots)
            m.SOLVER_SOLVE_DURATION.observe(
                sum(stats[k] - r0[k] for k in r0)
            )
            if result is None:  # slot overflow — retry larger
                if max_slots >= _SLOT_HARD_CAP:
                    errors = {
                        p.uid: f"solver slot overflow at {max_slots} slots"
                        for p in all_pods
                    }
                    return Results(
                        new_node_claims=[], existing_nodes=[], pod_errors=errors
                    )
                if max_slots < base_slots:
                    # the adaptive shrink guessed low — jump back toward
                    # the configured ceiling fast (x4) before the classic
                    # doubling takes over past it
                    max_slots = min(max_slots * 4, base_slots)
                else:
                    max_slots *= 2
                continue
            claims, existing_sims, failed, evictions = result
            errors = {p.uid: msg for p, msg in failed}
            if not failed:
                break
            relaxed_any = False
            for p, _msg in failed:
                if self.preferences.relax(p):
                    relaxed_any = True
            if not relaxed_any:
                break
        if stats["used_slots"]:
            # decay, don't snap: a burst of small solves (prewarm, quiet
            # cluster) must not drop the hint so far a normal batch pays a
            # ladder of overflow retries
            prev = self._slots_hint or 0
            self._slots_hint = max(int(stats["used_slots"]), prev // 2)

        for c in claims:
            c.finalize_scheduling()
        results = Results(
            new_node_claims=claims,
            existing_nodes=existing_sims,
            pod_errors=errors,
            evictions=evictions,
        )
        if self._gangsched_engaged:
            # the decode-seam atomicity backstop (the scan already rolled
            # failed gangs back; this catches host-repair divergence) — it
            # MUST run before verification, which treats a partially
            # materialized gang as a hard violation
            gangmod.enforce_atomicity(results, all_pods)
            # distance stripping before eviction pruning (a stripped gang's
            # evictions must prune with it) and before verification, which
            # treats an exceeded hard max-hops as a hard violation
            node_labels = {
                n.name: getattr(n, "labels", None) or {}
                for n in self.existing_nodes
            }
            gangmod.enforce_distance(results, all_pods, node_labels)
            gangmod.prune_evictions(results)
            # rank-ordered slot assignment runs LAST: a within-class
            # permutation of an already-final packing
            gangmod.rank_order_pods(results, all_pods, node_labels)
            whole = sum(
                1
                for mpods in gangmod.gang_members(all_pods).values()
                if mpods and all(p.uid in results.pod_errors for p in mpods)
            )
            if whole:
                m.SOLVER_GANG_UNSCHEDULABLE.inc(by=whole)
        if self.verify:
            from karpenter_core_tpu_torch.models.verify_pass import VerifyPass
            from karpenter_core_tpu_torch.solver import verify as verifymod

            with tracing.span("verify", self._request, stats=stats,
                              key="verify_s") as sp:
                if self._verifier is None:
                    self._verifier = VerifyPass(
                        self.nodepools,
                        self.instance_types,
                        existing_nodes=self.existing_nodes,
                        daemonset_pods=self.daemonset_pods,
                        topology=self._topology_context,
                        unavailable_offerings=self.unavailable_offerings,
                    )
                else:
                    # a cached scheduler (solverd reuse) swaps contexts per
                    # request; everything else the verifier holds is
                    # invariant
                    self._verifier.topology = self._topology_context
                violations = self._verifier.verify(results, all_pods)
                for key, n in self._verifier.take_counts().items():
                    sp.count(key, n)
            if violations:
                verifymod.reject(violations, "inproc", self.recorder)
                return self._verified_fallback(all_pods)
        return results

    def _verified_fallback(self, pods: List[Pod]) -> Results:
        """A device result failed verification: re-solve on the host
        greedy path over the same inputs (the RemoteScheduler degradation
        twin, one layer down). Correctness beats speed exactly once — the
        rejection metric says the device tier needs attention. Problems
        carrying priorities/gangs degrade through the tiered-greedy-with-
        preemption wrapper (solver/gangs.host_gang_solve), so degraded
        means slower, never semantically different."""
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.scheduler import (
            Scheduler,
        )

        def make_scheduler():
            return Scheduler(
                self.nodepools,
                self.instance_types,
                existing_nodes=self.existing_nodes,
                daemonset_pods=self.daemonset_pods,
                topology=self._topology_context,
                unavailable_offerings=self.unavailable_offerings,
            )

        return gangmod.degraded_solve(
            make_scheduler, pods, self.existing_nodes
        )

    # ------------------------------------------------------------------

    def _solve_once_gen(self, pods: List[Pod], max_slots: int):
        """One solve round as a generator: host prepare, then a single
        ``yield`` of a _KernelRequest at the device dispatch (the dispatcher
        sends back (state, takes_bc, unplaced_bc)), then fetch + decode.
        Returns None on slot overflow (caller retries larger)."""
        if not self.templates and not self.existing_nodes:
            # no viable templates and no existing capacity: everything fails
            return [], [], [(p, "no nodepool matched pod") for p in pods], {}

        stats = self.last_phase_stats
        rid = self._request
        self._h2d_bytes = 0
        self._h2d_dev_bytes = 0
        with tracing.span("plan", rid, stats=stats, key="plan_s"):
            # one Topology per solve round; every pod's groups are
            # (re)built so relaxed specs take effect (topology.go
            # NewTopology:60-86)
            ctx = self._topology_context
            topo = Topology(
                domains={
                    k: set(v)
                    for k, v in (
                        ctx.domains if ctx is not None
                        else self.domains_universe
                    ).items()
                },
                existing_pods=ctx.existing_pods if ctx is not None else None,
                excluded_pod_uids=(ctx.excluded_pods if ctx is not None
                                   else ()),
            )
            topo.ensure_inverse_initialized()
            for p in pods:
                # constraint-free pods build no groups; skipping the call
                # is the 50k-path win (update() itself is a no-op for them)
                if p.topology_spread_constraints or p.affinity is not None:
                    topo.update(p)

            # the topology planner decides which constraint shapes run
            # in-kernel (device count state) and which fall back to the
            # host algebra
            classes = self._sorted_classes(pods, topo)
            plan = topoplan.plan_topology(classes, topo)
            self._composition_cache: Dict[tuple, tuple] = {}

        from karpenter_core_tpu_torch.metrics import wiring as m

        try:
            with tracing.span("prepare", rid, stats=stats, key="prepare_s",
                              histogram=m.SOLVER_PREPARE_DURATION):
                prep = self._prepare_with_vocab(plan, max_slots, topo)
                # the round's existing-node sims, which register their
                # hostnames with its topology; the fetch and decode read
                # them, the sweep's prepare (_prepare) builds none
                with tracing.span("prepare.nodes", rid) as sp:
                    prep.existing_sims = [
                        ExistingNodeSim(
                            node, topo, self._node_daemon_overhead(node))
                        for node in self.existing_nodes
                    ]
                    sp.count("sims", len(prep.existing_sims))
                steps = self._class_steps(prep)
        except _SlotOverflow:
            return None
        stats["h2d_bytes"] += self._h2d_bytes
        stats["h2d_dev_bytes"] += self._h2d_dev_bytes

        # relax: a cached WON verdict for this exact class batch applies the
        # rounded template override to the ONE dispatch below — warm relax
        # solves cost a single scan, like ffd mode, and pack the
        # relaxation's better answer. An unevaluated batch dispatches plain
        # first (the anytime answer) and _relax_improve runs the optimizer
        # after.
        relax_verdict = None
        if self.solver_mode == "relax":
            relax_verdict = prep._batch.get("relax_verdict")
            if relax_verdict is not None and relax_verdict.get("won"):
                steps = self._override_steps(
                    prep, steps,
                    relax_verdict["new_template"], relax_verdict["kstar"],
                )

        # the device dispatch is the generator's yield point: the dispatcher
        # answers with the FFD scan + the per-class aggregate. The kernel
        # works on its own copy of init_state; _Prepared rebuilds it per
        # round, so mark it spent. The dispatcher reports the dispatch seconds;
        # the fetches below are ours.
        state, takes_bc, unplaced_bc, kernel_share_s = yield _KernelRequest(
            init_state=prep.init_state,
            steps=steps,
            statics=prep.statics,
            level_iters=prep.level_iters,
            step_class=prep.step_class,
            num_classes=prep.n_classes_padded,
            n_slots=prep.n_slots,
            mode=self.solver_mode,
            backend=self.kernel_backend,
            devices=self.devices,
            # the gang-atomic solve only when kernel-enforced gangs exist
            gang_of_step=(
                prep.step_gang if prep.gang_min is not None else None
            ),
            gang_min=prep.gang_min,
            request=rid,
        )
        prep.init_state = None
        t0 = time.perf_counter()
        # the per-step takes were summed to per-class decision planes on
        # the device by the dispatcher; fetch the two head scalars (one sync)
        # to learn how many slots the solve touched — every remaining plane
        # is sliced to that bucketed window before the bulk fetch, so the
        # device->host transfer scales with nodes PACKED, not max_slots
        with tracing.span("fetch", rid):
            head = self._head(state)
        if bool(head["overflow"]):
            kdt = kernel_share_s + (time.perf_counter() - t0)
            m.SOLVER_KERNEL_DURATION.observe(kdt)
            stats["kernel_s"] += kdt
            return None

        # -- relax improve pass ---------------------------------------------
        # With the baseline (anytime) answer in hand, run the relaxation and
        # adopt its packing only when the scored comparison says it strictly
        # wins; the preemption pass and decode below then work on the
        # winner.
        if self.solver_mode == "relax":
            if relax_verdict is not None:
                rstats = stats.get("relax")
                if rstats is not None:
                    rstats["outcome"] = (
                        "cached_won"
                        if relax_verdict.get("won")
                        else "cached_kept_ffd"
                    )
                    rstats["cached"] = True
                m.SOLVER_RELAX_BACKEND.inc({"outcome": "cached"})
            else:
                state, takes_bc, unplaced_bc, rdt = yield from (
                    self._relax_improve(
                        prep, steps, state, takes_bc, unplaced_bc
                    )
                )
                kernel_share_s += rdt
                # the adopted packing may differ from the baseline whose
                # head was fetched above: the fetch window (and the slot
                # hint) follow the WINNER's state
                with tracing.span("fetch", rid):
                    head = self._head(state)

        evictions: Dict[str, List[str]] = {}
        # -- preemption pass ------------------------------------------------
        # Still-unplaced positive-tier gang-free classes get one more
        # device dispatch against the evictable-capacity planes; the
        # selected eviction set comes back as claims, and the freed
        # capacity is credited to the victims' sims so decode accepts the
        # preempted placements (the operator drains before it binds).
        C = len(prep.classes)
        if prep.ev is not None and prep.step_tier is not None and C:
            u_host = unplaced_bc[:C].cpu().numpy()
            goc = prep._batch["gang_of_class"][:C]
            toc = prep._batch["tier_of_class"][:C]
            if bool(
                ((u_host > 0) & (toc > 0) & (goc == gangmod.GANG_FREE)).any()
            ):
                J = len(plan.steps)
                Jp = int(prep.step_class.shape[0])
                valid = torch.arange(Jp, device=unplaced_bc.device) < J
                u_step = torch.where(
                    valid, unplaced_bc[prep.step_class.long()],
                    torch.zeros_like(prep.step_class),
                ).to(torch.int32)
                extra_bc, mleft_bc, evicted, pdt = yield _KernelRequest(
                    init_state=state,
                    steps=steps,
                    statics=prep.statics,
                    level_iters=prep.level_iters,
                    step_class=prep.step_class,
                    num_classes=prep.n_classes_padded,
                    devices=self.devices,
                    n_slots=prep.n_slots,
                    kind="preempt",
                    step_tier=prep.step_tier,
                    step_gang=prep.step_gang,
                    unplaced=u_step,
                    ev=prep.ev,
                    backend=self.kernel_backend,
                    request=rid,
                )
                kernel_share_s += pdt
                takes_bc = takes_bc + extra_bc
                unplaced_bc = mleft_bc
                ev_host = evicted.cpu().numpy()
                for ei, uids in enumerate(prep.ev_uids):
                    hits = np.nonzero(ev_host[ei, : len(uids)])[0]
                    if not len(hits):
                        continue
                    sim = prep.existing_sims[ei]
                    evictions[sim.name] = [uids[j] for j in hits]
                    freed = resutil.merge(
                        *(prep.ev_freed[ei][j] for j in hits)
                    )
                    # the victims' capacity is credited to the sim so the
                    # decode adds (and only they) see it
                    sim.cached_available = resutil.merge(
                        sim.cached_available, freed
                    )

        N = prep.n_slots
        used = max(int(head["next_free"]), len(prep.existing_sims), 1)
        stats["used_slots"] = max(stats["used_slots"], used)
        ub = min(N, _bucket(used))

        def win(a):  # bucketed used-slot window on the slot axis
            return a[:ub] if ub < N else a

        fetch = dict(
            takes_bc=takes_bc[:, :ub] if ub < N else takes_bc,
            unplaced_bc=unplaced_bc,
            template=win(state.template),
        )
        if plan.has_device_topology():
            fetch.update(
                valmask=win(state.valmask),
                defines=win(state.defines),
                complement=win(state.complement),
                gt=win(state.gt),
                lt=win(state.lt),
                itmask=win(state.itmask),
                hcount=win(state.hcount),
                zcount=state.zcount,
            )
        else:
            # only the topology-free decode reads class_it host-side
            # (_decode_composition); it rides the single post-scan fetch
            fetch["class_it"] = prep.class_it
        with tracing.span("fetch", rid):
            out = {k: v.cpu().numpy() for k, v in fetch.items()}
        kdt = kernel_share_s + (time.perf_counter() - t0)
        m.SOLVER_KERNEL_DURATION.observe(kdt)
        stats["kernel_s"] += kdt
        fetched = sum(np.asarray(v).nbytes for v in out.values()) + 16
        stats["fetch_bytes"] += fetched  # + the head scalars
        # the fetch comes whole from the lead device
        stats["fetch_dev_bytes"] += fetched
        m.SOLVER_FETCH_BYTES.inc(by=fetched)
        # slice bucketed device shapes back to the natural sizes decode
        # (and the topoplan arrays) index with
        C = len(prep.classes)
        sh = self._pad_shapes
        out["takes_bc"] = np.asarray(out["takes_bc"])[:C]
        out["unplaced_bc"] = np.asarray(out["unplaced_bc"])[:C]
        if plan.has_device_topology():
            out["valmask"] = np.asarray(out["valmask"])[:, : sh["K"], : sh["V"]]
            out["defines"] = np.asarray(out["defines"])[:, : sh["K"]]
            out["complement"] = np.asarray(out["complement"])[:, : sh["K"]]
            out["gt"] = np.asarray(out["gt"])[:, : sh["K"]]
            out["lt"] = np.asarray(out["lt"])[:, : sh["K"]]
            out["itmask"] = np.asarray(out["itmask"])[:, : sh["T"]]
            out["hcount"] = np.asarray(out["hcount"])[:, : sh["Gh"]]
            out["zcount"] = np.asarray(out["zcount"])[: sh["Gz"], : sh["V"]]
        else:
            prep.class_it = np.asarray(out["class_it"])[:, : sh["T"]]
        with tracing.span("decode", rid, stats=stats, key="decode_s",
                          histogram=m.SOLVER_DECODE_DURATION):
            claims, existing_sims, failed = self._decode(prep, out)

            # ineligible topology classes: host loop over the post-device
            # cluster
            with tracing.span("decode.replay", rid):
                fallback_pods = [
                    p for cls in plan.fallback_classes for p in cls.pods
                ]
                if fallback_pods:
                    m.SOLVER_HOST_FALLBACK_PODS.inc(
                        {"cause": "ineligible"}, by=len(fallback_pods)
                    )
                fallback_requests = {
                    p.uid: resutil.requests_for_pods(p) for p in fallback_pods
                }
                for p in by_cpu_and_memory_descending(
                    fallback_pods, fallback_requests
                ):
                    err = self._host_fallback_add(
                        p, claims, existing_sims, topo,
                        fallback_requests[p.uid]
                    )
                    if err is not None:
                        failed.append((p, err))
        return claims, existing_sims, failed, evictions

    # ------------------------------------------------------------------

    @staticmethod
    def _head(state: SlotState) -> dict:
        """The two head scalars of a finished scan, in one host read."""
        head_t = torch.stack(
            [state.overflow.to(torch.int32), state.next_free]
        ).cpu()
        return {"overflow": int(head_t[0]), "next_free": int(head_t[1])}

    # -- relax ------------------------------------------------------------

    def _override_steps(self, prep: _Prepared, steps: ClassStep,
                        nt, ks) -> ClassStep:
        """Lift a per-class (new_template, kstar) override onto the scanned
        step axis: gather by the step->class index, keep pad steps inert.
        A local copy — the cached ClassStep on prep._batch is never
        mutated."""
        Jp = int(prep.step_class.shape[0])
        J = len(prep.plan.steps)
        sc = prep.step_class.long()
        valid = torch.arange(Jp, device=sc.device) < J
        return steps._replace(
            new_template=torch.where(
                valid, nt[sc], torch.full_like(steps.new_template, -1)
            ),
            kstar=torch.where(
                valid, ks[sc], torch.zeros_like(steps.kstar)
            ),
        )

    def _relax_expired(self) -> bool:
        return (
            self.relax_budget_s is not None
            and time.perf_counter() - self._solve_t0 > self.relax_budget_s
        )

    def _relax_improve(self, prep: _Prepared, steps: ClassStep,
                       state, takes_bc, unplaced_bc):
        """The relax backend's optimizing pass, as a generator riding the
        same dispatch seam as the solve itself.

        The caller holds the finished plain-FFD dispatch — the ANYTIME
        answer. This pass (1) checks the wall budget (expired -> serve
        FFD), (2) dispatches the assignment and rounding
        (ops/relax.relax_choose; a no-change rounding short-circuits),
        (3) re-runs the unmodified FFD/gang scan from a fresh init state
        with the rounded (new_template, kstar) override — on the card the
        same hand kernel as every scan — and (4) adopts the candidate only
        when its score (unplaced, fresh nodes, $-cost proxy) strictly
        improves. The verdict caches on the class batch, so warm re-solves
        of the same problem dispatch ONCE with the winning override.

        Returns (state, takes_bc, unplaced_bc, kernel_seconds) — the
        winner's."""
        from karpenter_core_tpu_torch.metrics import wiring as m

        rstats = self.last_phase_stats.setdefault("relax", {})
        extra = 0.0

        def outcome(tag: str):
            rstats["outcome"] = tag
            m.SOLVER_RELAX_BACKEND.inc({"outcome": tag})

        planes = prep._batch.get("relax")
        if planes is None:
            # no fresh-node axis (catalog/template-free problem): nothing
            # to optimize, the FFD answer is the answer
            outcome("infeasible")
            return state, takes_bc, unplaced_bc, extra
        if self._relax_expired():
            outcome("deadline")
            return state, takes_bc, unplaced_bc, extra
        # incremental warm start: lower the ledger's prior per-class
        # template choice ({signature -> nodepool name}) to a [Cp] index
        # vector over THIS prep's template axis; -1 (cold) wherever the
        # ledger is silent or the pool no longer templates
        Cp = int(prep.new_template.shape[0])
        wvec = np.full((Cp,), -1, dtype=np.int32)
        if self._relax_warm:
            pool_to_tmpl = {
                t.nodepool_name: si for si, t in enumerate(self.templates)
            }
            for ci, cls in enumerate(prep.classes[:Cp]):
                si = pool_to_tmpl.get(self._relax_warm.get(cls.signature))
                if si is not None:
                    wvec[ci] = si
            rstats["warm_classes"] = int((wvec >= 0).sum())
        # the rack-aware hop-cost plane rides as a trailing optional leaf:
        # absent for label-free problems, so the shape key never stacks
        # topo and non-topo relax dispatches together
        relax_tuple = (
            planes["viable"], planes["k_cs"], planes["k_node"],
            planes["podcost"], planes["counts"], planes["gang_id"],
            prep.new_template, prep.kstar,
            self._dev(wvec),
        )
        topo_np = prep._batch.get("topo_cost_of_class")
        if topo_np is not None:
            tc_d = prep._batch.get("topo_cost_d")
            if tc_d is None:
                Sp = int(prep.tmpl_price_d.shape[0])
                tc_d = self._dev(_pad(topo_np, {0: Cp, 1: Sp}, 0.0))
                prep._batch["topo_cost_d"] = tc_d
            relax_tuple = relax_tuple + (tc_d,)
        nt, ks, changed, dt = yield _KernelRequest(
            init_state=None, steps=None, statics=None,
            level_iters=prep.level_iters, step_class=None,
            num_classes=prep.n_classes_padded, devices=self.devices,
            n_slots=prep.n_slots, kind="relax", mode="relax",
            relax=relax_tuple,
            relax_iters=self.relax_iters, relax_gangs=planes["n_gangs"],
            backend=self.kernel_backend, request=self._request,
        )
        extra += dt
        rstats["template_moves"] = int(changed)
        if int(changed) == 0:
            # rounding agrees with first-template-wins: the FFD packing IS
            # the relaxation's; remember, so warm solves skip even the
            # assignment dispatch
            prep._batch["relax_verdict"] = {"won": False}
            outcome("noop")
            return state, takes_bc, unplaced_bc, extra
        if self._relax_expired():
            outcome("deadline")
            return state, takes_bc, unplaced_bc, extra
        # candidate: the unmodified scan (gang twin included) from a fresh
        # init state with the rounded override riding ClassStep
        init2 = self._make_init_state(*prep.init_args)
        steps2 = self._override_steps(prep, steps, nt, ks)
        state2, takes2_bc, unplaced2_bc, dt2 = yield _KernelRequest(
            init_state=init2, steps=steps2, statics=prep.statics,
            level_iters=prep.level_iters, step_class=prep.step_class,
            num_classes=prep.n_classes_padded, devices=self.devices,
            n_slots=prep.n_slots,
            gang_of_step=(
                prep.step_gang if prep.gang_min is not None else None
            ),
            gang_min=prep.gang_min,
            mode="relax",
            backend=self.kernel_backend,
            request=self._request,
        )
        extra += dt2
        t0 = time.perf_counter()
        if bool(state2.overflow):
            # the override needed more slots than the baseline's axis —
            # keep the FFD packing rather than re-growing for a candidate
            prep._batch["relax_verdict"] = {"won": False}
            outcome("overflow")
            extra += time.perf_counter() - t0
            return state, takes_bc, unplaced_bc, extra
        uf, nf, cf = relax_ops.relax_score(
            state, prep.tmpl_price_d, unplaced_bc
        )
        ur, nr, cr = relax_ops.relax_score(
            state2, prep.tmpl_price_d, unplaced2_bc
        )
        ints = torch.stack([uf, nf, ur, nr]).to(torch.int64).cpu().tolist()
        costs = torch.stack([cf, cr]).cpu().tolist()
        extra += time.perf_counter() - t0
        key_f = (ints[0], ints[1], costs[0])
        key_r = (ints[2], ints[3], costs[1])
        rstats.update(
            unplaced_ffd=key_f[0], nodes_ffd=key_f[1],
            cost_ffd=round(key_f[2], 3),
            unplaced_relax=key_r[0], nodes_relax=key_r[1],
            cost_relax=round(key_r[2], 3),
        )
        if key_r < key_f:
            prep._batch["relax_verdict"] = {
                "won": True, "new_template": nt, "kstar": ks,
            }
            outcome("won")
            return state2, takes2_bc, unplaced2_bc, extra
        prep._batch["relax_verdict"] = {"won": False}
        outcome("lost")
        return state, takes_bc, unplaced_bc, extra

    # ------------------------------------------------------------------

    def _sorted_classes(self, pods: List[Pod], topo: Topology) -> List[PodClass]:
        # labels/pod-affinity join the class key only when a topology group
        # could observe them (see _spec_signature)
        label_aware = bool(topo.topologies or topo.inverse_topologies)
        classes = group_pods(pods, label_aware=label_aware)
        # class order = pod queue order lifted to classes (queue.go:76-112)
        classes.sort(
            key=lambda c: (
                -c.requests.get("cpu", 0.0),
                -c.requests.get("memory", 0.0),
                min(p.metadata.creation_timestamp for p in c.pods),
            )
        )
        if label_aware:
            # Host-floor-first ordering — a deliberate, measured improvement
            # over the reference's pure size order (queue.go:76-112).
            # Hostname-keyed anti-affinity/spread classes need DISTINCT
            # hosts (min floats at zero while fresh nodes are creatable,
            # topologygroup.go:235-238): the slot floor they force is
            # max(per-group demand), independent of WHEN they run — but run
            # mid-scan (size order), early such classes find few existing
            # slots and open fresh ones the oracle's pod-interleaved walk
            # avoids. Running them FIRST establishes the host floor with
            # the minimum slot count, and the capacity-driven classes then
            # fill those slots instead of opening their own: the diverse
            # 5k topology mix drops 127 -> 91 nodes (greedy oracle: 121),
            # the 50k mix 314 -> 235 (greedy: 315). Stable within ranks,
            # so size order is preserved among peers.
            # Promote ONLY classes whose owned groups are exclusively
            # hostname anti-affinity/spread: a promoted class must not
            # depend on other classes' placements. A class that also owns a
            # pod-AFFINITY group (or any label-keyed group) placed ahead of
            # its target would find zero count>0 domains and fail pods the
            # size order places.
            def rank(cls: PodClass) -> int:
                owned = topo._owned.get(cls.pods[0].uid, ())
                if not owned:
                    return 2
                best = 2
                for g in owned:
                    if g.key != apilabels.LABEL_HOSTNAME:
                        return 2
                    if g.type == TYPE_ANTI_AFFINITY:
                        best = min(best, 0)
                    elif g.type == TYPE_SPREAD:
                        best = min(best, 1)
                    else:  # hostname-keyed affinity still depends on targets
                        return 2
                return best

            classes.sort(key=rank)
        # O(classes) gangsched gate, stashed so the per-solve result
        # post-processing (_solve_gen) doesn't re-derive it with an O(pods)
        # annotation rescan
        self._gangsched_engaged = any(
            c.tier != 0 or c.gang is not None for c in classes
        )
        if self._gangsched_engaged:
            # priority tier is the PRIMARY order — the scan claims capacity
            # in class order, so tier-descending is what makes "a lower
            # tier can never starve a higher one" true by construction.
            # Within a tier, gang members pull adjacent (anchored at the
            # gang's first member). The sort is stable, so plain problems
            # never enter this branch and keep their order.
            classes = gangmod.gang_adjacent_order(
                classes,
                lambda c: c.tier,
                lambda c: None if c.gang is None else c.gang[0],
            )
        return classes

    def _prepare(
        self, pods: List[Pod], max_slots: int, topo: Topology
    ) -> _Prepared:
        """Topology-free prepare entry, outside a solve round (the
        consolidation sweep's, ROADMAP A.6; callers guarantee no
        topology-coupled pods). It builds no existing-node sims: only a
        solve round's fetch and decode read them."""
        # direct prepares are not relaxation rounds: don't union a previous
        # solve()'s vocab into this closed world
        self._round_frozen = None
        # nor part of a solve: the spans below take the caller's request
        self._request = None
        plan = topoplan.plan_topology(self._sorted_classes(pods, topo), topo)
        return self._prepare_with_vocab(plan, max_slots, topo)

    # -- prepared-state construction (cached; see __init__) ---------------

    def _vocab_universe(self):
        """Scheduler-lifetime label universe: (base key->values from
        templates + existing-node labels + offerings, IT-requirement
        key->values kept separate — catalog instance types contribute
        VALUES only for keys some other entity mentions; see the
        closed-world argument in solver/vocab.py and the exactness note on
        the original inline build)."""
        if self._universe is None:
            base: Dict[str, set] = {}

            def obs(reqs):
                # pure set-union accumulation;
                # the interning below (_build_vocab) sorts before minting ids
                for key, req in reqs.items():
                    base.setdefault(key, set()).update(req.values)

            for t in self.templates:
                obs(t.requirements)
            # a node's label is `In {value}` under its normalized key
            # (Requirements.from_labels), read straight from the labels
            norm = apilabels.NORMALIZED_LABELS
            pairs, _, alone = self._node_labels()
            for key, value in set(pairs):
                base.setdefault(norm.get(key, key), set()).add(value)
            for i in alone:
                obs(Requirements.from_labels(self.existing_nodes[i].labels))
            for it in self._catalog_union():
                for off in it.offerings:
                    obs(off.requirements)
            it_vals: Dict[str, set] = {}
            for it in self._catalog_union():
                # pure set-union accumulation;
                # _build_vocab sorts before minting ids
                for key, req in it.requirements.items():
                    it_vals.setdefault(key, set()).update(req.values)
            self._universe = (base, it_vals)
        return self._universe

    def _build_vocab(self, classes: List[PodClass], plan: topoplan.TopoPlan):
        """Canonical closed-world vocab for one solve round.

        Keys and values intern in SORTED order, so two rounds with the
        same label universe produce identical id assignments — the
        fingerprint equality the prepared-state caches key on. Relaxation
        rounds union the previous round's vocab (_round_frozen): a relax
        only strips preferred terms, so the union IS the round-1 vocab and
        every cached tensor survives the re-solve."""
        from karpenter_core_tpu_torch.solver.vocab import Vocab

        base, it_vals = self._vocab_universe()
        # all three loops below are pure
        # set-union accumulation into `merged`; the interning loop at the
        # bottom sorts keys AND values before minting any id, so iteration
        # order here cannot reach the fingerprint
        merged = {k: set(v) for k, v in base.items()}
        for cls in classes:
            for key, req in cls.requirements.items():  # set union, id-free
                merged.setdefault(key, set()).update(req.values)
        # catalog ITs contribute values only for keys mentioned by a
        # non-catalog entity (class/template/node/offering)
        mentioned = set(merged)
        for key, vals in it_vals.items():  # set union, id-free
            tgt = merged.setdefault(key, set())
            if key in mentioned:
                tgt.update(vals)
        # topology-domain universe joins the closed world (the kernel's
        # admissibility masks index the label-group keys' value rows)
        for dg in plan.label_groups:
            merged.setdefault(dg.key, set()).update(dg.group.domains)
        if self._round_frozen is not None:
            for key, names in zip(
                self._round_frozen.key_names, self._round_frozen.value_names
            ):
                merged.setdefault(key, set()).update(names)
        v = Vocab()
        for key in sorted(merged):
            v.key_id(key)
            for val in sorted(merged[key]):
                v.value_id(key, val)
        return v.finalize()

    def _resource_axis(self, classes: List[PodClass]) -> List[str]:
        """Resource axis: the 4 well-known names, then the catalog/daemon
        extras, then any class-only extras — each block sorted so the axis
        (and with it the fingerprint) is stable under drifting pod mixes.
        Daemon overhead joins every fresh claim's requests, so its resource
        names must be on the axis or the vectorized fit check would
        silently drop them."""
        if self._base_resources is None:
            names = dict.fromkeys(["cpu", "memory", "pods", "ephemeral-storage"])
            extra = set()
            for it in self._catalog_union():
                extra.update(it.allocatable())
            for o in self.daemon_overhead:
                extra.update(o)
            for n in sorted(extra):
                if n not in names:
                    names[n] = None
            self._base_resources = list(names)
        names = dict.fromkeys(self._base_resources)
        extra = set()
        for c in classes:
            extra.update(c.requests)
        for n in sorted(extra):
            if n not in names:
                names[n] = None
        return list(names)

    def _stat_inc(self, key: str) -> None:
        st = self.last_phase_stats
        if key in st:
            st[key] += 1

    def _fp_entry(self, frozen, resource_names: List[str],
                  span: Optional[tracing.Span] = None) -> Tuple[dict, int]:
        """Catalog/template/existing-node tensors for one closed world,
        cached per (vocab fingerprint, resource axis, existing-node set).
        Nothing here depends on the pod mix: steady-state solves and every
        relaxation round reuse both the host planes and the
        device-resident copies (zero re-encode, zero re-transfer). A build
        counts its existing-node rows on ``span``: ``rows_bulk`` from the
        bulk label pass, ``rows_per_node`` encoded one node at a time."""
        fp = (
            frozen.fingerprint(),
            tuple(resource_names),
            tuple(n.name for n in self.existing_nodes),
            tuple(id(n) for n in self.existing_nodes),
        )
        if len(self._fp_ids) > 64:  # interner bound (fp tuples are large)
            self._fp_ids.clear()
            self._fp_cache.clear()
            self._row_cache.clear()
            self._batch_cache.clear()
        fpid = self._fp_ids.setdefault(fp, len(self._fp_ids))
        e = self._fp_cache.get(fpid)
        if e is not None:
            return e, fpid

        catalog = self._catalog_union()
        T, S, E = len(catalog), len(self.templates), len(self.existing_nodes)
        # T == 0 (existing-capacity-only solve) keeps a dummy never-viable
        # IT axis so reductions over T stay well-formed; same for the
        # template axis S (gathers on a zero-size axis are invalid)
        pad_T, pad_S = max(T, 1), max(S, 1)
        K, V = frozen.K, frozen.V
        R = len(resource_names)

        well_known = np.array(
            [k in apilabels.WELL_KNOWN_LABELS for k in frozen.key_names],
            dtype=bool,
        )

        # Integer-unit quantization: the device planes hold integer-valued
        # float32 (milli-units for cpu and counts, Mi for memory-like
        # resources), so every in-kernel sum/difference/division is EXACT
        # below 2^24 and exact-boundary fits are neither rejected (the old
        # K_MARGIN shaved floor((alloc-req)/r) by one at exact fits,
        # opening a fresh node where the greedy oracle's float64 math packs
        # the last pod) nor spuriously accepted. Requests round UP,
        # capacity rounds DOWN — the device stays conservative at sub-unit
        # granularity and the float64 decode refit repairs any residual
        # optimism. cpu is the only fractional k8s resource
        # (milli-granular); memory and hugepages quantize to Mi (exact up
        # to 2^24 Mi = 16 TiB per slot sum), ephemeral-storage to Gi
        # (NVMe-dense nodes reach tens of TB; Gi keeps them far under
        # 2^24); everything else (pods, integral extended resources) keeps
        # unit granularity so the 24-bit exact-integer headroom isn't
        # burned on a pointless inflation.
        _MI, _GI = 2.0**20, 2.0**30
        quant = np.array(
            [
                _GI
                if n == "ephemeral-storage"
                else _MI
                if n == "memory" or n.startswith("hugepages-")
                else 1e-3
                if n == "cpu"
                else 1.0
                for n in resource_names
            ],
            dtype=np.float64,
        )
        # the exactness invariant the margin-free kernel floor rests on:
        # quantized values must stay integer-representable in float32.
        # Clamping is the enforcement — capacity clamps low (conservative),
        # and a clamped request exceeds every real node anyway; the float64
        # decode refit repairs either direction.
        _QMAX = float(2**24 - 1)

        def _qraw(rl: dict) -> np.ndarray:
            raw = np.array(
                [rl.get(n, 0.0) for n in resource_names], dtype=np.float64
            )
            return raw / quant

        # the two roundings, elementwise over rows or [E, R] matrices alike
        def _qceil(x: np.ndarray) -> np.ndarray:
            return np.ceil(x * (1.0 - 1e-12) - 1e-9)

        def _qfloor(x: np.ndarray) -> np.ndarray:
            return np.floor(x * (1.0 + 1e-12) + 1e-9)

        def rvec(rl: dict) -> np.ndarray:
            """Requests-side quantization (ceil)."""
            return np.minimum(_qceil(_qraw(rl)), _QMAX).astype(np.float32)

        def rvec_cap(rl: dict) -> np.ndarray:
            """Capacity-side quantization (floor)."""
            return np.minimum(_qfloor(_qraw(rl)), _QMAX).astype(np.float32)

        def rvec64q(rl: dict) -> np.ndarray:
            """Requests-side quantization, float64 (ceil, unclamped)."""
            return _qceil(_qraw(rl))

        def rvec64q_cap(rl: dict) -> np.ndarray:
            """Capacity-side quantization, float64 (floor, unclamped)."""
            return _qfloor(_qraw(rl))

        from karpenter_core_tpu_torch.solver.vocab import encode_requirements_batch

        it_masks = encode_requirements_batch(
            frozen, [it.requirements for it in catalog]
        )
        tmpl_masks = _neutralize(
            encode_requirements_batch(
                frozen, [t.requirements for t in self.templates]
            )
        )
        if S == 0:  # dummy neutral template row (never selected)
            tmpl_masks = EntityMasks(
                mask=np.ones((pad_S, K, V), dtype=bool),
                defines=np.zeros((pad_S, K), dtype=bool),
                concrete=np.zeros((pad_S, K), dtype=bool),
                negative=np.ones((pad_S, K), dtype=bool),
                gt=np.full((pad_S, K), GT_NONE, dtype=np.int32),
                lt=np.full((pad_S, K), LT_NONE, dtype=np.int32),
            )

        it_alloc = np.zeros((pad_T, R), dtype=np.float32)
        it_alloc64q = np.zeros((pad_T, R), dtype=np.float64)
        for ti, it in enumerate(catalog):
            it_alloc[ti] = rvec_cap(it.allocatable())
            it_alloc64q[ti] = rvec64q_cap(it.allocatable())

        # offerings tensor [T, Z, CT] over the zone/ct vocab rows
        zone_kid = frozen.keys.get(apilabels.LABEL_TOPOLOGY_ZONE, 0)
        ct_kid = frozen.keys.get(apilabels.CAPACITY_TYPE_LABEL_KEY, 0)
        Z = max(len(frozen.value_names[zone_kid]), 1)
        CT = max(len(frozen.value_names[ct_kid]), 1)
        off_avail = np.zeros((pad_T, Z, CT), dtype=bool)
        # relax price planes (ops/relax.py): per-IT min AVAILABLE offering
        # price (the relaxation's $/pod numerator), ICE'd rows excluded
        # exactly like the availability mask
        _PRICE_NONE = np.float32(relax_ops.BIG_PRICE)
        it_price = np.full((pad_T,), _PRICE_NONE, dtype=np.float32)
        for ti, it in enumerate(catalog):
            for off in it.offerings:
                if not off.available:
                    continue
                # the unavailable-offerings tensor mask: ICE'd rows never
                # enter fresh-node viability (apply_unavailable already
                # flipped copies' available flags; this guards catalogs
                # handed in pre-built, e.g. over the sidecar wire)
                if off.key(it.name) in self.unavailable_offerings:
                    continue
                it_price[ti] = min(it_price[ti], np.float32(off.price))
                z = frozen.values[zone_kid].get(off.zone)
                c_ = frozen.values[ct_kid].get(off.capacity_type)
                if z is not None and c_ is not None:
                    off_avail[ti, z, c_] = True

        # template-IT viability from the host prefilter (exact reference
        # path)
        it_index = {id(it): i for i, it in enumerate(catalog)}
        tmpl_it = np.zeros((pad_S, pad_T), dtype=bool)
        for si, t in enumerate(self.templates):
            for it in t.instance_type_options:
                tmpl_it[si, it_index[id(it)]] = True
        # per-template min node price (the scored fallback's $-cost proxy):
        # the cheapest priced IT the template could open
        tmpl_price = np.full((pad_S,), _PRICE_NONE, dtype=np.float32)
        for si in range(S):
            viable = tmpl_it[si]
            if viable.any():
                tmpl_price[si] = float(
                    np.min(np.where(viable, it_price, _PRICE_NONE))
                )
        tmpl_overhead = np.stack(
            [rvec(o) for o in self.daemon_overhead]
        ) if S else np.zeros((pad_S, R), dtype=np.float32)
        tmpl_overhead64q = np.stack(
            [rvec64q(o) for o in self.daemon_overhead]
        ) if S else np.zeros((pad_S, R), dtype=np.float64)

        # existing-node init rows (seeded into slot rows [0, E) each round),
        # all nodes at once: the requirement planes from the labels, and
        # one [E, R] matrix each side quantized as rvec / rvec_cap do
        ex_planes, rows_per_node = self._node_label_planes(frozen)
        req64, cap64 = self._node_resource_rows(resource_names)
        ex_requests = np.minimum(_qceil(req64 / quant), _QMAX).astype(
            np.float32)
        ex_capacity = np.minimum(_qfloor(cap64 / quant), _QMAX).astype(
            np.float32)
        if span is not None:
            span.count("rows_bulk", E - rows_per_node)
            span.count("rows_per_node", rows_per_node)

        # -- shape bucketing (the JAX package's padded shapes) -------------
        # Padded entities are inert by construction: keys/values pad to the
        # neutral invariant (all-True slot valmask, False class/template
        # masks under defines=False), instance types/templates pad
        # never-viable, topology groups pad owner/sel=False, resources pad
        # zero-request. The kernel runs at padded shapes; _solve_once
        # slices outputs back to natural sizes before decode.
        Kp = _bucket(K)
        Vp = _bucket(V)
        Tp = _bucket(pad_T)
        Sp = _bucket(pad_S, lo=2)
        Rp = _bucket(R, lo=4)

        def pad_masks(mask, defines_, concrete_like_complement, negative_,
                      gt_, lt_):
            """Pad one entity-mask family: V/K axes of the value mask pad
            False then re-neutralize where defines is False."""
            m2 = _pad(mask, {mask.ndim - 2: Kp, mask.ndim - 1: Vp}, False)
            d2 = _pad(defines_, {defines_.ndim - 1: Kp}, False)
            m2 = np.where(d2[..., None], m2, True)
            c2 = _pad(concrete_like_complement,
                      {concrete_like_complement.ndim - 1: Kp}, True)
            n2 = _pad(negative_, {negative_.ndim - 1: Kp}, True)
            g2 = _pad(gt_, {gt_.ndim - 1: Kp}, GT_NONE)
            l2 = _pad(lt_, {lt_.ndim - 1: Kp}, LT_NONE)
            return m2, d2, c2, n2, g2, l2

        tm_mask, tm_def, tm_comp, tm_neg, tm_gt, tm_lt = pad_masks(
            tmpl_masks.mask,
            tmpl_masks.defines,
            np.where(tmpl_masks.defines, ~tmpl_masks.concrete, True),
            np.where(tmpl_masks.defines, tmpl_masks.negative, True),
            tmpl_masks.gt,
            tmpl_masks.lt,
        )

        e = dict(
            fp=fp,
            resource_names=list(resource_names),
            quant=quant,
            rvec=rvec, rvec_cap=rvec_cap,
            rvec64q=rvec64q, rvec64q_cap=rvec64q_cap,
            it_masks=it_masks,
            tmpl_masks=tmpl_masks,
            tmpl_mask_np=tmpl_masks.mask,
            it_alloc=it_alloc, it_alloc64q=it_alloc64q,
            off_avail=off_avail, tmpl_it=tmpl_it,
            tmpl_overhead=tmpl_overhead, tmpl_overhead64q=tmpl_overhead64q,
            tmpl_zone_mask=tmpl_masks.mask[:, zone_kid, :Z],
            tmpl_ct_mask=tmpl_masks.mask[:, ct_kid, :CT],
            zone_kid=zone_kid, ct_kid=ct_kid, Z=Z, CT=CT,
            K=K, V=V, R=R, T=T, S=S, E=E, pad_T=pad_T, pad_S=pad_S,
            Kp=Kp, Vp=Vp, Tp=Tp, Sp=Sp, Rp=Rp,
            well_known=well_known,
            **ex_planes,
            ex_requests=ex_requests, ex_capacity=ex_capacity,
            it_price=it_price,
            tmpl_price=tmpl_price,
            # device-resident copies (reused across solves via this cache)
            it_alloc_d=self._dev(_pad(it_alloc, {0: Tp, 1: Rp}, 0.0)),
            it_price_d=self._dev(
                _pad(it_price, {0: Tp}, float(_PRICE_NONE))
            ),
            tmpl_price_d=self._dev(
                _pad(tmpl_price, {0: Sp}, float(_PRICE_NONE))
            ),
            off_avail_d=self._dev(_pad(off_avail, {0: Tp}, False)),
            zone_key_d=self._scalar(zone_kid),
            ct_key_d=self._scalar(ct_kid),
            tm_mask_d=self._dev(_pad(tm_mask, {0: Sp}, True)),
            tm_def_d=self._dev(_pad(tm_def, {0: Sp}, False)),
            tm_comp_d=self._dev(_pad(tm_comp, {0: Sp}, True)),
            tm_neg_d=self._dev(_pad(tm_neg, {0: Sp}, True)),
            tm_gt_d=self._dev(_pad(tm_gt, {0: Sp}, GT_NONE)),
            tm_lt_d=self._dev(_pad(tm_lt, {0: Sp}, LT_NONE)),
            tmpl_it_d=self._dev(_pad(tmpl_it, {0: Sp, 1: Tp}, False)),
            tmpl_overhead_d=self._dev(
                _pad(tmpl_overhead, {0: Sp, 1: Rp}, 0.0)
            ),
            well_known_pad_d=self._dev(_pad(well_known, {0: Kp}, False)),
            well_known_d=self._dev(well_known),
            # natural-shape entity planes for the compat kernels
            im_planes_d=tuple(
                self._dev(np.asarray(x))
                for x in (
                    it_masks.mask, it_masks.defines, it_masks.concrete,
                    it_masks.negative, it_masks.gt, it_masks.lt,
                )
            ) if T else None,
            tm_planes_d=tuple(
                self._dev(np.asarray(x))
                for x in (
                    tmpl_masks.mask, tmpl_masks.defines, tmpl_masks.concrete,
                    tmpl_masks.negative, tmpl_masks.gt, tmpl_masks.lt,
                )
            ),
        )
        if len(self._fp_cache) >= self._FP_CACHE_CAP:
            old = next(iter(self._fp_cache))
            del self._fp_cache[old]
            # cache eviction rebuilds; dict->
            # dict filters preserve insertion order and mint no ids
            self._row_cache = {
                k: v for k, v in self._row_cache.items() if k[0] != old
            }
            # order-preserving filter, no ids
            self._batch_cache = {
                k: v for k, v in self._batch_cache.items() if k[0] != old
            }
        self._fp_cache[fpid] = e
        return e, fpid

    def _node_labels(self) -> Tuple[list, List[int], List[int]]:
        """The existing nodes' labels as one flat list of (key, value)
        pairs, node after node, with each node's count of pairs. A node
        holding a key beside its deprecated alias (``_label_alias``) adds
        no pairs; the third list holds those nodes' indices."""
        dicts = [n.labels for n in self.existing_nodes]
        alone = []
        if not apilabels.NORMALIZED_LABELS.keys().isdisjoint(
                itertools.chain.from_iterable(dicts)):
            alone = [i for i, d in enumerate(dicts) if _label_alias(d)]
            for i in alone:
                dicts[i] = {}
        pairs = list(itertools.chain.from_iterable(map(dict.items, dicts)))
        return pairs, list(map(len, dicts)), alone

    def _node_label_planes(self, frozen) -> Tuple[dict, int]:
        """The existing nodes' requirement planes (``ex_valmask``,
        ``ex_defines``, ``ex_complement``, ``ex_negative``, ``ex_gt``,
        ``ex_lt``), as ``_neutralize(encode_requirements_batch(...))`` of
        ``Requirements.from_labels`` gives them, built for all nodes at
        once. A label is `In {value}` under its normalized key, so a node
        defines exactly its labels' keys, concretely, not negatively and
        with no Gt/Lt bound, and its value row holds the value's id alone:
        every label maps to its (key id, value id) through one table, and
        array writes fill the planes. A node holding a key beside its
        deprecated alias, or a value outside the vocab, is encoded alone.
        Returns the planes and the count of nodes encoded alone."""
        from karpenter_core_tpu_torch.solver.vocab import encode_requirements_batch

        nodes = self.existing_nodes
        E, K, V = len(nodes), frozen.K, frozen.V
        pairs, counts, alone = self._node_labels()
        # (label key, value) -> key id * V + value id, a key under its
        # deprecated aliases too (Requirement.new normalizes them)
        norm = apilabels.NORMALIZED_LABELS
        raw_keys: Dict[str, List[str]] = {
            k: [k] for k in frozen.key_names if k not in norm}
        for old, new in norm.items():
            if new in raw_keys:
                raw_keys[new].append(old)
        code = {}
        for kid, key in enumerate(frozen.key_names):
            for vid, value in enumerate(frozen.value_names[kid]):
                for raw in raw_keys.get(key, ()):
                    code[raw, value] = kid * V + vid
        c = np.fromiter(map(code.get, pairs, itertools.repeat(-1)),
                        dtype=np.intp, count=len(pairs))
        r = np.repeat(np.arange(E, dtype=np.intp), counts)
        missing = c < 0
        if missing.any():
            alone = sorted(set(alone) | set(r[missing].tolist()))
            keep = ~np.isin(r, alone)
            r, c = r[keep], c[keep]
        k, v = np.divmod(c, V)
        defines = np.zeros((E, K), dtype=bool)
        defines[r, k] = True
        valmask = np.ones((E, K, V), dtype=bool)
        valmask[r, k] = False
        valmask[r, k, v] = True
        planes = dict(
            ex_valmask=valmask,
            ex_defines=defines,
            ex_complement=~defines,
            ex_negative=~defines,
            ex_gt=np.full((E, K), GT_NONE, dtype=np.int32),
            ex_lt=np.full((E, K), LT_NONE, dtype=np.int32),
        )
        if alone:
            m = _neutralize(encode_requirements_batch(
                frozen, [Requirements.from_labels(nodes[i].labels)
                         for i in alone]))
            a = np.array(alone, dtype=np.intp)
            planes["ex_valmask"][a] = m.mask
            planes["ex_defines"][a] = m.defines
            planes["ex_complement"][a] = np.where(m.defines, ~m.concrete, True)
            planes["ex_negative"][a] = np.where(m.defines, m.negative, True)
            planes["ex_gt"][a] = m.gt
            planes["ex_lt"][a] = m.lt
        return planes, len(alone)

    def _node_resource_rows(
        self, resource_names: List[str]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """[E, R] float64 matrices over the resource axis: each node's daemon
        overhead less its own daemon requests, floored at zero
        (ExistingNodeSim's arithmetic), and its available resources."""
        req, cap = [], []  # flat, row after row
        for node in self.existing_nodes:
            over = self._node_daemon_overhead(node)
            own = node.daemon_requests
            req += [over[n] - own.get(n, 0.0) if n in over else 0.0
                    for n in resource_names]
            avail = node.available
            cap += [avail.get(n, 0.0) for n in resource_names]
        shape = (len(self.existing_nodes), len(resource_names))
        req64 = np.array(req, dtype=np.float64).reshape(shape)
        req64[req64 < 0] = 0.0
        return req64, np.array(cap, dtype=np.float64).reshape(shape)

    def _plan_digest(self, plan: topoplan.TopoPlan) -> bytes:
        """Content digest of the lowered topology plan — everything the
        class batch (owner/sel incidence, water-fill steps, domain ranks)
        bakes into its tensors. zcount0 is deliberately excluded: live
        domain counts feed init_state, which is rebuilt every round."""
        import hashlib

        h = hashlib.sha1()
        for a in (
            plan.h_type, plan.h_skew, plan.h_sel, plan.h_owner,
            plan.z_type, plan.z_skew, plan.z_key, plan.z_mindom,
            plan.z_sel, plan.z_owner, plan.z_domains, plan.z_rank,
        ):
            h.update(b"|")
            if a is not None:
                h.update(np.ascontiguousarray(a).tobytes())
        for s in plan.steps:
            h.update(
                (
                    f";{s.class_idx},{s.sub_value},{int(s.sub_first)},"
                    f"{int(s.sub_last)},{s.wf_group},{s.wf_key}"
                ).encode()
            )
            if s.zone_rest is not None:
                h.update(np.ascontiguousarray(s.zone_rest).tobytes())
        return h.digest()

    def _class_batch(
        self,
        fpid: int,
        frozen,
        entry: dict,
        plan: topoplan.TopoPlan,
        classes: List[PodClass],
        N: int,
    ) -> dict:
        """Stacked per-class tensors + the device compat/viability results.

        Cached on (fingerprint, slot count, plan digest, ordered class
        signature+count tuple): a steady-state re-solve — including every
        sidecar RPC with an unchanged cluster — returns the whole batch
        (and its device-resident ClassStep, attached by _class_steps)
        without touching numpy. Relaxation rounds miss here but hit the
        per-class row cache for every class the relax did NOT mutate."""
        digest = self._plan_digest(plan)
        sig_tuple = tuple((cls.signature, cls.count) for cls in classes)
        key = (fpid, N, digest, sig_tuple)
        from karpenter_core_tpu_torch.metrics import wiring as m

        b = self._batch_cache.get(key)
        if b is not None:
            self._stat_inc("prep_cache_hits")
            m.SOLVER_PREP_CACHE.inc({"outcome": "hit"})
            return b
        self._stat_inc("prep_cache_misses")
        m.SOLVER_PREP_CACHE.inc({"outcome": "miss"})

        from karpenter_core_tpu_torch.scheduling.requirements import (
            has_preferred_node_affinity,
        )
        from karpenter_core_tpu_torch.solver.vocab import encode_requirements_batch

        C = len(classes)
        K, V, R = entry["K"], entry["V"], entry["R"]
        T, S, E = entry["T"], entry["S"], entry["E"]
        Kp, Vp, Tp, Sp, Rp = (
            entry["Kp"], entry["Vp"], entry["Tp"], entry["Sp"], entry["Rp"]
        )
        Z, CT = entry["Z"], entry["CT"]
        zone_kid, ct_kid = entry["zone_kid"], entry["ct_kid"]

        rows: List[Optional[dict]] = []
        miss: List[int] = []
        for i, cls in enumerate(classes):
            r = self._row_cache.get((fpid, cls.signature))
            rows.append(r)
            if r is None:
                miss.append(i)
        if miss:
            enc = encode_requirements_batch(
                frozen, [classes[i].requirements for i in miss]
            )
            # strict (pod_domains) masks — what topology admissibility
            # consults (topology.go:166-188 passes strict reqs when
            # preferences exist)
            strict_enc = encode_requirements_batch(
                frozen,
                [
                    classes[i].strict_requirements
                    if classes[i].pods
                    and has_preferred_node_affinity(classes[i].pods[0])
                    else classes[i].requirements
                    for i in miss
                ],
            )
            for j, i in enumerate(miss):
                cls = classes[i]
                req = resutil.requests_for_pods(cls.pods[0])
                row = dict(
                    mask=enc.mask[j],
                    defines=enc.defines[j],
                    concrete=enc.concrete[j],
                    negative=enc.negative[j],
                    gt=enc.gt[j],
                    lt=enc.lt[j],
                    smask=np.where(
                        strict_enc.defines[j][:, None], strict_enc.mask[j],
                        True,
                    ),
                    req=entry["rvec"](req),
                    req64=entry["rvec64q"](req),
                    taint_ok=np.array(
                        [
                            _tolerates_taints(cls.tolerations, t.taints)
                            for t in self.templates
                        ],
                        dtype=bool,
                    ),
                    exist_taint_ok=np.array(
                        [
                            _tolerates_taints(cls.tolerations, n.taints)
                            for n in self.existing_nodes
                        ],
                        dtype=bool,
                    ),
                )
                self._row_cache[(fpid, cls.signature)] = row
                rows[i] = row
            if len(self._row_cache) > self._ROW_CACHE_CAP:
                self._row_cache.clear()

        if C:
            class_masks = _neutralize(
                EntityMasks(
                    mask=np.stack([r["mask"] for r in rows]),
                    defines=np.stack([r["defines"] for r in rows]),
                    concrete=np.stack([r["concrete"] for r in rows]),
                    negative=np.stack([r["negative"] for r in rows]),
                    gt=np.stack([r["gt"] for r in rows]),
                    lt=np.stack([r["lt"] for r in rows]),
                )
            )
            smask = np.stack([r["smask"] for r in rows])
            class_requests = np.stack([r["req"] for r in rows])
            class_requests64q = np.stack([r["req64"] for r in rows])
        else:
            class_masks = EntityMasks(
                mask=np.ones((0, K, V), dtype=bool),
                defines=np.zeros((0, K), dtype=bool),
                concrete=np.zeros((0, K), dtype=bool),
                negative=np.ones((0, K), dtype=bool),
                gt=np.full((0, K), GT_NONE, dtype=np.int32),
                lt=np.full((0, K), LT_NONE, dtype=np.int32),
            )
            smask = np.ones((0, K, V), dtype=bool)
            class_requests = np.zeros((0, R), dtype=np.float32)
            class_requests64q = np.zeros((0, R), dtype=np.float64)

        taint_ok = (
            np.stack([r["taint_ok"] for r in rows])
            if C and S
            else np.zeros((C, entry["pad_S"]), dtype=bool)
        )
        exist_taint_ok = np.ones((C, N), dtype=bool)
        if C and E:
            exist_taint_ok[:, :E] = np.stack(
                [r["exist_taint_ok"] for r in rows]
            )

        Cp = _bucket(C)

        def cpad(a, fill):
            return _pad(a, {0: Cp}, fill)

        cm = class_masks
        # Fresh-node viability + kstar per class, ON DEVICE (ops/masks
        # fresh_viability) over the BUCKETED arrays: the compat results
        # never detour through the host, and the solve's only device sync
        # is the post-scan output fetch.
        # Dead-on equal to the retired host loop: same quantized float32
        # floor arithmetic, first-template-wins (pad rows carry tmpl_ok
        # False and can never be chosen).
        if C and S and T:
            cmask_p = np.where(
                cpad(cm.defines, False)[:, :, None], cpad(cm.mask, False),
                True,
            )
            class_args = (
                self._dev(cmask_p),
                self._dev(cpad(cm.defines, False)),
                self._dev(cpad(cm.concrete, False)),
                self._dev(cpad(cm.negative, True)),
                self._dev(cpad(cm.gt, GT_NONE)),
                self._dev(cpad(cm.lt, LT_NONE)),
            )
            class_it_dev = mops.intersects(*class_args, *entry["im_planes_d"])
            tmpl_compat_dev = mops.compatible(
                *class_args, *entry["tm_planes_d"], entry["well_known_d"]
            )
            class_it_b = _pad_cols(class_it_dev, Tp)
            tmpl_ok_b = self._dev(
                _pad(taint_ok, {0: Cp, 1: Sp}, False)
            ) & _pad_cols(tmpl_compat_dev, Sp)
            # same-node-template gang co-location: AND-reduce template
            # viability within each such gang BEFORE fresh_viability's
            # first-template-wins choice, so every member resolves to the
            # same template; plain problems skip it
            tmpl_gang_id, n_tmpl_gangs = _same_template_gang_ids(classes, Cp)
            gang_id_d = None
            if n_tmpl_gangs:
                gang_id_d = self._dev(tmpl_gang_id)
                tmpl_ok_b = mops.gang_joint_templates(
                    tmpl_ok_b, gang_id_d, num_gangs=n_tmpl_gangs,
                )
            cz = self._dev(cpad(cm.mask[:, zone_kid, :Z], False))
            cct = self._dev(cpad(cm.mask[:, ct_kid, :CT], False))
            tz = self._dev(_pad(entry["tmpl_zone_mask"], {0: Sp}, False))
            tct = self._dev(_pad(entry["tmpl_ct_mask"], {0: Sp}, False))
            creq = self._dev(cpad(_pad(class_requests, {1: Rp}, 0.0), 0.0))
            new_template, kstar = mops.fresh_viability(
                class_it_b,
                tmpl_ok_b,
                entry["tmpl_it_d"],
                cz, cct, tz, tct,
                entry["off_avail_d"],
                entry["it_alloc_d"],
                entry["tmpl_overhead_d"],
                creq,
            )
            relax_planes = None
            if self.solver_mode == "relax":
                # relax constraint planes (ops/relax.py), cached on the
                # class batch beside the FFD viability results — warm
                # re-solves rebuild nothing. Same-template gangs AND-reduce
                # the relax support like the FFD mask, so the consensus
                # rows iterate over identical feasible sets.
                # Hostname-keyed topology (spread maxSkew / anti-affinity)
                # lowers to a per-class pods-per-host cap, so host-floor
                # classes never estimate dense nodes they cannot fill.
                kcap = np.full((C,), BIGI, dtype=np.int32)
                for gi in range(plan.Gh):
                    ht = int(plan.h_type[gi])
                    if ht == 2:  # affinity: no per-host count cap
                        continue
                    cap = 1 if ht == 1 else max(int(plan.h_skew[gi]), 1)
                    owned = plan.h_owner[:, gi]
                    kcap[owned] = np.minimum(kcap[owned], cap)
                viable_r, k_cs_r, k_node_r, podcost_r = (
                    relax_ops.relax_viability(
                        class_it_b, tmpl_ok_b, entry["tmpl_it_d"],
                        cz, cct, tz, tct,
                        entry["off_avail_d"], entry["it_alloc_d"],
                        entry["tmpl_overhead_d"], creq,
                        entry["it_price_d"],
                        self._dev(cpad(kcap, BIGI)),
                    )
                )
                if n_tmpl_gangs:
                    viable_r = mops.gang_joint_templates(
                        viable_r, gang_id_d, num_gangs=n_tmpl_gangs,
                    )
                relax_planes = dict(
                    viable=viable_r,
                    k_cs=k_cs_r,
                    k_node=k_node_r,
                    podcost=podcost_r,
                    counts=self._dev(
                        cpad(
                            np.array(
                                [c.count for c in classes],
                                dtype=np.float32,
                            ),
                            0.0,
                        )
                    ),
                    gang_id=self._dev(tmpl_gang_id),
                    n_gangs=n_tmpl_gangs,
                )
            class_it = class_it_b  # [Cp, Tp] device-resident
            tmpl_ok = tmpl_ok_b  # [Cp, Sp] device-resident
        else:
            dev = self.device
            class_it = torch.zeros((Cp, Tp), dtype=torch.bool, device=dev)
            tmpl_ok = torch.zeros((Cp, Sp), dtype=torch.bool, device=dev)
            new_template = torch.full((Cp,), -1, dtype=torch.int32, device=dev)
            kstar = torch.zeros((Cp,), dtype=torch.int32, device=dev)
            relax_planes = None

        b = dict(
            relax=relax_planes,
            class_masks=class_masks,
            smask=smask,
            class_requests=class_requests,
            class_requests64q=class_requests64q,
            taint_ok=taint_ok,
            exist_taint_ok=exist_taint_ok,
            class_it=class_it,
            tmpl_ok=tmpl_ok,
            new_template=new_template,
            kstar=kstar,
            Cp=Cp,
            class_steps=None,
            step_class=None,
        )
        if len(self._batch_cache) >= self._BATCH_CACHE_CAP:
            del self._batch_cache[next(iter(self._batch_cache))]
        self._batch_cache[key] = b
        return b

    def _make_init_state(
        self,
        entry: dict,
        plan: topoplan.TopoPlan,
        N: int,
        hcount0: np.ndarray,
        Ghp: int,
        Gzp: int,
    ) -> SlotState:
        """Fresh device SlotState with existing nodes seeded in rows
        [0, E), rebuilt every round from the fp entry's cached host rows."""
        K, V, R = entry["K"], entry["V"], entry["R"]
        E = entry["E"]
        Kp, Vp, Tp, Rp = entry["Kp"], entry["Vp"], entry["Tp"], entry["Rp"]

        valmask = np.ones((N, K, V), dtype=bool)
        defines = np.zeros((N, K), dtype=bool)
        complement = np.ones((N, K), dtype=bool)
        negative = np.ones((N, K), dtype=bool)
        gt = np.full((N, K), GT_NONE, dtype=np.int32)
        lt = np.full((N, K), LT_NONE, dtype=np.int32)
        requests = np.zeros((N, R), dtype=np.float32)
        capacity = np.full((N, R), np.float32(BIG))
        kind = np.zeros((N,), dtype=np.int8)
        template_arr = np.full((N,), -1, dtype=np.int32)
        if E:
            valmask[:E] = entry["ex_valmask"]
            defines[:E] = entry["ex_defines"]
            complement[:E] = entry["ex_complement"]
            negative[:E] = entry["ex_negative"]
            gt[:E] = entry["ex_gt"]
            lt[:E] = entry["ex_lt"]
            requests[:E] = entry["ex_requests"]
            capacity[:E] = entry["ex_capacity"]
            kind[:E] = 1

        # slot valmask pads True everywhere: defined keys re-acquire False
        # pad columns on first intersection with a (False-padded) class
        # mask; EXISTING slots' defined keys must pad False now or
        # anti-affinity rowcounts see phantom values
        valmask_p = _pad(valmask, {1: Kp, 2: Vp}, True)
        defines_p = _pad(defines, {1: Kp}, False)
        valmask_p[:, :K] = np.where(
            defines[:, :K, None],
            _pad(valmask, {2: Vp}, False)[:, :K],
            valmask_p[:, :K],
        )
        return SlotState(
            valmask=self._dev(valmask_p),
            defines=self._dev(defines_p),
            complement=self._dev(_pad(complement, {1: Kp}, True)),
            negative=self._dev(_pad(negative, {1: Kp}, True)),
            gt=self._dev(_pad(gt, {1: Kp}, GT_NONE)),
            lt=self._dev(_pad(lt, {1: Kp}, LT_NONE)),
            itmask=self._dev(np.zeros((N, Tp), dtype=bool)),
            requests=self._dev(_pad(requests, {1: Rp}, 0.0)),
            capacity=self._dev(_pad(capacity, {1: Rp}, np.float32(BIG))),
            kind=self._dev(kind),
            template=self._dev(template_arr),
            podcount=self._dev(np.zeros((N,), dtype=np.int32)),
            next_free=self._scalar(E),
            overflow=self._scalar(False, torch.bool),
            hcount=self._dev(_pad(hcount0, {1: Ghp}, 0)),
            zcount=self._dev(_pad(plan.zcount0, {0: Gzp, 1: Vp}, 0)),
            carry=self._scalar(0),
        )

    def _prepare_with_vocab(
        self, plan: topoplan.TopoPlan, max_slots, topo: Topology
    ) -> _Prepared:
        """Assemble the device problem, reusing every tensor the pod mix
        did not invalidate.

        Three cache layers (see __init__) make re-solves incremental: the
        canonical vocab fingerprint keys the catalog/template/existing-node
        tensors (_fp_entry); per-class rows key on the class signature so
        a relaxation round re-encodes only the classes the relax mutated;
        and the stacked class batch — host planes plus the device-resident
        compat/viability results and the scanned ClassStep — keys on the
        ordered signature+count tuple and the topology-plan digest, so a
        steady-state re-solve skips the numpy rebuild entirely. Only
        genuinely per-round state is rebuilt every call: the plan lowering,
        the live count seeds (hcount0/zcount0), and init_state."""
        classes = plan.device_classes
        catalog = self._catalog_union()
        E = len(self.existing_nodes)
        # the slot width pads to a multiple of the mesh, as the JAX
        # package pads its sharded slot axis (the padded slots are inert),
        # so rounds, slots and overflow rescans follow its
        N = pmesh.pad_to_devices(max_slots, self.devices)
        if E > N:
            raise _SlotOverflow()

        rid = self._request
        with tracing.span("prepare.vocab", rid):
            frozen = self._build_vocab(classes, plan)
        self._round_frozen = frozen
        topoplan.finalize_arrays(plan, frozen, topo)
        resource_names = self._resource_axis(classes)
        with tracing.span("prepare.nodes", rid) as sp:
            entry, fpid = self._fp_entry(frozen, resource_names, sp)
        with tracing.span("prepare.classes", rid):
            batch = self._class_batch(fpid, frozen, entry, plan, classes, N)

        K, V = frozen.K, frozen.V
        Ghp = _bucket(plan.Gh, lo=1)
        Gzp = _bucket(plan.Gz, lo=1)
        Vp = entry["Vp"]
        self._pad_shapes = dict(
            K=K, V=V, T=entry["pad_T"], Gh=plan.Gh, Gz=plan.Gz
        )

        # topology count state: hostname-group counts seeded per existing
        # slot; positive counts on non-slot hostnames only matter for the
        # affinity bootstrap check (h_possel0)
        slot_names = [n.name for n in self.existing_nodes]
        hcount0 = topoplan.initial_hcounts(plan, slot_names, N).T  # [N, Gh]
        slot_name_set = set(slot_names)
        h_possel0 = np.zeros((plan.Gh,), dtype=bool)
        for gi, dg in enumerate(plan.host_groups):
            # any() over domain counts is an
            # order-insensitive reduction (and short-circuits; sorting
            # would force materializing every domain)
            h_possel0[gi] = any(
                cnt > 0
                for name, cnt in dg.group.domains.items()
                if name not in slot_name_set
            )

        statics = FFDStatics(
            it_alloc=entry["it_alloc_d"],
            off_avail=entry["off_avail_d"],
            zone_key=entry["zone_key_d"],
            ct_key=entry["ct_key_d"],
            tmpl_mask=entry["tm_mask_d"],
            tmpl_defines=entry["tm_def_d"],
            tmpl_complement=entry["tm_comp_d"],
            tmpl_negative=entry["tm_neg_d"],
            tmpl_gt=entry["tm_gt_d"],
            tmpl_lt=entry["tm_lt_d"],
            tmpl_it=entry["tmpl_it_d"],
            tmpl_overhead=entry["tmpl_overhead_d"],
            well_known=entry["well_known_pad_d"],
            gt_none=self._scalar(GT_NONE),
            lt_none=self._scalar(LT_NONE),
            h_type=self._dev(_pad(plan.h_type, {0: Ghp}, 0)),
            h_skew=self._dev(_pad(plan.h_skew, {0: Ghp}, 0)),
            h_possel0=self._dev(_pad(h_possel0, {0: Ghp}, False)),
            z_type=self._dev(_pad(plan.z_type, {0: Gzp}, 0)),
            z_skew=self._dev(_pad(plan.z_skew, {0: Gzp}, 0)),
            z_key=self._dev(_pad(plan.z_key, {0: Gzp}, 0)),
            z_mindom=self._dev(
                _pad(plan.z_mindom, {0: Gzp}, topoplan.NO_MIN_DOMAINS)
            ),
            z_domains=self._dev(_pad(plan.z_domains, {0: Gzp, 1: Vp}, False)),
            z_rank=self._dev(_pad(plan.z_rank, {0: Gzp, 1: Vp}, RANK_NONE)),
        )

        with tracing.span("prepare.state", rid):
            init_state = self._make_init_state(
                entry, plan, N, hcount0, Ghp, Gzp)

        # level-search iterations: the water level is bounded by seeded
        # topology counts + pods in this solve
        import math

        count_bound = 2 * (
            sum(c.count for c in classes)
            + (int(plan.zcount0.max()) if plan.zcount0.size else 0)
            + (int(hcount0.max()) if hcount0.size else 0)
            + 2
        )
        # bucket to a multiple of 4 so drifting pod counts share jit cache
        level_iters = -(-max(math.ceil(math.log2(count_bound)), 4) // 4) * 4

        prep = _Prepared(
            vocab=frozen,
            resource_names=resource_names,
            catalog=catalog,
            class_masks=batch["class_masks"],
            class_requests=batch["class_requests"],
            classes=classes,
            templates=self.templates,
            class_it=batch["class_it"],
            tmpl_ok=batch["tmpl_ok"],
            new_template=batch["new_template"],
            kstar=batch["kstar"],
            statics=statics,
            init_state=init_state,
            exist_taint_ok=batch["exist_taint_ok"],
            existing_sims=[],
            n_slots=N,
            topo=topo,
            plan=plan,
            smask=batch["smask"],
            it_alloc64q=entry["it_alloc64q"],
            class_requests64q=batch["class_requests64q"],
            tmpl_overhead64q=entry["tmpl_overhead64q"],
            off_avail_np=entry["off_avail"],
            tmpl_it_np=entry["tmpl_it"],
            tmpl_mask_np=entry["tmpl_mask_np"],
            zone_kid=entry["zone_kid"],
            ct_kid=entry["ct_kid"],
            n_zones=entry["Z"],
            n_cts=entry["CT"],
            level_iters=level_iters,
            n_classes_padded=batch["Cp"],
            _batch=batch,
            init_args=(entry, plan, N, hcount0, Ghp, Gzp),
            tmpl_price_d=entry["tmpl_price_d"],
        )
        self._prepare_gangsched(prep, plan, entry, N)
        return prep

    def _prepare_gangsched(
        self, prep: _Prepared, plan: topoplan.TopoPlan, entry: dict, N: int
    ) -> None:
        """Attach the gang and tier structures to a prepared solve. Gated on
        the class batch carrying tiers or gangs: plain problems leave every
        field at its None/empty default and take the plain scan."""
        classes = prep.classes
        tiers = np.array([c.tier for c in classes], dtype=np.int64)
        has_tiers = bool(len(classes)) and bool((tiers != 0).any())
        has_gangs = any(c.gang is not None for c in classes)
        if not has_tiers and not has_gangs:
            return
        C = len(classes)
        tier_of_class = np.clip(tiers, -(2**31 - 1), 2**31 - 1).astype(
            np.int32
        )
        gang_of_class = np.full((C,), gangmod.GANG_FREE, dtype=np.int32)
        if has_gangs:
            # kernel-enforced gangs: fully on the device path. A gang with
            # a member in the fallback set places through the host loop,
            # where the atomicity backstop is the enforcement; its device
            # members carry GANG_FALLBACK_STRADDLING: inert for the
            # rollback (which keys on >= 0) but still a gang mark, so the
            # preemption pass never evicts to place a member the backstop
            # may strip
            fallback_names = {
                c.gang[0]
                for c in plan.fallback_classes
                if getattr(c, "gang", None) is not None
            }
            gangs = []
            for g in gangmod.collect_gangs(classes):
                if g.name in fallback_names:
                    for ci in g.class_indices:
                        gang_of_class[ci] = gangmod.GANG_FALLBACK_STRADDLING
                else:
                    gangs.append(g)
            if gangs:
                Gp = _bucket(len(gangs), lo=1)
                gmin = np.zeros((Gp,), dtype=np.int32)
                for gi, g in enumerate(gangs):
                    gmin[gi] = g.min_count
                    for ci in g.class_indices:
                        gang_of_class[ci] = gi
                prep.gangs = gangs
                prep.gang_min = self._dev(gmin)
                self._prepare_topoaware(prep, entry, gangs, gang_of_class, N)
        prep._batch["tier_of_class"] = tier_of_class
        prep._batch["gang_of_class"] = gang_of_class
        # evictable-capacity planes for the preemption pass: positive-tier
        # demand, existing nodes with evictable bound pods, and no device
        # topology state (a preempted placement bypasses the in-kernel
        # topology counters)
        if (
            bool((tiers > 0).any())
            and entry["E"]
            and not plan.has_device_topology()
        ):
            ev_cache = entry.setdefault("ev_planes", {})
            cached = ev_cache.get(N)
            if cached is None:
                cached = self._build_ev_planes(entry, N)
                ev_cache[N] = cached
            prep.ev, prep.ev_uids, prep.ev_freed = cached

    def _prepare_topoaware(
        self, prep: _Prepared, entry: dict, gangs, gang_of_class, N: int
    ) -> None:
        """Per-gang-class hop planes: anchor every kernel gang on the rack
        domain with the most demand-debited headroom
        (ops/topoplan.gang_anchors) and hand its member classes the
        anchor's [N] hop-distance row as their FFD fill-level plane
        (ClassStep.topo_rank, attached by _class_steps), plus a
        per-template hop cost row for the relax objective. Engages only
        when the catalog carries rack labels: plan_racks returns None
        otherwise and topo_rank stays None. The RackPlan caches on the fp
        entry per slot count."""
        rp_cache = entry.setdefault("rack_plans", {})
        if N not in rp_cache:
            rp_cache[N] = topoplan.plan_racks(
                [
                    dict(getattr(n, "labels", None) or {})
                    for n in self.existing_nodes
                ],
                # single-valued template requirements attribute a fresh
                # claim to a rack exactly like the verifier will
                [gangmod.claim_topo_labels(t) for t in self.templates],
                N,
            )
        rplan = rp_cache[N]
        if rplan is None:
            return
        anchors = topoplan.gang_anchors(
            rplan,
            [g.name for g in gangs],
            [g.min_count for g in gangs],
        )
        C = int(gang_of_class.shape[0])
        S = entry["S"]
        Sn = max(S, 1)
        topo_rank = np.zeros((C, N), dtype=np.int32)
        topo_cost = np.zeros((C, Sn), dtype=np.float32)
        for g in gangs:
            anchor = anchors[g.name]
            row = topoplan.hop_from_anchor(
                rplan, anchor, gangmod.MAX_HOP_DISTANCE
            )
            # template hop cost from the same anchor; a template without a
            # single-valued rack sits at the ceiling
            th = np.full((Sn,), gangmod.MAX_HOP_DISTANCE, dtype=np.float32)
            for si in range(S):
                d = int(rplan.tmpl_domain[si])
                if d >= 0:
                    th[si] = min(
                        int(rplan.hop[anchor, d]),
                        gangmod.MAX_HOP_DISTANCE,
                    )
            for ci in g.class_indices:
                topo_rank[ci] = row
                topo_cost[ci] = th
        prep._batch["topo_rank_of_class"] = topo_rank
        prep._batch["topo_cost_of_class"] = topo_cost
        prep.topo_anchors = anchors

    def _build_ev_planes(self, entry: dict, N: int):
        """ops/gangsched.EvPlanes over the existing nodes' evictable bound
        pods: per node, cost-sorted ((disruption cost, uid) ascending), pod
        axis padded to a bucketed P. Returns (EvPlanes | None, uid table,
        freed-request table) — the host tables map an evicted [N, P] mask
        back to eviction claims and their freed capacity."""
        E, Rp = entry["E"], entry["Rp"]
        rvec_cap = entry["rvec_cap"]
        per_node = [
            sorted(
                getattr(n, "evictable", ()) or (),
                key=lambda e: (e.cost, e.uid),
            )
            for n in self.existing_nodes
        ]
        maxP = max((len(v) for v in per_node), default=0)
        if maxP == 0:
            return None, [], []
        P = _bucket(maxP, lo=2)
        req = np.zeros((N, P, Rp), dtype=np.float32)
        tier = np.full((N, P), BIGI, dtype=np.int32)
        cost = np.zeros((N, P), dtype=np.float32)
        valid = np.zeros((N, P), dtype=bool)
        ev_uids: List[List[str]] = []
        ev_freed: List[list] = []
        for ei in range(E):
            uids, freed = [], []
            for j, e in enumerate(per_node[ei]):
                # freed capacity floor-quantizes (capacity side): the scan
                # must never believe an eviction frees more than the
                # float64 decode refit will credit
                vec = rvec_cap(e.requests)
                req[ei, j, : vec.shape[0]] = vec
                tier[ei, j] = e.priority
                cost[ei, j] = e.cost
                valid[ei, j] = True
                uids.append(e.uid)
                freed.append(dict(e.requests))
            ev_uids.append(uids)
            ev_freed.append(freed)
        planes = gangsched.EvPlanes(
            req=req, tier=tier, cost=cost, valid=valid
        )
        return self._dev_ev(planes), ev_uids, ev_freed

    def _dev_ev(self, planes):
        """Host->device copy of the EvPlanes with byte accounting (the
        lead device takes the whole copy)."""
        for leaf in planes:
            self._h2d_bytes += leaf.nbytes
            self._h2d_dev_bytes += leaf.nbytes
        return type(planes)(*(
            torch.tensor(np.array(x, order="C"), device=self.device)
            for x in planes
        ))

    def _class_steps(self, prep: _Prepared) -> ClassStep:
        """Per-STEP scanned arrays: one step per class, except self-selecting
        label-spread classes which expand to one pinned sub-step per
        admissible domain (ops/topoplan.py). All axes pad to the bucketed
        shapes of prep.statics/init_state; steps pad to a bucketed count
        with inert entries (count=0, no viable template — the scan carries
        state through them unchanged). The finished device-resident
        ClassStep caches on the class batch (prep._batch), so steady-state
        re-solves skip both the host assembly and the host->device
        transfer."""
        cached = prep._batch.get("class_steps")
        if cached is not None:
            prep.step_class = prep._batch["step_class"]
            prep.step_tier = prep._batch.get("step_tier_d")
            prep.step_gang = prep._batch.get("step_gang_d")
            return cached
        cm = prep.class_masks
        plan = prep.plan
        steps = plan.steps
        V = prep.vocab.V
        cis = np.array([s.class_idx for s in steps], dtype=np.int32)
        counts = np.array(
            [prep.classes[ci].count for ci in cis], dtype=np.int32
        )
        J = len(steps)
        Jp = _bucket_steps(J)
        Kp = int(prep.statics.well_known.shape[0])
        Vp = int(prep.statics.z_domains.shape[1])
        Tp = int(prep.statics.it_alloc.shape[0])
        Sp = int(prep.statics.tmpl_it.shape[0])
        Rp = int(prep.statics.it_alloc.shape[1])
        Ghp = int(prep.statics.h_type.shape[0])
        Gzp = int(prep.statics.z_type.shape[0])
        zone_rest = (
            np.stack(
                [
                    s.zone_rest
                    if s.zone_rest is not None
                    else np.zeros((V,), dtype=bool)
                    for s in steps
                ]
            )
            if J
            else np.zeros((0, V), dtype=bool)
        )

        def stepvec(values, dtype, fill):
            return _pad(np.array(values, dtype=dtype), {0: Jp}, fill)

        # device-resident per-class arrays (class_it/tmpl_ok/new_template/
        # kstar live on device, see _prepare_with_vocab): gather by padded
        # step index, pad the natural T/S axes up to the statics' bucketed
        # shapes, and neutralize the pad rows so inert steps stay inert
        ci_padded = np.zeros((Jp,), dtype=np.int32)
        ci_padded[:J] = cis
        ci_j = torch.tensor(ci_padded, dtype=torch.int64, device=self.device)
        valid_j = torch.tensor(np.arange(Jp) < J, device=self.device)
        class_it_g = _pad_cols(prep.class_it[ci_j], Tp)
        tmpl_ok_g = _pad_cols(prep.tmpl_ok[ci_j], Sp)
        minus1 = self._scalar(-1)
        zero = self._scalar(0)

        # rack-aware gangs' fill levels: [Jp, N] gang-anchor hop rows, a
        # second slot-axis scanned input beside exist_taint_ok — present
        # only when _prepare_topoaware engaged (rack labels and kernel
        # gangs); otherwise ClassStep.topo_rank stays None
        topo_np = prep._batch.get("topo_rank_of_class")
        topo_kw = (
            {}
            if topo_np is None
            else {"topo_rank": self._dev(_pad(topo_np[cis], {0: Jp}, 0))}
        )

        mask = _pad(cm.mask[cis], {0: Jp, 1: Kp, 2: Vp}, False)
        defines = _pad(cm.defines[cis], {0: Jp, 1: Kp}, False)
        mask = np.where(defines[:, :, None], mask, True)  # neutral pads
        smask = _pad(prep.smask[cis], {0: Jp, 1: Kp, 2: Vp}, True)
        step = ClassStep(
            mask=self._dev(mask),
            defines=self._dev(defines),
            concrete=self._dev(_pad(cm.concrete[cis], {0: Jp, 1: Kp}, False)),
            negative=self._dev(_pad(cm.negative[cis], {0: Jp, 1: Kp}, True)),
            gt=self._dev(_pad(cm.gt[cis], {0: Jp, 1: Kp}, GT_NONE)),
            lt=self._dev(_pad(cm.lt[cis], {0: Jp, 1: Kp}, LT_NONE)),
            count=self._dev(_pad(counts, {0: Jp}, 0)),
            requests=self._dev(
                _pad(prep.class_requests[cis], {0: Jp, 1: Rp}, 0.0)
            ),
            class_it=class_it_g & valid_j[:, None],
            tmpl_ok=tmpl_ok_g & valid_j[:, None],
            # [Jp, N]: the one scanned input with a slot axis
            exist_taint_ok=self._dev(
                _pad(prep.exist_taint_ok[cis], {0: Jp}, False)
            ),
            new_template=torch.where(valid_j, prep.new_template[ci_j], minus1),
            kstar=torch.where(valid_j, prep.kstar[ci_j], zero),
            smask=self._dev(smask),
            h_sel=self._dev(_pad(plan.h_sel[cis], {0: Jp, 1: Ghp}, False)),
            h_owner=self._dev(_pad(plan.h_owner[cis], {0: Jp, 1: Ghp}, False)),
            z_sel=self._dev(_pad(plan.z_sel[cis], {0: Jp, 1: Gzp}, False)),
            z_owner=self._dev(_pad(plan.z_owner[cis], {0: Jp, 1: Gzp}, False)),
            sub_value=self._dev(
                stepvec([s.sub_value for s in steps], np.int32, -1)
            ),
            sub_first=self._dev(
                stepvec([s.sub_first for s in steps], bool, True)
            ),
            sub_last=self._dev(
                stepvec([s.sub_last for s in steps], bool, True)
            ),
            wf_group=self._dev(
                stepvec([s.wf_group for s in steps], np.int32, -1)
            ),
            wf_key=self._dev(
                stepvec([s.wf_key for s in steps], np.int32, -1)
            ),
            zone_rest=self._dev(_pad(zone_rest, {0: Jp, 1: Vp}, False)),
            **topo_kw,
        )
        prep._batch["class_steps"] = step
        prep._batch["step_class"] = ci_j
        prep.step_class = ci_j
        # gang and tier step rows (device [Jp]): the class tier and
        # kernel-gang index lifted to the scanned step axis — present only
        # when the batch carries tiers or gangs
        tier_of_class = prep._batch.get("tier_of_class")
        if tier_of_class is not None:
            gang_of_class = prep._batch["gang_of_class"]
            prep.step_tier = self._dev(
                _pad(tier_of_class[cis], {0: Jp}, 0)
            )
            prep.step_gang = self._dev(
                # padded steps are gang-free: never preemption-eligible
                # (their counts are 0), never a kernel gang
                _pad(gang_of_class[cis], {0: Jp}, gangmod.GANG_FREE)
            )
            prep._batch["step_tier_d"] = prep.step_tier
            prep._batch["step_gang_d"] = prep.step_gang
        return step

    def _catalog_union(self) -> List[InstanceType]:
        if self._catalog is None:
            seen = {}
            for t in self.templates:
                for it in t.instance_type_options:
                    seen.setdefault(id(it), it)
            # include full per-pool catalogs so class_it covers everything
            for its in self.instance_types.values():
                for it in its:
                    seen.setdefault(id(it), it)
            self._catalog = list(seen.values())
        return self._catalog

    def _node_daemon_overhead(self, node: SimNode) -> dict:
        return resutil.requests_for_pods(
            *node_daemon_pods(node, self.daemonset_pods)
        )

    # ------------------------------------------------------------------

    def _decode(
        self, prep: _Prepared, out: Dict[str, np.ndarray]
    ) -> Tuple[List[InFlightNodeClaim], List[ExistingNodeSim], list]:
        """Re-materialize device placements through the host algebra.

        Topology-free solves merge each slot's class groups with the exact
        reference-semantics machinery (Requirements.add +
        filter_instance_types). Topology solves instead reconstruct each
        fresh slot's joined requirements straight from the final device
        planes (decode_requirements — the planes already carry every
        admissibility tightening the kernel applied) and sync the host
        groups' domain counters from the device count state. Either way, any
        placement the host-side checks reject is re-placed through the host
        greedy add; only pods the host path also rejects surface as failures
        (and re-enter via relaxation)."""
        # per-class decision planes: the step->class merge already ran on
        # device (ops/ffd.aggregate_takes), so decode starts from the
        # [C, used-slots] matrix instead of replaying J scan steps
        takes_bc = np.asarray(out["takes_bc"])
        unplaced_by_class = np.asarray(out["unplaced_bc"]).astype(np.int64)
        slot_template = np.asarray(out["template"])
        plan = prep.plan
        C = len(prep.classes)
        E = len(prep.existing_sims)
        failed: list = []
        divergent: List[Pod] = []

        assigned: Dict[int, Dict[int, int]] = {}
        for ci, n in zip(*np.nonzero(takes_bc)):
            assigned.setdefault(int(n), {})[int(ci)] = int(takes_bc[ci, n])
        for ci, cls in enumerate(prep.classes):
            k_unplaced = int(unplaced_by_class[ci])
            if k_unplaced:
                for p in cls.pods[cls.count - k_unplaced :]:
                    failed.append((p, "no nodepool matched pod"))

        claims: List[InFlightNodeClaim] = []
        topo = prep.topo
        pod_cursor = {ci: 0 for ci in range(C)}

        if plan.has_device_topology():
            return self._decode_topo(
                prep, out, assigned, slot_template, pod_cursor, claims, failed
            )

        # ---- topology-free path ------------------------------------------
        # group-add is exact only when no topology group could observe these
        # pods (decode sees topology-free pods, but inverse anti-affinity
        # groups from the cluster can still select them by label)
        can_group = not topo.topologies and not topo.inverse_topologies
        rid = self._request

        with tracing.span("decode.commit", rid) as sp:
            for n in sorted(assigned):
                groups = sorted(assigned[n].items())
                if n < E:
                    target = prep.existing_sims[n]
                else:
                    si = int(slot_template[n])
                    template = prep.templates[si]
                    if can_group and self._decode_fresh_vectorized(
                        prep, si, template, groups, pod_cursor, topo,
                        claims, divergent,
                    ):
                        continue
                    target = InFlightNodeClaim(
                        template,
                        topo,
                        self.daemon_overhead[si],
                        template.instance_type_options,
                    )
                    claims.append(target)
                for ci, k in groups:
                    cls = prep.classes[ci]
                    start = pod_cursor[ci]
                    pods = cls.pods[start : start + k]
                    pod_cursor[ci] = start + k
                    if not pods:
                        continue
                    req = resutil.requests_for_pods(pods[0])
                    if can_group and not pods[0].host_ports:
                        try:
                            target.add_group(pods, req)
                            continue
                        except IncompatibleError:
                            pass  # re-place pod-by-pod below
                    for p in pods:
                        try:
                            target.add(p, req)
                        except IncompatibleError:
                            divergent.append(p)
            sp.count("fresh_slots", len(claims))
        with tracing.span("decode.replay", rid):
            if divergent:
                from karpenter_core_tpu_torch.metrics import wiring as m

                m.SOLVER_HOST_FALLBACK_PODS.inc(
                    {"cause": "divergent"}, by=len(divergent)
                )
            for p in divergent:
                err = self._host_fallback_add(
                    p, claims, prep.existing_sims, topo)
                if err is not None:
                    failed.append((p, err))
        # drop empty claims (all groups failed), releasing their placeholder
        # hostnames from the shared per-round topology (see below)
        kept = []
        for c in claims:
            if c.pods:
                kept.append(c)
            else:
                c.destroy()
        if can_group:
            with tracing.span("decode.repack", rid):
                kept = self._repack_sparse_claims(kept)
        return kept, prep.existing_sims, failed

    def _repack_sparse_claims(
        self, claims: List[InFlightNodeClaim]
    ) -> List[InFlightNodeClaim]:
        """Eliminate class-batched tail fragmentation.

        The kernel opens ceil(rem/kstar) identical fresh slots per class
        (ops/ffd.py), which can strand a near-empty tail node the
        pod-at-a-time oracle never creates. Walk claims sparsest-first and
        try to re-place each one's pods into the other claims through the
        host algebra; a claim whose pods all move is dropped. Stops at the
        first claim that cannot fully drain (denser ones won't either).
        Topology-free solves only (the caller gates on can_group): moving a
        pod never touches domain counters here. A partial drain keeps the
        claim with its remaining pods — still a valid packing, requests
        intentionally left conservative (stale high) on the source."""
        if len(claims) < 2:
            return claims
        claims = sorted(claims, key=lambda c: len(c.pods))
        out = list(claims)
        for claim in claims:
            others = sorted(
                (c for c in out if c is not claim), key=lambda c: len(c.pods)
            )
            moved: List[Pod] = []
            ok = True
            for p in list(claim.pods):
                req = resutil.requests_for_pods(p)
                placed = False
                for o in others:
                    try:
                        o.add(p, req)
                        placed = True
                        break
                    except IncompatibleError:
                        continue
                if not placed:
                    ok = False
                    break
                moved.append(p)
            if not ok:
                # keep the claim with whatever didn't move; a moved pod
                # stays moved (both homes are valid, only one lists it)
                moved_ids = {id(p) for p in moved}
                claim.pods = [p for p in claim.pods if id(p) not in moved_ids]
                break
            claim.pods = []
            claim.destroy()
            out.remove(claim)
        return out

    # -- topology decode ---------------------------------------------------

    def _decode_topo(
        self,
        prep: _Prepared,
        out: Dict[str, np.ndarray],
        assigned: Dict[int, Dict[int, int]],
        slot_template: np.ndarray,
        pod_cursor: Dict[int, int],
        claims: List[InFlightNodeClaim],
        failed: list,
    ) -> Tuple[List[InFlightNodeClaim], List[ExistingNodeSim], list]:
        """Decode with device topology state: bulk commits, then host group
        count sync, then deferred per-pod replays.

        Ordering is load-bearing: deferred pods must replay through the host
        algebra AFTER the device counts (minus the deferred contributions)
        are synced into the host TopologyGroups, or they would place against
        stale counters."""
        plan, topo = prep.plan, prep.topo
        E = len(prep.existing_sims)
        valmask = np.asarray(out["valmask"])
        defines = np.asarray(out["defines"])
        complement = np.asarray(out["complement"])
        gt = np.asarray(out["gt"])
        lt = np.asarray(out["lt"])
        itmask = np.asarray(out["itmask"])
        hcount = np.asarray(out["hcount"]).astype(np.int64).copy()
        zcount = np.asarray(out["zcount"]).astype(np.int64).copy()

        deferred: List[Pod] = []
        densified = 0  # densify victims inside `deferred` (metrics split)
        # (slot, class, k, slot requirements, hostname) per bulk commit
        committed: List[tuple] = []
        slot_hostnames: Dict[int, str] = {}
        slot_claims: Dict[int, InFlightNodeClaim] = {}  # fresh slots only

        def defer(n: int, ci: int, pods: List[Pod]) -> None:
            self._topo_subtract(
                plan, valmask, defines, complement, n, ci, len(pods),
                hcount, zcount,
            )
            deferred.extend(pods)

        rid = self._request
        with tracing.span("decode.commit", rid) as sp:
            tested = 0
            for n in sorted(assigned):
                groups = sorted(assigned[n].items())
                if n >= E:
                    tested += self._commit_fresh_topo(
                        prep, n, int(slot_template[n]), groups, pod_cursor,
                        claims, committed, slot_hostnames, defer,
                        valmask, defines, complement, gt, lt, itmask,
                        slot_claims,
                    )
                    continue
                target = prep.existing_sims[n]
                slot_hostnames[n] = target.name
                for ci, k in groups:
                    cls = prep.classes[ci]
                    start = pod_cursor[ci]
                    pods = cls.pods[start : start + k]
                    pod_cursor[ci] = start + k
                    if not pods:
                        continue
                    if pods[0].host_ports:
                        defer(n, ci, pods)
                        continue
                    try:
                        target.add_group(
                            pods, resutil.requests_for_pods(pods[0]))
                        committed.append((n, ci, len(pods),
                                          target.requirements, target.name))
                    except IncompatibleError:
                        defer(n, ci, pods)
            sp.count("fresh_slots", len(slot_claims))
            sp.count("types_tested", tested)

        # Voluntary densification deferral (the topology twin of
        # _repack_sparse_claims): the class-batched kernel strands sparse
        # tail slots (ceil(rem/kstar) per class) the pod-at-a-time oracle
        # never opens. Drain the sparsest fresh slots through the existing
        # subtract-and-repair machinery — their pods re-place one-by-one
        # into the other claims' residual capacity via the host algebra,
        # re-opening an equivalent node only when nothing admits them, so
        # the pass can only densify.
        with tracing.span("decode.densify", rid):
            if len(slot_claims) >= 2:
                sizes = sorted(len(c.pods) for c in slot_claims.values())
                median = sizes[len(sizes) // 2]
                eligible = sorted(
                    (
                        (n, c)
                        for n, c in slot_claims.items()
                        if len(c.pods) <= int(median * DENSIFY_THRESHOLD)
                    ),
                    key=lambda nc: len(nc[1].pods),
                )[: int(len(slot_claims) * DENSIFY_CAP)]
                victims = []
                pod_budget = DENSIFY_POD_BUDGET
                for n, c in eligible:
                    if len(c.pods) > pod_budget:
                        break
                    pod_budget -= len(c.pods)
                    victims.append((n, c))
                if victims:
                    from karpenter_core_tpu_torch.metrics import wiring as m

                    densified = sum(len(c.pods) for _, c in victims)
                    m.SOLVER_HOST_FALLBACK_PODS.inc(
                        {"cause": "densify"}, by=densified
                    )
                for n, claim in victims:
                    for entry in [e for e in committed if e[0] == n]:
                        _n, ci, k, _reqs, _hn = entry
                        self._topo_subtract(
                            plan, valmask, defines, complement, n, ci, k,
                            hcount, zcount,
                        )
                        committed.remove(entry)
                    deferred.extend(claim.pods)
                    claim.pods = []
                    claim.destroy()
                    claims.remove(claim)
                    slot_hostnames.pop(n, None)

        with tracing.span("decode.sync", rid):
            self._sync_topo_counts(prep, hcount, zcount, slot_hostnames)
            self._recount_host_only(prep, committed)

        with tracing.span("decode.replay", rid):
            if len(deferred) > densified:
                from karpenter_core_tpu_torch.metrics import wiring as m

                m.SOLVER_HOST_FALLBACK_PODS.inc(
                    {"cause": "deferred"}, by=len(deferred) - densified
                )
            for p in deferred:
                err = self._host_fallback_add(
                    p, claims, prep.existing_sims, topo)
                if err is not None:
                    failed.append((p, err))

        kept = []
        for c in claims:
            if c.pods:
                kept.append(c)
            else:
                c.destroy()
        return kept, prep.existing_sims, failed

    def _commit_fresh_topo(
        self,
        prep: _Prepared,
        n: int,
        si: int,
        groups: List[Tuple[int, int]],
        pod_cursor: Dict[int, int],
        claims: List[InFlightNodeClaim],
        committed: List[tuple],
        slot_hostnames: Dict[int, str],
        defer,
        valmask: np.ndarray,
        defines: np.ndarray,
        complement: np.ndarray,
        gt: np.ndarray,
        lt: np.ndarray,
        itmask: np.ndarray,
        slot_claims: Optional[Dict[int, InFlightNodeClaim]] = None,
    ) -> None:
        """Materialize one fresh topology slot from the final device planes:
        float64-refit the take against the slot's final viable instance
        types, rebuild the joined requirements with decode_requirements, and
        commit in bulk. minValues / hostPort shapes go per-pod instead.
        Returns the number of instance types the refit tested."""
        template = prep.templates[si]
        T = len(prep.catalog)
        entries: List[Tuple[int, List[Pod]]] = []
        for ci, k in groups:
            cls = prep.classes[ci]
            start = pod_cursor[ci]
            pods = cls.pods[start : start + k]
            pod_cursor[ci] = start + k
            if pods:
                entries.append((ci, pods))
        if not entries:
            return 0
        plane_ok = not template.requirements.has_min_values() and all(
            not pods[0].host_ports
            and not prep.classes[ci].requirements.has_min_values()
            for ci, pods in entries
        )
        # quantized-integer refit (exact integer arithmetic): the same
        # arithmetic regime as the device kernel, so a slot the kernel packed
        # exactly full is not deferred over a 1e-13 raw-float drift
        requests = dict(self.daemon_overhead[si])
        for ci, pods in entries:
            requests = resutil.merge_repeated(
                requests, resutil.requests_for_pods(pods[0]), len(pods)
            )
        viable = np.nonzero(itmask[n, :T])[0]
        _, opt_idx = _refit_slot(
            prep.tmpl_overhead64q[si], prep.class_requests64q,
            [(ci, len(pods)) for ci, pods in entries],
            prep.it_alloc64q, viable,
        )
        if not plane_ok or not opt_idx:
            for ci, pods in entries:
                defer(n, ci, pods)
            return len(viable)
        claim = InFlightNodeClaim(
            template,
            prep.topo,
            self.daemon_overhead[si],
            [prep.catalog[t] for t in opt_idx],
        )
        reqs = decode_requirements(
            prep.vocab, valmask[n], defines[n], complement[n], gt[n], lt[n]
        )
        reqs.add(
            Requirement.new(apilabels.LABEL_HOSTNAME, "In", [claim.hostname])
        )
        claim.requirements = reqs
        claim.pods = [p for _, pods in entries for p in pods]
        claim.requests = requests
        claims.append(claim)
        slot_hostnames[n] = claim.hostname
        if slot_claims is not None:
            slot_claims[n] = claim
        for ci, pods in entries:
            committed.append((n, ci, len(pods), reqs, claim.hostname))
        return len(viable)

    @staticmethod
    def _topo_subtract(
        plan, valmask, defines, complement, n, ci, k, hcount, zcount
    ) -> None:
        """Remove a deferred placement's contributions from the device
        counts — the mirror of the kernel's count update, evaluated on the
        final planes (a slot pinned by a LATER class than the deferred one
        can over-subtract by at most the deferred pod count; deferred slots
        are divergence repairs, so the drift is bounded and rare)."""
        if plan.h_sel.size:
            hcount[n, :] -= k * plan.h_sel[ci].astype(np.int64)
        for gi in range(len(plan.label_groups)):
            if not plan.z_sel[ci, gi]:
                continue
            kid = int(plan.z_key[gi])
            if not defines[n, kid] or complement[n, kid]:
                continue
            row = valmask[n, kid]
            if plan.z_type[gi] == 1 or row.sum() == 1:
                zcount[gi] -= k * row.astype(np.int64)

    def _sync_topo_counts(
        self, prep: _Prepared, hcount, zcount, slot_hostnames: Dict[int, str]
    ) -> None:
        """Overwrite the host TopologyGroups' domain counters with the
        device truth (counts for untouched slots/domains are unchanged by
        construction, so only synced entries are written)."""
        plan = prep.plan
        for gi, dg in enumerate(plan.host_groups):
            g = dg.group
            for n, name in slot_hostnames.items():
                cnt = max(int(hcount[n, gi]), 0)
                if name not in g.domains and cnt == 0:
                    continue
                g.domains[name] = cnt
                if cnt > 0:
                    g.empty_domains.discard(name)
                else:
                    g.empty_domains.add(name)
        for gi, dg in enumerate(plan.label_groups):
            g = dg.group
            kid = int(plan.z_key[gi])
            names = prep.vocab.value_names[kid]
            # union with nonzero count columns: the kernel can record
            # placements on vocab values outside the registered universe (a
            # counted-not-constrained class pinned to an unregistered
            # domain); TopologyGroup.record creates new domain entries, so
            # the sync must too or host-fallback replays see stale counters
            cols = np.nonzero(plan.z_domains[gi] | (zcount[gi] != 0))[0]
            for vid in cols:
                name = names[vid]
                cnt = max(int(zcount[gi, vid]), 0)
                if name not in g.domains and cnt == 0:
                    continue
                g.domains[name] = cnt
                if cnt > 0:
                    g.empty_domains.discard(name)
                else:
                    g.empty_domains.add(name)

    def _recount_host_only(self, prep: _Prepared, committed: List[tuple]) -> None:
        """Groups the device could not model (non-trivial spread node
        filters) re-count the bulk-committed placements host-side at
        (class × slot) granularity — their owner classes always run on the
        host, so these counters only need the device classes' contributions."""
        plan = prep.plan
        if not plan.host_only_groups:
            return
        from karpenter_core_tpu_torch.scheduling.requirements import (
            ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
        )

        for g in plan.host_only_groups:
            for n, ci, k, reqs, hostname in committed:
                rep = prep.classes[ci].pods[0]
                if not g.selects(rep):
                    continue
                if not g.node_filter.matches_requirements(
                    reqs, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
                ):
                    continue
                if g.key == apilabels.LABEL_HOSTNAME:
                    domain = hostname
                else:
                    dom_req = reqs.get(g.key)
                    vals = dom_req.sorted_values()
                    if dom_req.complement or len(vals) != 1:
                        continue
                    domain = vals[0]
                g.record(*([domain] * k))

    def _decode_fresh_vectorized(
        self,
        prep: _Prepared,
        si: int,
        template,
        groups: List[Tuple[int, int]],
        pod_cursor: Dict[int, int],
        topo: Topology,
        claims: List[InFlightNodeClaim],
        divergent: List[Pod],
    ) -> bool:
        """Materialize a fresh slot's claim straight from the prep tensors.

        The per-group viability mask — template ITs ∧ class requirement
        compat (class_it, the same kernels the FFD scan used, property-tested
        against the host algebra) ∧ float64 resource fit ∧ offering
        availability under the joined zone/capacity-type masks — replaces
        the O(groups × instance-types) Python filter. Requirements and
        request dicts are still folded through the host algebra once per
        class, so the returned claim is indistinguishable from the
        add()-built one. Returns False to fall back wholesale (min-values or
        host ports in play), leaving pod cursors untouched."""
        if template.requirements.has_min_values():
            return False
        for ci, _k in groups:
            cls = prep.classes[ci]
            if cls.pods and (
                cls.pods[0].host_ports or cls.requirements.has_min_values()
            ):
                return False

        # The whole plane outcome is a pure function of the composition
        # (si, groups) given prep — and hundreds of slots repeat a handful
        # of compositions, so the per-class trial loop, request folding,
        # requirement joining, and final filter all cache on that shape;
        # per-slot work reduces to cursor advancement + claim assembly.
        shape = (si, tuple(groups))
        cached = self._composition_cache.get(shape)
        if cached is None:
            cached = self._decode_composition(prep, si, template, groups)
            self._composition_cache[shape] = cached
        committed_counts, remaining, requests_proto, reqs_proto = cached

        committed_set = {ci for ci, _ in committed_counts}
        pods_all: List[Pod] = []
        for ci, k in groups:
            cls = prep.classes[ci]
            start = pod_cursor[ci]
            pods = cls.pods[start : start + k]
            pod_cursor[ci] = start + k
            if not pods:
                continue
            if ci in committed_set and remaining:
                pods_all.extend(pods)
            else:
                divergent.extend(pods)
        if pods_all:
            claim = InFlightNodeClaim(
                template, topo, self.daemon_overhead[si], list(remaining)
            )
            claim.requirements.add(*(r.copy() for r in reqs_proto))
            claim.pods = pods_all
            claim.requests = dict(requests_proto)
            claims.append(claim)
        return True

    def _decode_composition(
        self, prep: _Prepared, si: int, template, groups: List[Tuple[int, int]]
    ):
        """Evaluate one composition shape through the plane algebra: the
        per-group viability mask — template ITs ∧ class requirement compat
        (class_it, the same kernels the FFD scan used, property-tested
        against the host algebra) ∧ quantized-integer resource fit (the
        device kernel's exact arithmetic, so slots packed exactly full are
        not rejected over raw-float drift) ∧ offering availability under
        the joined zone/capacity-type masks — then one final
        requirements-only filter_instance_types against the JOINED
        requirements (classes can be pairwise-IT-compatible yet jointly
        narrower)."""
        Z, CT = prep.n_zones, prep.n_cts
        cm = prep.class_masks
        T = len(prep.catalog)
        mask = prep.tmpl_it_np[si].copy()
        req_vec = prep.tmpl_overhead64q[si].copy()
        zmask = prep.tmpl_mask_np[si, prep.zone_kid, :Z].copy()
        ctmask = prep.tmpl_mask_np[si, prep.ct_kid, :CT].copy()
        requests = dict(self.daemon_overhead[si])
        committed_counts: List[Tuple[int, int]] = []

        for ci, k in groups:
            cls = prep.classes[ci]
            if not cls.pods:
                continue
            trial_req = req_vec.copy()
            for _ in range(k):
                trial_req += prep.class_requests64q[ci]
            trial_z = zmask & cm.mask[ci, prep.zone_kid, :Z]
            trial_ct = ctmask & cm.mask[ci, prep.ct_kid, :CT]
            fits = (trial_req[None, :] <= prep.it_alloc64q).all(axis=1)
            off_ok = (
                prep.off_avail_np
                & trial_z[None, :, None]
                & trial_ct[None, None, :]
            ).any(axis=(1, 2))
            trial = mask & prep.class_it[ci] & fits & off_ok
            if not trial.any():
                continue  # caller diverges this class (not in committed)
            mask, req_vec, zmask, ctmask = trial, trial_req, trial_z, trial_ct
            requests = resutil.merge_repeated(
                requests, resutil.requests_for_pods(cls.pods[0]), k
            )
            committed_counts.append((ci, k))

        remaining: list = []
        reqs_proto: list = []
        if committed_counts:
            options = [prep.catalog[i] for i in np.nonzero(mask[:T])[0]]
            joined = Requirements()
            joined.add(*(r.copy() for r in template.requirements.values()))
            for ci, _k in committed_counts:
                reqs = prep.classes[ci].requirements
                reqs_proto.extend(reqs.values())
                joined.add(*(r.copy() for r in reqs.values()))
            remaining = filter_instance_types(options, joined, {}).remaining
            if not remaining:
                # jointly-incompatible composition: everything diverges
                committed_counts = []
                reqs_proto = []
        return committed_counts, remaining, requests, reqs_proto

    def _host_fallback_add(
        self,
        pod: Pod,
        claims: List[InFlightNodeClaim],
        existing_sims: List[ExistingNodeSim],
        topo: Topology,
        pod_requests: Optional[dict] = None,
    ) -> Optional[str]:
        """Host placement via the shared greedy policy (place_pod), with the
        pools' remaining limits so fallback claims respect NodePool limits
        exactly like the greedy path (scheduler.go:417-434)."""
        if pod_requests is None:
            pod_requests = resutil.requests_for_pods(pod)
        return place_pod(
            pod,
            pod_requests,
            existing_sims,
            claims,
            self.templates,
            {id(t): o for t, o in zip(self.templates, self.daemon_overhead)},
            topo,
            getattr(self, "_round_remaining", {}),
        )
