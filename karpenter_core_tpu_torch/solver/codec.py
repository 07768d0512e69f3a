"""Snapshot wire codec: the solver's process boundary.

SURVEY §7 and BASELINE frame the solver as a service a control plane talks
to over gRPC/DCN; this codec is that boundary's payload format, and the
solverd sidecar (solver/service.py, driven by solver/remote.py) actually
serves it. A solve request (the ``Snapshot`` from solver/snapshot.py —
pure numpy + interned vocab) and a solve response (per-class slot
assignments) round-trip through bytes with no Python-specific pickling:
arrays ride npz, the vocab/metadata ride JSON. A Go (or any) client can
produce the same layout; the in-process path simply skips the codec.
The solverd section below extends the same container to the FULL
scheduler input/output (solve problems, results, consolidation sweeps).

The field set of every encoder here is FROZEN per wire version in
tools/graftlint/wire_schema.lock.json (graftlint GL403): changing a
payload's fields without bumping the governing version constant fails
the lint. Codec-PR workflow: edit, bump SNAPSHOT_WIRE_VERSION /
SOLVE_WIRE_VERSION, run `python -m tools.graftlint --update-wire-lock`,
commit the regenerated lock alongside.
"""
from __future__ import annotations

import io
import json
from typing import Dict, List, Optional, Tuple

import numpy as np

from karpenter_core_tpu_torch.solver.vocab import EntityMasks, Vocab

_HEADER_KEY = "__header__"

# the snapshot (pre-tensorized subproblem) wire; the full solverd wire
# below versions separately as SOLVE_WIRE_VERSION
SNAPSHOT_WIRE_VERSION = 1


def _masks_to_arrays(prefix: str, m: EntityMasks, out: Dict[str, np.ndarray]):
    out[f"{prefix}_mask"] = m.mask
    out[f"{prefix}_defines"] = m.defines
    out[f"{prefix}_concrete"] = m.concrete
    out[f"{prefix}_negative"] = m.negative
    out[f"{prefix}_gt"] = m.gt
    out[f"{prefix}_lt"] = m.lt


def _masks_from_arrays(prefix: str, z) -> EntityMasks:
    return EntityMasks(
        mask=z[f"{prefix}_mask"],
        defines=z[f"{prefix}_defines"],
        concrete=z[f"{prefix}_concrete"],
        negative=z[f"{prefix}_negative"],
        gt=z[f"{prefix}_gt"],
        lt=z[f"{prefix}_lt"],
    )


def encode_request(
    vocab,
    resource_names: List[str],
    class_masks: EntityMasks,
    class_requests: np.ndarray,
    class_counts: np.ndarray,
    it_masks: EntityMasks,
    it_allocatable: np.ndarray,
) -> bytes:
    """Serialize one solve request. The vocab's interning tables travel in
    the header so the solver reconstructs the identical closed world."""
    header = {
        "version": SNAPSHOT_WIRE_VERSION,
        "resource_names": list(resource_names),
        "key_names": list(vocab.key_names),
        "value_names": [list(v) for v in vocab.value_names],
    }
    arrays: Dict[str, np.ndarray] = {
        "class_requests": class_requests,
        "class_counts": class_counts,
        "it_allocatable": it_allocatable,
    }
    _masks_to_arrays("class", class_masks, arrays)
    _masks_to_arrays("it", it_masks, arrays)
    buf = io.BytesIO()
    arrays[_HEADER_KEY] = np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8
    )
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def decode_request(data: bytes):
    """Inverse of encode_request: (vocab, resource_names, class_masks,
    class_requests, class_counts, it_masks, it_allocatable)."""
    z = _load_npz(data)
    header = json.loads(bytes(z[_HEADER_KEY]).decode())
    if header.get("version") != SNAPSHOT_WIRE_VERSION:
        # explicit skew error, same policy as the solverd decoders below: a
        # sender on a different wire layout must not surface as a shape
        # mismatch three layers deeper
        raise ValueError(
            f"unsupported snapshot wire version {header.get('version')}"
        )
    # re-intern through Vocab so derived tables (int_values, valid) match
    # the sender's exactly — insertion order preserves every id
    v = Vocab()
    for key in header["key_names"]:
        v.key_id(key)
    for key, names in zip(header["key_names"], header["value_names"]):
        for name in names:
            v.value_id(key, name)
    vocab = v.finalize()
    return (
        vocab,
        list(header["resource_names"]),
        _masks_from_arrays("class", z),
        z["class_requests"],
        z["class_counts"],
        _masks_from_arrays("it", z),
        z["it_allocatable"],
    )


def encode_response(
    takes: np.ndarray, unplaced: np.ndarray, slot_template: np.ndarray
) -> bytes:
    """Serialize one solve response: per-step × per-slot take counts plus
    the chosen template per fresh slot."""
    buf = io.BytesIO()
    np.savez_compressed(
        buf, takes=takes, unplaced=unplaced, slot_template=slot_template
    )
    return buf.getvalue()


def decode_response(data: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    z = _load_npz(data)
    return z["takes"], z["unplaced"], z["slot_template"]


# ---------------------------------------------------------------------------
# solverd wire format: the full solve problem and its results.
#
# The snapshot codec above carries one pre-tensorized subproblem; the solverd
# sidecar (solver/service.py) instead receives the whole scheduler input —
# nodepools, per-pool instance types, existing SimNodes, daemonset pods,
# pending pods, topology context — runs DeviceScheduler server-side, and
# returns placements keyed by pod uid / node name / instance-type name so the
# client (solver/remote.py) re-binds them to its own live objects. Same
# container as above (npz; object payloads ride the JSON header), no
# pickling: API objects go through kube/serial's closed-world registry and
# the solver-side types (Requirement, InstanceType, SimNode) get explicit
# field codecs below.
# ---------------------------------------------------------------------------

# v2: solve requests carry unavailable_offerings (the ICE-cache snapshot).
# The field is load-bearing — an old sidecar that silently dropped it would
# pack onto stocked-out offerings and re-open the create→ICE→delete
# livelock — so the version bumps and a mixed deployment fails EXPLICITLY
# (version-skew error → greedy degradation with the decode-failure metric)
# instead of silently losing the mask.
# v3: evictable-pod views + eviction claims (gangsched, ISSUE 10).
# v4: solver_mode — the per-request backend selector behind the Solver
# seam (relaxsolve, ISSUE 13): "ffd" | "relax", back-compat default "ffd"
# when absent. Load-bearing the same way the ICE mask was: an old sidecar
# silently dropping it would serve the heuristic packer to a client that
# asked for (and will be judged on) the optimizing one.
# v5: the delta wire (segmentstore, ISSUE 14) — a solve request may now be
# a MANIFEST of content-addressed segment digests (solver/segments.py)
# instead of the full problem; the sidecar answers a typed miss for
# digests its store lost, and problem_fingerprint becomes derivable from
# the manifest's problem-half digests (both request forms compute the
# SAME fingerprint, so the scheduler cache never splits on wire form).
# The full-wire form stays first-class at v5 — it is the fallback when a
# sidecar cannot resolve a manifest even after the re-upload round.
# v6: prev_fingerprint — the prior-solve reference (incsolve, ISSUE 16).
# NOT load-bearing for correctness (a daemon that ignores it just solves
# fresh, which is always a valid answer), but the version bumps anyway:
# the wire-schema lock (GL403) makes every field-set change an explicit,
# reviewed bump, and a mixed deployment degrades EXPLICITLY through the
# version-skew error → greedy fallback instead of silently shedding the
# warm-start. Key omitted when empty, so a non-incremental request's
# header carries no trace of the feature.
# v7: topoaware gang placement (ISSUE 20). No new fields — rack/superpod
# node labels and the pod-group rank/max-hops annotations ride the
# existing label/annotation maps — but the RESULT contract changed:
# claims' pod_uids now come back rank-ordered for ranked gangs and a
# placement exceeding a hard max-hops bound is rejected server-side, so a
# mixed deployment must degrade explicitly through the version-skew error
# rather than silently serving distance-blind placements to a client
# whose verifier enforces the distance bound. Hostile wire rank/max-hops
# ints are range-clamped at the annotation parse (solver/gangs.gang_rank
# / gang_max_hops, the registered GL601 normalizers) before any int32
# plane store — the eviction-priority (priority_tier) precedent.
SOLVE_WIRE_VERSION = 7

# the solver backends a request may select; "" means unspecified (the
# serving daemon's default applies)
SOLVER_MODES = ("ffd", "relax")


def _json_payload(header: dict) -> bytes:
    arrays = {
        _HEADER_KEY: np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    }
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def _load_npz(data: bytes):
    """np.load with container-level damage normalized to ValueError: a
    truncated/corrupt npz raises zipfile.BadZipFile (and friends) which
    would sail past the decode-failure nets in solver/remote.py — every
    decoder here funnels through this so "malformed bytes" is ALWAYS a
    ValueError, never a transport-specific surprise in a reconciler."""
    import zipfile

    try:
        return np.load(io.BytesIO(data))
    except (zipfile.BadZipFile, OSError, EOFError, IndexError) as e:
        raise ValueError(f"malformed wire container: {e}") from e


def _json_header(data: bytes) -> dict:
    z = _load_npz(data)
    try:
        return json.loads(bytes(z[_HEADER_KEY]).decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"malformed wire header: {e}") from e


def _encode_req(r) -> dict:
    return {
        "key": r.key,
        "complement": r.complement,
        "values": sorted(r.values),
        "gt": r.greater_than,
        "lt": r.less_than,
        "min_values": r.min_values,
    }


def _decode_req(d: dict):
    from karpenter_core_tpu_torch.scheduling.requirement import Requirement

    return Requirement(
        d["key"],
        complement=d["complement"],
        values=d["values"],
        greater_than=d["gt"],
        less_than=d["lt"],
        min_values=d["min_values"],
    )


def _encode_reqs(reqs) -> List[dict]:
    # key-sorted so the wire bytes — and the problem fingerprint computed
    # over the decoded header — are canonical for one logical Requirements
    # regardless of host-side insertion order
    return [_encode_req(reqs[k]) for k in sorted(reqs)]


def _decode_reqs(items: List[dict]):
    from karpenter_core_tpu_torch.scheduling import Requirements

    out = Requirements()
    # bypass add()'s intersection: the wire carries final requirement sets
    for d in items:
        r = _decode_req(d)
        out[r.key] = r
    return out


def _encode_instance_type(it) -> dict:
    return {
        "name": it.name,
        "requirements": _encode_reqs(it.requirements),
        "offerings": [
            {
                "requirements": _encode_reqs(o.requirements),
                "price": o.price,
                "available": o.available,
            }
            for o in it.offerings
        ],
        "capacity": dict(it.capacity),
        "overhead": dict(it.overhead),
    }


def _decode_instance_type(d: dict):
    from karpenter_core_tpu_torch.cloudprovider.types import (
        InstanceType,
        Offering,
        Offerings,
    )

    return InstanceType(
        name=d["name"],
        requirements=_decode_reqs(d["requirements"]),
        offerings=Offerings(
            Offering(
                requirements=_decode_reqs(o["requirements"]),
                price=o["price"],
                available=o["available"],
            )
            for o in d["offerings"]
        ),
        capacity=dict(d["capacity"]),
        overhead=dict(d["overhead"]),
    )


def _encode_it_table(instance_types: Dict[str, list]) -> Tuple[list, dict]:
    """(table, per-pool index lists). Instance-type OBJECT IDENTITY is part
    of the solve input (catalog union dedupes by id), so objects shared
    across pools encode once and decode back to one shared object."""
    table: List[dict] = []
    index: Dict[int, int] = {}
    pools: Dict[str, List[int]] = {}
    # pool-sorted so the table's row order (a wire LIST, which the problem
    # fingerprint hashes positionally) is canonical per logical catalog
    for pool, its in sorted(instance_types.items()):
        rows = []
        for it in its:
            ti = index.get(id(it))
            if ti is None:
                ti = index[id(it)] = len(table)
                table.append(_encode_instance_type(it))
            rows.append(ti)
        pools[pool] = rows
    return table, pools


def _decode_it_table(table: list, pools: dict) -> Dict[str, list]:
    objs = [_decode_instance_type(d) for d in table]
    return {pool: [objs[i] for i in rows] for pool, rows in pools.items()}


def _encode_volume_usage(vu) -> Optional[dict]:
    if vu is None:
        return None
    return {
        "limits": dict(vu.limits),
        "volumes": {k: sorted(v) for k, v in sorted(vu.volumes.items())},
    }


def _decode_volume_usage(d: Optional[dict]):
    if d is None:
        return None
    from karpenter_core_tpu_torch.scheduling.volumeusage import VolumeUsage

    vu = VolumeUsage()
    vu.limits = dict(d["limits"])
    vu.volumes = {k: set(v) for k, v in d["volumes"].items()}
    return vu


def _encode_sim_node(n) -> dict:
    from karpenter_core_tpu_torch.kube import serial

    out = {
        "name": n.name,
        "labels": dict(n.labels),
        "taints": [serial.encode(t) for t in n.taints],
        "available": dict(n.available),
        "capacity": dict(n.capacity),
        "daemon_requests": dict(n.daemon_requests),
        "initialized": n.initialized,
        "nodeclaim_name": n.nodeclaim_name,
        "nodepool_name": n.nodepool_name,
        "volume_usage": _encode_volume_usage(n.volume_usage),
    }
    # evictable bound pods (gangsched, ISSUE 10): the capacity views a
    # priority-preemptive solve may claim as victims. Key omitted when
    # empty — a node with nothing evictable encodes exactly like a
    # pre-gang one, and the canonical (cost, uid) order keeps the
    # problem fingerprint stable across operator relist order.
    ev = getattr(n, "evictable", ()) or ()
    if ev:
        out.update({
            "evictable": [
                {
                    "uid": e.uid,
                    "priority": e.priority,
                    "requests": dict(e.requests),
                    "cost": e.cost,
                }
                for e in sorted(ev, key=lambda e: (e.cost, e.uid))
            ],
        })
    return out


def _decode_sim_node(d: dict):
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (
        SimNode,
    )
    from karpenter_core_tpu_torch.kube import serial

    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (
        EvictablePod,
    )
    from karpenter_core_tpu_torch.utils.disruption import priority_tier

    return SimNode(
        name=d["name"],
        labels=dict(d["labels"]),
        taints=[serial.decode(t) for t in d["taints"]],
        available=dict(d["available"]),
        capacity=dict(d["capacity"]),
        daemon_requests=dict(d["daemon_requests"]),
        initialized=d["initialized"],
        nodeclaim_name=d["nodeclaim_name"],
        nodepool_name=d["nodepool_name"],
        volume_usage=_decode_volume_usage(d["volume_usage"]),
        # absent from pre-gangsched encoders -> nothing evictable. The
        # priority clamps through priority_tier at the decode net: the
        # legitimate path (state/cluster._evictable_on) already ships a
        # tier, and an unclamped hostile value would overflow the int32
        # EvPlanes tensor INSIDE the exclusive device window — a crash
        # charged as poison where a cheap corrupt-wire rejection belongs.
        evictable=tuple(
            EvictablePod(
                uid=e["uid"],
                priority=priority_tier(int(e["priority"])),
                requests=dict(e["requests"]),
                cost=float(e["cost"]),
            )
            for e in d.get("evictable", ())
        ),
    )


def _pod_sort_key(p):
    return (p.metadata.namespace or "", p.metadata.name or "", p.uid)


def _encode_topology(topo) -> Optional[dict]:
    from karpenter_core_tpu_torch.kube import serial

    if topo is None:
        return None
    return {
        "domains": {k: sorted(v) for k, v in sorted(topo.domains.items())},
        # canonical (node, pod) order: domain counting on decode is
        # order-insensitive, and this list rides the problem fingerprint
        "existing_pods": [
            [serial.encode(p), dict(labels), name]
            for p, labels, name in sorted(
                topo.existing_pods,
                key=lambda t: (t[2], _pod_sort_key(t[0])),
            )
        ],
        "excluded": sorted(topo.excluded_pods),
    }


def _decode_topology(d: Optional[dict]):
    if d is None:
        return None
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (
        Topology,
    )
    from karpenter_core_tpu_torch.kube import serial

    return Topology(
        domains={k: set(v) for k, v in d["domains"].items()},
        existing_pods=[
            (serial.decode(p), dict(labels), name)
            for p, labels, name in d["existing_pods"]
        ],
        excluded_pod_uids=d["excluded"],
    )


# graftlint: disable=GL401 -- encode_solve_request delegates its whole
# header to _encode_solve_header (whose field set GL401 checks against
# _decode_solve_header directly, including "version"); "kind" and
# "wire_kind" are decode_solve_request's FORM-dispatch surface shared
# with encode_manifest_request — the one-level twin pairing cannot see
# either relationship, and the twins it cannot pair are each locked by
# GL403 at SOLVE_WIRE_VERSION
def encode_solve_request(
    nodepools,
    instance_types: Dict[str, list],
    existing_nodes,
    daemonset_pods,
    pods,
    topology=None,
    max_slots: int = 256,
    unavailable_offerings=(),
    tenant: str = "default",
    solver_mode: str = "ffd",
    prev_fingerprint: str = "",
) -> bytes:
    """Serialize a full scheduler input for the solverd sidecar.
    ``unavailable_offerings`` is the control plane's ICE-cache snapshot
    (instance-type×zone×capacity-type triples); it rides the wire so the
    sidecar's DeviceScheduler masks the same offerings the client would.
    ``tenant`` identifies the sending operator to the fleet gateway
    (solver/fleet.py) for fair queueing and per-tenant accounting; it
    defaults to the single-tenant id so a pre-fleet client stays valid on
    the same wire version (an old sidecar ignoring it loses only
    accounting, never placements — unlike the load-bearing ICE mask).
    ``solver_mode`` selects the solve backend behind the Solver seam
    (relaxsolve, ISSUE 13): "ffd" (first-fit-decreasing, the classic
    path) or "relax" (convex-relaxation optimizer with the FFD result as
    the scored/anytime fallback); it also rides the X-Solver-Mode header
    so the gateway can route pre-decode.
    ``prev_fingerprint`` names the problem fingerprint of the CLIENT's
    last verified solve against this sidecar (incsolve, ISSUE 16): the
    serving daemon may replay the unchanged half of that packing from
    its ledger. Non-load-bearing like ``tenant`` — a sidecar that drops
    or predates it solves fresh, never wrongly — so it rides the same
    wire version, omitted when empty (the evictions idiom)."""
    return _json_payload(_encode_solve_header(
        nodepools,
        instance_types,
        existing_nodes,
        daemonset_pods,
        pods,
        topology=topology,
        max_slots=max_slots,
        unavailable_offerings=unavailable_offerings,
        tenant=tenant,
        solver_mode=solver_mode,
        prev_fingerprint=prev_fingerprint,
    ))


def _encode_solve_header(
    nodepools,
    instance_types: Dict[str, list],
    existing_nodes,
    daemonset_pods,
    pods,
    topology=None,
    max_slots: int = 256,
    unavailable_offerings=(),
    tenant: str = "default",
    solver_mode: str = "ffd",
    prev_fingerprint: str = "",
) -> dict:
    """The full solve header as a dict — encode_solve_request's payload
    before the npz container, shared by the full wire (v1..v5 shape) and
    the delta wire (solver/segments.py splits this exact dict into
    content-addressed segments, so the manifest path is wire-equivalent
    by construction)."""
    if solver_mode not in SOLVER_MODES:
        raise ValueError(f"unknown solver mode {solver_mode!r}")
    from karpenter_core_tpu_torch.kube import serial

    table, pools = _encode_it_table(instance_types)
    # every PROBLEM-half list is hashed positionally by problem_fingerprint,
    # so each gets a canonical order: a restarted operator (or a second
    # replica) relisting the same cluster in a different order must produce
    # the same fingerprint, or the sidecar's warm scheduler cache misses on
    # every solve. Safe because the decode side is order-insensitive: the
    # DeviceScheduler re-sorts nodepools/existing nodes itself and daemon
    # overhead is a sum. The pending pods keep caller order — it is the
    # queue order the solve lifts to classes, and it is excluded from the
    # fingerprint anyway.
    header = {
        "version": SOLVE_WIRE_VERSION,
        "nodepools": [
            serial.encode(np_)
            for np_ in sorted(nodepools, key=lambda n: n.metadata.name)
        ],
        "it_table": table,
        "it_pools": pools,
        "existing_nodes": [
            _encode_sim_node(n)
            for n in sorted(existing_nodes, key=lambda n: n.name)
        ],
        "daemonset_pods": [
            serial.encode(p)
            for p in sorted(daemonset_pods, key=_pod_sort_key)
        ],
        "pods": [serial.encode(p) for p in pods],
        "topology": _encode_topology(topology),
        "max_slots": max_slots,
        "unavailable_offerings": sorted(
            list(k) for k in unavailable_offerings
        ),
        "tenant": tenant,
        "solver_mode": solver_mode,
    }
    # prior-solve reference (incsolve, ISSUE 16 / wire v6): key omitted
    # when empty so a non-incremental request's header carries no trace
    # of the feature — and the fingerprint probes (solver/segments.py)
    # never see it either way, so naming a predecessor cannot churn the
    # scheduler-cache key it warms
    if prev_fingerprint:
        header.update({"prev_fingerprint": prev_fingerprint})
    return header


def problem_fingerprint(header: dict) -> str:
    """Stable content hash of a solve request's PROBLEM half — everything
    except the pending pods (nodepools, catalog, existing nodes, daemonset
    pods, topology context, limits, ICE snapshot). Two requests with equal
    fingerprints describe the same cluster, so the sidecar can reuse one
    DeviceScheduler — and with it the prepared-state caches — across RPC
    calls, re-solving only the pod mix.

    v5: derived from the manifest's problem-half SEGMENT DIGESTS
    (solver/segments.py splits the header canonically and hashes the
    sorted (kind, digest) pairs), so a manifest request computes the
    identical fingerprint from its digest listing alone — the PR 3
    prepared-state cache and the PR 5 scheduler cache key off digests and
    hit across restarts of either side and across wire forms.

    The exclusions carry over from v4 unchanged: the tenant is routing
    metadata, not problem content (the cache is content-addressed,
    isolation is the gateway's job); solver_mode is excluded because the
    serving daemon appends the RESOLVED mode itself; and the topology
    context's excluded-uid list is derived from the PENDING pods, so
    hashing it would churn the scheduler cache on every reconcile (the
    solve side re-reads the live context on every cache hit)."""
    from karpenter_core_tpu_torch.solver import segments

    return segments.fingerprint_of_header(header)


# decode-net clamp for the wire's slot ceiling: max_slots sizes every
# device plane's slot axis, so a hostile (or fat-fingered) huge value
# would allocate unbounded device memory INSIDE the exclusive device
# window — a crash charged as poison where a cheap decode clamp belongs.
# 1 << 20 mirrors models/provisioner._SLOT_HARD_CAP (one slot per pod at
# 1M pods, far past any real solve; the adaptive regrow loop refuses to
# cross it anyway, so clamping here never changes a solvable problem).
_MAX_SLOTS_CAP = 1 << 20


def _clamp_slots(n) -> int:
    """Normalize a wire-decoded slot ceiling to [1, _MAX_SLOTS_CAP]."""
    try:
        n = int(n)
    except (TypeError, ValueError):
        raise ValueError(f"malformed max_slots on the wire: {n!r}")
    return max(1, min(n, _MAX_SLOTS_CAP))


def _pow2_bucket(n: int, lo: int = 8) -> int:
    """Next power of two >= lo — the same axis-bucketing rule the device
    planes use (models/provisioner._bucket), duplicated here so the wire
    layer stays import-light."""
    return max(lo, 1 << max(n - 1, 1).bit_length())


def problem_bucket(header: dict) -> str:
    """Shape-bucket key for cross-tenant solve coalescing (fleet gateway).

    Two requests in the same bucket are PREDICTED to compile to the same
    padded kernel shapes, so the gateway may dispatch them as one vmapped
    multi-problem device batch. Derived from the problem_fingerprint
    components that drive compile shapes — catalog/nodepool/existing-node/
    daemonset cardinalities, the slot ceiling, the pod-count bucket, and
    topology presence — NOT from their content: two tenants with
    different catalogs of the same shape share a bucket (that is the whole
    point), while the exact-shape check lives one layer down
    (models/provisioner.solve_batch groups by real compile shapes and
    splits any batch the predictor got wrong, so a bucket collision can
    cost a missed coalesce but never a wrong result).

    Gangsched (ISSUE 10) shape components: tiers-active, the tier-count
    bucket, gang presence, and evictable-capacity presence join the key,
    because a gang/priority problem dispatches DIFFERENT kernels
    (gang_solve / preempt_pass) with extra tensor arguments — its compile
    shapes can never match a plain problem's, so coalescing them into one
    PR 9 vmap batch would split every batch at the shape_key check.
    Tiers-ACTIVE (any non-zero tier) is the shape-relevant bit: the
    prepared step-tier/step-gang rows attach exactly when it holds, so an
    all-default problem and an all-tier-100 problem can never share
    kernel shapes even though both have one distinct tier. Tier COUNT
    (not values) additionally rides the bucket for the step-axis layout;
    two active-tier problems with the same count may still coalesce."""
    import hashlib

    from karpenter_core_tpu_torch.solver.gangs import GANG_ANNOTATION

    tiers = set()
    has_gangs = False
    for p in header.get("pods", ()):
        if isinstance(p, dict):
            tiers.add(int(p.get("priority") or 0))
            md = p.get("metadata") or {}
            ann = md.get("annotations") or {}
            if ann.get(GANG_ANNOTATION):
                has_gangs = True
    has_evictable = any(
        n.get("evictable") for n in header.get("existing_nodes", ())
        if isinstance(n, dict)
    )
    parts = (
        SOLVE_WIRE_VERSION,
        _pow2_bucket(len(header.get("it_table", ())), lo=1),
        len(header.get("nodepools", ())),
        _pow2_bucket(len(header.get("existing_nodes", ())) + 1, lo=1),
        _pow2_bucket(len(header.get("daemonset_pods", ())) + 1, lo=1),
        _pow2_bucket(len(header.get("pods", ())), lo=8),
        header.get("max_slots", 0),
        bool(header.get("topology")),
        any(t != 0 for t in tiers),
        _pow2_bucket(len(tiers), lo=1),
        has_gangs,
        has_evictable,
        # solver mode (relaxsolve, ISSUE 13): a relax problem's dispatch
        # stream interleaves assignment kernels and candidate re-solves
        # an ffd problem never issues, so the two modes must never
        # coalesce into one vmapped batch — the bucket splits here and
        # _KernelRequest.shape_key (mode component) backstops one layer
        # down for anything that slips past the predictor. Normalized
        # (absent == the ffd default) so a mode-less client and an
        # explicit-default one still coalesce; the serving daemon
        # additionally suffixes the ticket bucket with the RESOLVED mode,
        # which is what a non-default daemon default rides on.
        str(header.get("solver_mode") or "ffd"),
    )
    return hashlib.sha256(repr(parts).encode()).hexdigest()[:16]


def encode_manifest_request(plan, include=None, base=None) -> bytes:
    """Serialize a delta-wire solve request from a SegmentPlan
    (solver/segments.split_solve_header): the digest listing + inline
    remainder + pod-layout arrays, plus the segment BODIES named by
    ``include`` (None ships everything — the cold-start / full-repair
    form; an empty list ships a pure manifest). Same npz container as
    every other payload; the uploads ride as ``seg_<digest>`` byte
    arrays so one request carries the whole miss repair.

    ``base`` = (previous listing digest, previous rows): the steady-state
    form — instead of the full digest listing (hundreds of rows, hex is
    incompressible), ship ``listing_base`` + the row EDITS against it.
    The daemon holds recent listings content-addressed in its segment
    store; a lost base is a typed miss like any segment, answered by
    resending the full listing."""
    # uploads pack into ONE byte blob (indexed by digest+length in the
    # header): deflate then compresses ACROSS segments — changed node
    # buckets share most of their structure, and per-entry zip overhead
    # would otherwise dominate small repairs
    blobs: List[bytes] = []
    index: List[List] = []
    for dg in (plan.all_digests() if include is None else include):
        data = plan.segments.get(dg)
        if data is not None:
            blobs.append(data)
            index.append([dg, len(data)])
    if base is not None and base[0] != plan.listing_digest:
        prev_set = {tuple(r) for r in base[1]}
        cur_set = {tuple(r) for r in plan.listing}
        header = {
            "version": SOLVE_WIRE_VERSION,
            "kind": "manifest",
            "listing_base": base[0],
            "segments_add": sorted(
                [list(r) for r in cur_set - prev_set]
            ),
            "segments_drop": sorted(
                [list(r) for r in prev_set - cur_set]
            ),
            # integrity pin: the daemon verifies its reconstruction
            # hashes to the listing the pod layout was computed over
            "listing_digest": plan.listing_digest,
            "upload_index": index,
            "inline": plan.inline,
        }
    elif base is not None:
        # unchanged problem half AND pod batches: the smallest wire form
        header = {
            "version": SOLVE_WIRE_VERSION,
            "kind": "manifest",
            "listing_base": base[0],
            "segments_add": [],
            "segments_drop": [],
            "listing_digest": plan.listing_digest,
            "upload_index": index,
            "inline": plan.inline,
        }
    else:
        header = {
            "version": SOLVE_WIRE_VERSION,
            "kind": "manifest",
            "segments": plan.listing,
            "upload_index": index,
            "inline": plan.inline,
        }
    arrays: Dict[str, np.ndarray] = {
        _HEADER_KEY: np.frombuffer(
            json.dumps(header).encode(), dtype=np.uint8
        ),
        "pod_batch": np.asarray(plan.pod_batch, dtype=np.int32),
        "pod_member": np.asarray(plan.pod_member, dtype=np.int32),
        "uploads": np.frombuffer(b"".join(blobs), dtype=np.uint8),
    }
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def _encode_manifest_inline(header: dict) -> dict:
    """The manifest's non-content-addressed remainder: pod-half scalars
    and presence flags. Everything here either changes per solve (tenant
    routing, the pod-derived topology exclusions) or is too small to be
    worth a digest round trip (the ICE snapshot, the slot ceiling). The
    field set is frozen in the GL403 wire lock like every encoder's."""
    topo = header.get("topology")
    # .get with the decoders' back-compat defaults: a header a foreign or
    # older client built without the optional fields must still split
    # (and fingerprint) — absent folds to the same value as an explicit
    # default, exactly as decode_solve_request resolves it
    return {
        "max_slots": header.get("max_slots", 256),
        "tenant": header.get("tenant", "default"),
        "solver_mode": header.get("solver_mode", ""),
        "unavailable_offerings": header.get("unavailable_offerings", []),
        "has_topology": topo is not None,
        "topo_excluded": None if topo is None else topo.get("excluded"),
        "prev_fingerprint": header.get("prev_fingerprint", ""),
    }


def decode_solve_request(data: bytes, segment_store=None) -> dict:
    """Inverse of encode_solve_request; returns a kwargs-style dict (plus
    ``fingerprint``, the problem-half content hash for scheduler reuse,
    ``bucket``, the coalescing shape-bucket key, and ``wire_kind`` —
    ``full`` | ``manifest``). A v5 manifest body resolves through
    ``segment_store`` (solver/segments.py); a store miss raises
    segments.SegmentMissError naming the digests, which the HTTP layer
    turns into the typed 409 answer — never a wrong solve."""
    h = _json_header(data)
    if h["version"] != SOLVE_WIRE_VERSION:
        raise ValueError(f"unsupported solve wire version {h['version']}")
    if h.get("kind") == "manifest":
        return decode_manifest_request(data, segment_store, header=h)
    out = _decode_solve_header(h)
    out["wire_kind"] = "full"
    # the scheduler cache's entry-weight proxy: for the full wire the
    # body IS the problem's byte scale
    out["approx_bytes"] = len(data)
    return out


def decode_manifest_request(
    data: bytes, segment_store=None, header: dict = None
) -> dict:
    """Inverse of encode_manifest_request: store any segment uploads
    riding the body (content-verified — an upload that does not hash to
    its claimed digest is corrupt wire, so a hostile tenant can never
    poison another tenant's manifest through the shared store), assemble
    the full header from the store, and decode it exactly like the full
    wire. The fingerprint is computed from the manifest's digest listing
    alone — the derivability the scheduler caches key on."""
    from karpenter_core_tpu_torch.solver import segments

    h = header if header is not None else _json_header(data)
    if h.get("version") != SOLVE_WIRE_VERSION:
        raise ValueError(f"unsupported solve wire version {h.get('version')}")
    if h.get("kind") != "manifest":
        raise ValueError(f"not a manifest request: kind={h.get('kind')!r}")
    if segment_store is None:
        raise ValueError(
            "manifest solve request but no segment store is configured"
        )
    inline = _decode_manifest_inline(h.get("inline"))
    z = _load_npz(data)
    index = h.get("upload_index", [])
    if not isinstance(index, list):
        raise ValueError(f"malformed upload index: {index!r}")
    if index:
        from karpenter_core_tpu_torch.solver.segments import digest_of

        blob = z["uploads"].tobytes()
        offset = 0
        for row in index:
            if (
                not isinstance(row, list) or len(row) != 2
                or not isinstance(row[0], str)
                or not isinstance(row[1], int) or row[1] < 0
            ):
                raise ValueError(f"malformed upload index row: {row!r}")
            dg, length = row
            piece = blob[offset:offset + length]
            offset += length
            if len(piece) != length or digest_of(piece) != dg:
                # content addressing is verified at the door: a hostile
                # or torn upload can never poison another tenant's
                # manifest through the shared store
                raise ValueError(
                    f"segment upload {dg[:12]} does not hash to its"
                    " claimed digest"
                )
            segment_store.put(dg, piece)
        if offset != len(blob):
            raise ValueError("upload blob length disagrees with its index")
    listing = _resolve_listing(
        h.get("segments"), h.get("listing_base"), h.get("segments_add"),
        h.get("segments_drop"), h.get("listing_digest"), segment_store,
    )
    segments.check_manifest_parts(listing, inline)
    if "pod_batch" not in z.files or "pod_member" not in z.files:
        raise ValueError("manifest body lost its pod layout arrays")
    # track the PROBLEM's real byte scale while assembling: a steady-state
    # manifest body is a few hundred bytes, so the scheduler cache's
    # byte-bound weight proxy must come from the resolved segments, not
    # from len(body) — or N delta-wire tenants would pin N full
    # schedulers the --cache-mib bound accounts as ~0
    fetched = [0]

    def fetch(dg):
        blob = segment_store.get(dg)
        if blob is not None:
            fetched[0] += len(blob)
        return blob

    assembled = segments.assemble_solve_header(
        listing, inline, z["pod_batch"], z["pod_member"], fetch,
    )
    # remember THIS listing content-addressed: the client's next manifest
    # names it as ``listing_base`` and ships only the row edits
    segment_store.put(
        segments.listing_digest_of(listing),
        segments.listing_bytes(listing),
    )
    return {
        # derivability is the point: the fingerprint comes from the
        # digest listing without re-canonicalizing the assembled content
        # (it equals the full-wire fingerprint of the same problem by
        # construction)
        **_decode_solve_header(
            assembled,
            fingerprint=segments.fingerprint_of_parts(listing, inline),
        ),
        "wire_kind": "manifest",
        "approx_bytes": fetched[0],
    }


def _resolve_listing(
    explicit, base, add, drop, want, segment_store
) -> list:
    """The manifest's digest listing: ``explicit`` (the full ``segments``
    rows) or reconstructed from ``listing_base`` + row edits against a
    listing the store holds from an earlier solve. A missing or DRIFTED
    base (the reconstruction's digest must match ``want`` — the listing
    the client computed its pod layout over) raises SegmentMissError for
    the base digest — the client answers by resending the full listing,
    so staleness self-heals in one round instead of mis-indexing a pod
    batch."""
    import json as _json

    from karpenter_core_tpu_torch.solver import segments

    if explicit is not None:
        segments.check_manifest_parts(explicit, {})
        return segments.sort_listing(explicit)
    if not isinstance(base, str) or not base:
        raise ValueError("manifest names neither segments nor a base")
    raw = segment_store.get(base)
    if raw is None:
        raise segments.SegmentMissError([base])
    try:
        rows = _json.loads(raw.decode())
    except (UnicodeDecodeError, ValueError) as e:
        raise ValueError(f"stored base listing is malformed: {e}") from e
    for edits in (add, drop):
        if not isinstance(edits, list) or not all(
            isinstance(r, list) and len(r) == 2
            and all(isinstance(x, str) for x in r)
            for r in edits
        ):
            raise ValueError(f"malformed listing edits: {edits!r}")
    merged = (
        {tuple(r) for r in rows} - {tuple(r) for r in drop}
    ) | {tuple(r) for r in add}
    listing = segments.sort_listing(merged)
    if want and segments.listing_digest_of(listing) != want:
        # drift (evicted-and-readded base collision, corrupt edit set):
        # a typed miss, never a silently mis-assembled problem
        raise segments.SegmentMissError([base])
    return listing


def _decode_manifest_inline(inline) -> dict:
    """Twin of _encode_manifest_inline: shape-check and normalize the
    manifest's non-addressed remainder at the decode net (absent keys
    fold to the encoders' back-compat defaults, like the full wire's)."""
    if not isinstance(inline, dict):
        raise ValueError(f"manifest inline is not a dict: {inline!r}")
    return {
        "max_slots": inline.get("max_slots", 256),
        "tenant": inline.get("tenant", "default"),
        "solver_mode": inline.get("solver_mode", ""),
        "unavailable_offerings": inline.get("unavailable_offerings", []),
        "has_topology": bool(inline.get("has_topology")),
        "topo_excluded": inline.get("topo_excluded"),
        "prev_fingerprint": inline.get("prev_fingerprint", ""),
    }


def request_digest(data: bytes, segment_store=None) -> str:
    """Quarantine/poison key of a request body, stable per logical
    problem across wire forms: full-wire bodies hash their (canonical,
    PR 4) bytes; manifest bodies hash their CORE — digest listing +
    inline + pod layout — so the same problem keys identically whether
    or not segment uploads ride along (the miss/re-upload handshake must
    not split one poison problem into several strike streaks). A
    base+edits manifest reconstructs its listing through
    ``segment_store`` first. Any parse failure (or an unresolvable base)
    degrades to the raw-bytes hash, never a raise — this runs PRE-decode
    as the cheap refusal gate."""
    import hashlib

    from karpenter_core_tpu_torch.solver import segments

    try:
        z = _load_npz(data)
        if "pod_batch" not in z.files:
            return hashlib.sha256(data).hexdigest()
        h = json.loads(bytes(z[_HEADER_KEY]).decode())
        if h.get("kind") != "manifest":
            return hashlib.sha256(data).hexdigest()
        if h.get("segments") is None and segment_store is None:
            return hashlib.sha256(data).hexdigest()
        listing = _resolve_listing(
            h.get("segments"), h.get("listing_base"),
            h.get("segments_add"), h.get("segments_drop"),
            h.get("listing_digest"), segment_store,
        )
        segments.check_manifest_parts(listing, h.get("inline"))
        return segments.core_digest_of(
            listing, h.get("inline"),
            z["pod_batch"], z["pod_member"],
        )
    except (
        ValueError, KeyError, TypeError, UnicodeDecodeError,
        segments.SegmentMissError,
    ):
        return hashlib.sha256(data).hexdigest()


def _decode_solve_header(h: dict, fingerprint: str = None) -> dict:
    """Twin of _encode_solve_header: the full-shape header dict (native
    or assembled from a manifest) to the kwargs-style problem dict. The
    version re-check is deliberate — assembled headers pass through here
    too, and a version skew must never surface as a shape mismatch.
    ``fingerprint`` lets the manifest path hand in its digest-derived
    value instead of re-canonicalizing the whole assembled header."""
    from karpenter_core_tpu_torch.kube import serial

    from karpenter_core_tpu_torch.cloudprovider.types import OfferingKey

    if h.get("version") != SOLVE_WIRE_VERSION:
        raise ValueError(f"unsupported solve wire version {h.get('version')}")
    return {
        "fingerprint": fingerprint or problem_fingerprint(h),
        "bucket": problem_bucket(h),
        "nodepools": [serial.decode(d) for d in h["nodepools"]],
        "instance_types": _decode_it_table(h["it_table"], h["it_pools"]),
        "existing_nodes": [_decode_sim_node(d) for d in h["existing_nodes"]],
        "daemonset_pods": [serial.decode(d) for d in h["daemonset_pods"]],
        "pods": [serial.decode(d) for d in h["pods"]],
        "topology": _decode_topology(h["topology"]),
        "max_slots": _clamp_slots(h["max_slots"]),
        # absent from pre-ICE-cache encoders -> empty set, same semantics
        "unavailable_offerings": frozenset(
            OfferingKey(*k) for k in h.get("unavailable_offerings", [])
        ),
        # absent from a pre-fleet encoder -> the single-tenant id
        "tenant": h.get("tenant", "default"),
        # back-compat default: absent/empty means "unspecified" and the
        # serving daemon's configured default applies (solverd
        # --solver-mode, "ffd" out of the box). Unknown values reject at
        # the decode net — an invalid mode must not surface as a
        # DeviceScheduler constructor raise inside the device window.
        "solver_mode": _check_mode(h.get("solver_mode", "")),
        # prior-solve reference (incsolve, ISSUE 16): absent/empty means
        # no predecessor — the daemon solves fresh, exactly as pre-16
        "prev_fingerprint": str(h.get("prev_fingerprint", "") or ""),
    }


def _check_mode(mode) -> str:
    if mode in SOLVER_MODES or mode == "":
        return mode
    raise ValueError(f"unknown solver mode on the wire: {mode!r}")


def encode_solve_results(results, solve_seconds: float) -> bytes:
    """Serialize a Results: placements by pod uid, instance types by name,
    nodepool by name — the client re-binds them to its live objects."""
    header = {
        "version": SOLVE_WIRE_VERSION,
        "claims": [
            {
                "nodepool": c.template.nodepool_name,
                "instance_types": [it.name for it in c.instance_type_options],
                "requirements": _encode_reqs(c.requirements),
                "requests": dict(c.requests),
                "pod_uids": [p.uid for p in c.pods],
            }
            for c in results.new_node_claims
        ],
        "existing": [
            {"node": sim.name, "pod_uids": [p.uid for p in sim.pods]}
            for sim in results.existing_nodes
        ],
        "errors": dict(results.pod_errors),
        "solve_seconds": solve_seconds,
    }
    # eviction claims (gangsched, ISSUE 10): node name -> victim uids the
    # operator drains before binding. Key omitted when empty, so every
    # non-preemptive solve's result wire is byte-identical to a pre-gang
    # build's at the same wire version (the off-by-default parity the
    # acceptance battery pins).
    evictions = getattr(results, "evictions", None)
    if evictions:
        header.update({
            "evictions": {
                node: list(uids) for node, uids in sorted(evictions.items())
            },
        })
    return _json_payload(header)


def decode_solve_results(data: bytes) -> dict:
    """Plain-data view of a solve response; solver/remote.py materializes
    Results from it against the caller's local objects (requirements decode
    here — they carry no identity)."""
    h = _json_header(data)
    if h.get("version") != SOLVE_WIRE_VERSION:
        # same explicit skew error as the request decoders — an external
        # sidecar on a different code version must not surface as a
        # mysterious per-solve fallback
        raise ValueError(
            f"unsupported solve wire version {h.get('version')}"
        )
    for claim in h["claims"]:
        claim["requirements"] = _decode_reqs(claim["requirements"])
    return h


def encode_frontier_request(
    nodepools,
    instance_types: Dict[str, list],
    cand_nodes,
    keep_nodes,
    daemonset_pods,
    base_pods,
    candidate_pods,
    max_slots: int = 1024,
    tenant: str = "default",
) -> bytes:
    """Serialize a consolidation-frontier sweep (models/consolidation.py)
    for the sidecar: candidate nodes FIRST (prefix p masks slots [0, p)).
    ``tenant`` as in encode_solve_request — gateway accounting only; the
    sweep rides the gateway's NORMAL lane, behind provisioning solves."""
    from karpenter_core_tpu_torch.kube import serial

    table, pools = _encode_it_table(instance_types)
    header = {
        "version": SOLVE_WIRE_VERSION,
        "nodepools": [serial.encode(np_) for np_ in nodepools],
        "it_table": table,
        "it_pools": pools,
        "cand_nodes": [_encode_sim_node(n) for n in cand_nodes],
        "keep_nodes": [_encode_sim_node(n) for n in keep_nodes],
        "daemonset_pods": [serial.encode(p) for p in daemonset_pods],
        "base_pods": [serial.encode(p) for p in base_pods],
        "candidate_pods": [
            [serial.encode(p) for p in pods] for pods in candidate_pods
        ],
        "max_slots": max_slots,
        "tenant": tenant,
    }
    return _json_payload(header)


def decode_frontier_request(data: bytes) -> dict:
    from karpenter_core_tpu_torch.kube import serial

    h = _json_header(data)
    if h["version"] != SOLVE_WIRE_VERSION:
        raise ValueError(f"unsupported solve wire version {h['version']}")
    return {
        "nodepools": [serial.decode(d) for d in h["nodepools"]],
        "instance_types": _decode_it_table(h["it_table"], h["it_pools"]),
        "cand_nodes": [_decode_sim_node(d) for d in h["cand_nodes"]],
        "keep_nodes": [_decode_sim_node(d) for d in h["keep_nodes"]],
        "daemonset_pods": [serial.decode(d) for d in h["daemonset_pods"]],
        "base_pods": [serial.decode(d) for d in h["base_pods"]],
        "candidate_pods": [
            [serial.decode(d) for d in pods] for pods in h["candidate_pods"]
        ],
        "max_slots": _clamp_slots(h["max_slots"]),
        "tenant": h.get("tenant", "default"),
    }


def encode_frontier_response(frontier) -> bytes:
    """frontier: list of (schedulable, new_nodes, price_lb) or None (the
    sweep could not represent the problem — caller binary-searches)."""
    if frontier is None:
        return _json_payload({"version": SOLVE_WIRE_VERSION, "available": False})
    arrays = {
        _HEADER_KEY: np.frombuffer(
            json.dumps(
                {"version": SOLVE_WIRE_VERSION, "available": True}
            ).encode(),
            dtype=np.uint8,
        ),
        "ok": np.array([ok for ok, _, _ in frontier], dtype=bool),
        "n_new": np.array([n for _, n, _ in frontier], dtype=np.int64),
        "price_lb": np.array([p for _, _, p in frontier], dtype=np.float64),
    }
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def decode_frontier_response(data: bytes):
    z = _load_npz(data)
    header = json.loads(bytes(z[_HEADER_KEY]).decode())
    if header.get("version") != SOLVE_WIRE_VERSION:
        raise ValueError(
            f"unsupported solve wire version {header.get('version')}"
        )
    if not header["available"]:
        return None
    return [
        (bool(ok), int(n), float(p))
        for ok, n, p in zip(z["ok"], z["n_new"], z["price_lb"])
    ]
