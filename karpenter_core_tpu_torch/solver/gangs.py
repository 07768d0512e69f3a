"""Priority & gang scheduling: the host half of the gangsched subsystem.

The device half lives in ops/gangsched.py (tier-ordered packing with
gang-atomic commit and a vmapped preemption pass); this module owns
everything that is pure object algebra:

* the pod-group ANNOTATION CONTRACT — how a pod declares its gang, the
  gang's min-count, and its co-location wishes (same zone / same node
  template), modeled on the sig-scheduling PodGroup conventions the
  rank-aware MPI scheduling line of work rides on ("Rank-Aware Resource
  Scheduling for MPI on Kubernetes", PAPERS.md);
* GangSpec assembly over the solve's pod classes (one gang = one or more
  equivalence classes — solver/snapshot.group_pods splits classes on the
  gang signature, so membership is a class property);
* gang-atomicity ENFORCEMENT over a finished ``Results`` — the backstop
  behind the kernel's on-device rollback: any decode-time divergence that
  leaves a gang below its min-count strips the partial placement and
  reports the whole group unschedulable (the verifier rejects partially
  materialized gangs, so this runs before verification on every path);
* the TIERED-GREEDY-WITH-PREEMPTION host fallback: when a gang/priority
  solve degrades off the device path (sidecar down, verification
  rejection), the greedy re-solve still packs tiers high→low, keeps gangs
  atomic, and may still evict strictly-lower-tier bound pods — degraded
  means slower, not semantically different.

Everything here is import-light (no jax): the wire codec reads the
annotation constants and solver/snapshot reads the gang signature at
class-grouping time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.objects import Pod
from karpenter_core_tpu_torch.utils import resources as resutil
from karpenter_core_tpu_torch.utils.disruption import priority_tier

# -- the pod-group annotation contract --------------------------------------
# One annotation names the gang; the optional companions shape it. All six
# ride ObjectMeta.annotations, so they survive the solve wire unchanged
# (kube/serial encodes the full metadata).
GANG_ANNOTATION = "scheduling.karpenter.sh/pod-group"
# minimum pods that must place for the gang to commit (coscheduling
# minMember); absent/0 → the whole group is the minimum
GANG_MIN_SIZE_ANNOTATION = "scheduling.karpenter.sh/pod-group-min-size"
# co-location: members must land in one topology zone (lowered to a
# synthetic zone-affinity group in ops/topoplan.py)
GANG_SAME_ZONE_ANNOTATION = "scheduling.karpenter.sh/pod-group-same-zone"
# co-location: members' fresh nodes must come from one nodeclaim template
# (lowered to a joint template mask in ops/masks.gang_joint_templates)
GANG_SAME_TEMPLATE_ANNOTATION = (
    "scheduling.karpenter.sh/pod-group-same-node-template"
)
# topoaware (ISSUE 20): HARD ceiling on the intra-gang network distance —
# the max pairwise hop count (see hop_distance below) any two placed
# members may span. Absent → no hard bound, the solver still PREFERS
# near placements (soft semantics); present → a placement provably above
# the bound strips like an atomicity violation and the verifier rejects
# forged ones with the typed `gang_distance` reason.
GANG_MAX_HOPS_ANNOTATION = "scheduling.karpenter.sh/pod-group-max-hops"
# topoaware (ISSUE 20): the pod's rank within its gang (MPI-style).
# Per-POD, deliberately NOT part of pod_gang_sig — ranks must not fragment
# the equivalence-class collapse. Rank only permutes WHICH interchangeable
# pod object lands in WHICH already-chosen slot (rank_order_pods), so
# rank-adjacent pods land network-adjacent.
GANG_RANK_ANNOTATION = "scheduling.karpenter.sh/pod-group-rank"

_TRUE = ("true", "1", "yes")

# The hop metric's ceiling: same rack 0, same superpod 1, same zone 2,
# anything else (or unknown) 3. ops/ffd.TOPO_LEVELS is MAX_HOP_DISTANCE+1
# — the kernel's level-grouped fill buckets slots by this distance.
MAX_HOP_DISTANCE = 3

# generous per-pod rank ceiling — far below int32, so a clamped rank can
# ride any int32 plane without overflow games
_RANK_MAX = 1 << 20


def gang_rank(value: int) -> int:
    """Range-normalize a (possibly hostile, wire-supplied) pod-group rank
    into [0, 2^20]. Registered in graftlint's GL601 normalizer registry:
    every decode-net int that can reach an int32 plane must pass through
    one of these (the PR 11 eviction-priority precedent)."""
    return min(max(int(value), 0), _RANK_MAX)


def gang_max_hops(value: int) -> int:
    """Range-normalize a wire-supplied max-hops bound into
    [0, MAX_HOP_DISTANCE]. A bound at the ceiling constrains nothing —
    exactly right for hostile over-large ints. GL601-registered like
    gang_rank."""
    return min(max(int(value), 0), MAX_HOP_DISTANCE)

# -- device-side gang sentinels ----------------------------------------------
# The gang_of_class / gang_of_step planes (models/provisioner, consumed by
# ops/gangsched) carry a gang index >= 0 for kernel-enforced gangs and one
# of two NEGATIVE sentinels below. The two are NOT interchangeable: a
# ``< 0`` test conflates them, and the preemption pass must gate on
# GANG_FREE exactly — evicting real workload to place a member of a
# fallback-straddling gang could strand eviction claims if the host
# atomicity backstop (enforce_atomicity) strips the gang. One definition
# here (the module both halves already import); graftlint GL602 seeds its
# sentinel-domain registry from GANG_SENTINELS, so sentinel-confusing
# comparisons fail lint instead of review.
GANG_FREE = -1  # class belongs to no gang at all
GANG_FALLBACK_STRADDLING = -2  # member of a gang the host backstop enforces

# domain-registry view consumed by tools/graftlint/rules/rangecheck.py
GANG_SENTINELS = {
    "gang-free": GANG_FREE,
    "fallback-straddling": GANG_FALLBACK_STRADDLING,
}


def pod_gang_sig(pod: Pod) -> Optional[tuple]:
    """The gang signature of one pod: (name, min_size, same_zone,
    same_template, max_hops), or None for gang-free pods. Part of the
    class signature (solver/snapshot._spec_signature), so two pods
    differing in any component land in different classes. max_hops is
    None when the annotation is absent (soft-preference semantics) —
    NOT 0, which would be the tightest hard bound. The per-pod rank
    deliberately stays OUT of the signature (pod_gang_rank)."""
    ann = pod.metadata.annotations or {}
    name = ann.get(GANG_ANNOTATION)
    if not name:
        return None
    raw_min = ann.get(GANG_MIN_SIZE_ANNOTATION, "0")
    try:
        min_size = max(int(raw_min), 0)
    except (TypeError, ValueError):
        min_size = 0
    same_zone = str(ann.get(GANG_SAME_ZONE_ANNOTATION, "")).lower() in _TRUE
    same_template = (
        str(ann.get(GANG_SAME_TEMPLATE_ANNOTATION, "")).lower() in _TRUE
    )
    raw_hops = ann.get(GANG_MAX_HOPS_ANNOTATION)
    max_hops: Optional[int] = None
    if raw_hops is not None:
        try:
            max_hops = gang_max_hops(int(str(raw_hops).strip()))
        except (TypeError, ValueError):
            max_hops = None  # malformed → soft, never a surprise bound
    return (name, min_size, same_zone, same_template, max_hops)


def pod_gang_rank(pod: Pod) -> Optional[int]:
    """The pod's declared rank within its gang, clamped (gang_rank), or
    None when absent/malformed. Per-pod, never part of the class
    signature."""
    ann = pod.metadata.annotations or {}
    raw = ann.get(GANG_RANK_ANNOTATION)
    if raw is None:
        return None
    try:
        return gang_rank(int(str(raw).strip()))
    except (TypeError, ValueError):
        return None


def pod_tier(pod: Pod) -> int:
    return priority_tier(pod.priority)


def has_gangsched(pods: Sequence[Pod]) -> bool:
    """Does this pod set engage the gangsched machinery at all? The
    off-by-default contract hangs on this being False for plain problems:
    when it is, the solve dispatches the exact pre-gang kernels and
    produces byte-identical result wires."""
    return any(
        pod_tier(p) != 0 or pod_gang_sig(p) is not None for p in pods
    )


def degraded_solve(make_scheduler, pods: Sequence[Pod], existing_nodes=(),
                   gangsched=None):
    """THE greedy degradation entry, shared by every fallback seam (device
    verify-failure, sidecar RPC failure/quarantine): problems carrying
    priorities/gangs route through the tiered-greedy-with-preemption
    wrapper so degraded means slower, never semantically different.
    ``gangsched`` carries an already-computed has_gangsched verdict; None
    rescans."""
    if gangsched is None:
        gangsched = has_gangsched(pods)
    if gangsched:
        return host_gang_solve(make_scheduler, pods, existing_nodes)
    return make_scheduler().solve(pods)


@dataclass(frozen=True)
class GangSpec:
    """One pod group as the solver sees it."""

    name: str
    min_count: int  # resolved: max declared min, or the full size when 0
    same_zone: bool
    same_template: bool
    class_indices: Tuple[int, ...]  # indices into the solve's class list
    total: int  # pods across member classes
    # strictest declared hop bound across members (min), None when no
    # member declares one — soft preference only
    max_hops: Optional[int] = None


def collect_gangs(classes) -> List[GangSpec]:
    """Assemble GangSpecs from the solve's PodClass list (classes carry
    .gang — the pod_gang_sig tuple — and .count). Min-count resolves to
    the largest declared min across members, defaulting to the full group
    size (all-or-nothing); co-location flags OR across members (any member
    asking for co-location binds the gang); the hop bound resolves to the
    STRICTEST declared (min across members) — a bound binds the gang the
    way co-location does."""
    by_name: Dict[str, dict] = {}
    for ci, cls in enumerate(classes):
        g = getattr(cls, "gang", None)
        if g is None:
            continue
        name, min_size, same_zone, same_template, max_hops = g
        e = by_name.setdefault(
            name,
            {"min": 0, "zone": False, "tmpl": False, "cis": [], "total": 0,
             "hops": None},
        )
        e["min"] = max(e["min"], min_size)
        e["zone"] = e["zone"] or same_zone
        e["tmpl"] = e["tmpl"] or same_template
        if max_hops is not None:
            e["hops"] = (
                max_hops if e["hops"] is None else min(e["hops"], max_hops)
            )
        e["cis"].append(ci)
        e["total"] += cls.count
    out: List[GangSpec] = []
    for name in sorted(by_name):
        e = by_name[name]
        min_count = e["min"] if e["min"] > 0 else e["total"]
        out.append(
            GangSpec(
                name=name,
                min_count=min(min_count, e["total"]) or e["total"],
                same_zone=e["zone"],
                same_template=e["tmpl"],
                class_indices=tuple(e["cis"]),
                total=e["total"],
                max_hops=e["hops"],
            )
        )
    return out


def gang_members(pods: Sequence[Pod]) -> Dict[str, List[Pod]]:
    out: Dict[str, List[Pod]] = {}
    for p in pods:
        g = pod_gang_sig(p)
        if g is not None:
            out.setdefault(g[0], []).append(p)
    return out


def gang_min_count(pods: Sequence[Pod]) -> int:
    """Resolved min-count for one gang's member pods (same rule as
    collect_gangs, usable by the verifier without classes)."""
    declared = max((pod_gang_sig(p)[1] for p in pods), default=0)
    return declared if 0 < declared <= len(pods) else len(pods)


def gang_max_hops_for(pods: Sequence[Pod]) -> Optional[int]:
    """Resolved hard hop bound for one gang's member pods (strictest
    declared, same rule as collect_gangs), None when no member declares
    one. Usable by the verifier without classes."""
    vals = [
        g[4]
        for p in pods
        if (g := pod_gang_sig(p)) is not None and g[4] is not None
    ]
    return min(vals) if vals else None


# -- the network-hop metric (topoaware, ISSUE 20) ----------------------------
# Distance between two placements from their topology labels alone:
#   same rack      -> 0   (one ICI/ToR domain)
#   same superpod  -> 1   (one spine block)
#   same zone      -> 2
#   else / unknown -> 3   (MAX_HOP_DISTANCE)
# Pure object algebra over label dicts — the kernel's per-slot hop planes
# (ops/topoplan), the verifier's re-derivation (solver/verify), the twin
# monitor and the bench all call THESE, so the four layers cannot drift.

_TOPO_LABEL_KEYS = (
    apilabels.LABEL_TOPOLOGY_RACK,
    apilabels.LABEL_TOPOLOGY_SUPERPOD,
    apilabels.LABEL_TOPOLOGY_ZONE,
)


def hop_distance(a, b) -> int:
    """Pairwise hop distance between two label dicts; unknown levels are
    pessimistic (a missing label can only RAISE the reported distance).
    Use for reporting (ledger/bench); rejection paths must use the sound
    lower bound (placement_hop_bound) instead."""
    a = a or {}
    b = b or {}
    ra, rb = a.get(_TOPO_LABEL_KEYS[0]), b.get(_TOPO_LABEL_KEYS[0])
    if ra and rb and ra == rb:
        return 0
    sa, sb = a.get(_TOPO_LABEL_KEYS[1]), b.get(_TOPO_LABEL_KEYS[1])
    if sa and sb and sa == sb:
        return 1
    za, zb = a.get(_TOPO_LABEL_KEYS[2]), b.get(_TOPO_LABEL_KEYS[2])
    if za and zb and za == zb:
        return 2
    return MAX_HOP_DISTANCE


def placement_hop_bound(labels_list) -> int:
    """PROVABLE max pairwise hop distance over a gang's placements —
    sound for rejection: never overestimates, so a missing label can
    never manufacture a violation. Soundness over completeness:
    placements without a rack label are unattributable and skipped
    entirely; among the attributable rest, a level only raises the bound
    when both sides carry the level's label and they DIFFER."""
    att = [l or {} for l in labels_list
           if (l or {}).get(_TOPO_LABEL_KEYS[0])]
    if len(att) <= 1:
        return 0
    zones = {l[_TOPO_LABEL_KEYS[2]] for l in att
             if l.get(_TOPO_LABEL_KEYS[2])}
    if len(zones) > 1:
        return MAX_HOP_DISTANCE
    sps = {l[_TOPO_LABEL_KEYS[1]] for l in att
           if l.get(_TOPO_LABEL_KEYS[1])}
    if len(sps) > 1:
        return 2
    racks = {l[_TOPO_LABEL_KEYS[0]] for l in att}
    return 1 if len(racks) > 1 else 0


def topo_sort_key(labels) -> tuple:
    """Network-nearness grouping key: placements sorting adjacent under
    this key share zone, then superpod, then rack. The one ordering
    rank_order_pods (below), the kernel's level planes and the host
    fallback all derive from."""
    labels = labels or {}
    return (
        labels.get(_TOPO_LABEL_KEYS[2]) or "",
        labels.get(_TOPO_LABEL_KEYS[1]) or "",
        labels.get(_TOPO_LABEL_KEYS[0]) or "",
    )


def claim_topo_labels(claim) -> Dict[str, str]:
    """Topology attribution for a fresh nodeclaim: a level counts only
    when the claim's requirements pin it to a SINGLE value (the
    verifier's zone-attribution rule, extended down the hierarchy)."""
    out: Dict[str, str] = {}
    reqs = getattr(claim, "requirements", None)
    if reqs is None:
        return out
    for key in _TOPO_LABEL_KEYS:
        req = reqs.get(key)
        if req is None:
            continue
        vals = req.sorted_values()
        if len(vals) == 1:
            out[key] = vals[0]
    return out


def gang_adjacent_order(items, tier_of, gang_name_of) -> list:
    """THE gangsched packing order, over any item type: stable
    tier-descending with gang members adjacent, anchored at each gang's
    first occurrence. One implementation serves the kernel's class sort
    (models/provisioner._sorted_classes) and the host fallback's pod sort
    (tier_sorted) so the two layers can never drift apart."""
    first_seen: Dict[str, int] = {}
    for i, it in enumerate(items):
        g = gang_name_of(it)
        if g is not None and g not in first_seen:
            first_seen[g] = i

    def key(ii):
        i, it = ii
        g = gang_name_of(it)
        return (-tier_of(it), first_seen[g] if g is not None else i, i)

    return [it for _i, it in sorted(enumerate(items), key=key)]


def tier_sorted(pods: Sequence[Pod]) -> List[Pod]:
    """Stable tier-descending order with gang members kept adjacent
    (members place back to back so co-location state is warm)."""
    def gang_name(p):
        g = pod_gang_sig(p)
        return None if g is None else g[0]

    return gang_adjacent_order(pods, pod_tier, gang_name)


# -- atomicity enforcement over a finished Results --------------------------


def enforce_atomicity(results, pods: Sequence[Pod]) -> List[str]:
    """Strip partially-materialized gangs from a Results in place and
    report every member unschedulable. Returns the violated gang names.

    The kernel already rolls failed gangs back on device; this is the
    decode/fallback backstop — a member class that diverged through the
    host repair path and failed can leave its gang-mates placed, and the
    verifier treats that as a hard violation. Stripped groups leave their
    request accounting on the claim/sim (stale HIGH — conservative: the
    packing stays valid, capacity is never understated)."""
    members = gang_members(pods)
    if not members:
        return []
    errors = results.pod_errors
    violated: List[str] = []
    for name, mpods in members.items():
        min_count = gang_min_count(mpods)
        uids = {p.uid for p in mpods}
        placed = sum(
             1
             for group in _placement_groups(results)
             for p in group
             if p.uid in uids
        )
        if placed == 0 or placed >= min_count:
            continue
        violated.append(name)
        spec_msg = (
            f"pod group {name!r} placed {placed}/{len(mpods)} below"
            f" min-count {min_count} — gang unschedulable"
        )
        for claim in list(results.new_node_claims):
            claim.pods = [p for p in claim.pods if p.uid not in uids]
            if not claim.pods:
                claim.destroy()
                results.new_node_claims.remove(claim)
        for sim in results.existing_nodes:
            sim.pods = [p for p in sim.pods if p.uid not in uids]
        for p in mpods:
            errors[p.uid] = spec_msg
    return violated


def _placement_groups(results):
    for claim in results.new_node_claims:
        yield claim.pods
    for sim in results.existing_nodes:
        yield sim.pods


# -- topoaware post-passes over a finished Results (ISSUE 20) ----------------


def enforce_distance(results, pods: Sequence[Pod],
                     node_labels=None) -> List[str]:
    """Strip gangs whose placement PROVABLY exceeds their declared hard
    hop bound, exactly like enforce_atomicity strips partial gangs:
    members come off every claim/sim, the whole group reports
    unschedulable, and the request accounting stays stale-HIGH
    (conservative). Uses placement_hop_bound — sound, so a cluster
    without rack labels can never trip a bound — which is also why the
    verifier's independent gang_distance check never fires on results
    that passed through here. Returns the violated gang names.

    ``node_labels`` maps existing-node name → label dict (the caller's
    view of the cluster); fresh claims attribute via claim_topo_labels."""
    members = gang_members(pods)
    if not members:
        return []
    node_labels = node_labels or {}
    errors = results.pod_errors
    violated: List[str] = []
    for name, mpods in sorted(members.items()):
        bound = gang_max_hops_for(mpods)
        if bound is None or bound >= MAX_HOP_DISTANCE:
            continue  # soft preference only — nothing to enforce
        uids = {p.uid for p in mpods}
        lab = []
        for claim in results.new_node_claims:
            if any(p.uid in uids for p in claim.pods):
                lab.append(claim_topo_labels(claim))
        for sim in results.existing_nodes:
            if any(p.uid in uids for p in sim.pods):
                lab.append(dict(node_labels.get(sim.name) or {}))
        worst = placement_hop_bound(lab)
        if worst <= bound:
            continue
        violated.append(name)
        spec_msg = (
            f"pod group {name!r} placement spans {worst} network hops,"
            f" above the declared max-hops bound {bound} — gang"
            f" unschedulable"
        )
        for claim in list(results.new_node_claims):
            claim.pods = [p for p in claim.pods if p.uid not in uids]
            if not claim.pods:
                claim.destroy()
                results.new_node_claims.remove(claim)
        for sim in results.existing_nodes:
            sim.pods = [p for p in sim.pods if p.uid not in uids]
        for p in mpods:
            errors[p.uid] = spec_msg
    return violated


def rank_order_pods(results, pods: Sequence[Pod], node_labels=None) -> None:
    """Rank-ordered slot assignment within each gang, as a Results-level
    permutation: pods of one equivalence class are interchangeable in
    every check the solve ran, so re-choosing WHICH member object sits in
    WHICH of the class's already-placed slots preserves the packing,
    capacity accounting, evictions — everything. Placement groups sort
    network-near-first (topo_sort_key) and each class's members deal into
    their slots in rank order, so rank-adjacent pods land
    network-adjacent. Gangs with no ranked member are left byte-identical
    (the off-by-default parity contract); runs AFTER any repair/repack
    pass that moves pods between groups."""
    members = gang_members(pods)
    if not members:
        return
    ranked = {
        name
        for name, mp in members.items()
        if any(pod_gang_rank(p) is not None for p in mp)
    }
    if not ranked:
        return
    from karpenter_core_tpu_torch.solver.snapshot import _spec_signature

    node_labels = node_labels or {}
    groups: List[tuple] = []
    for gi, claim in enumerate(results.new_node_claims):
        groups.append(
            (topo_sort_key(claim_topo_labels(claim)), 0, gi, claim)
        )
    for gi, sim in enumerate(results.existing_nodes):
        groups.append(
            (topo_sort_key(node_labels.get(sim.name)), 1, gi, sim)
        )
    groups.sort(key=lambda g: (g[0], g[1], g[2]))
    for name in sorted(ranked):
        uids = {p.uid for p in members[name]}
        # slots per equivalence class, enumerated in topo-sorted group
        # order (label_aware=True is always sound: at least as fine as
        # the grouping the solve used)
        by_cls: Dict[tuple, List[tuple]] = {}
        for _key, _kind, _gi, grp in groups:
            for idx, p in enumerate(grp.pods):
                if p.uid in uids:
                    by_cls.setdefault(
                        _spec_signature(p, True), []
                    ).append((grp, idx))
        for slots in by_cls.values():
            placed = [grp.pods[idx] for grp, idx in slots]
            order = sorted(
                range(len(placed)),
                key=lambda i: (
                    0 if pod_gang_rank(placed[i]) is not None else 1,
                    pod_gang_rank(placed[i]) or 0,
                    i,
                ),
            )
            for (grp, idx), oi in zip(slots, order):
                grp.pods[idx] = placed[oi]


def prune_evictions(results) -> None:
    """Drop eviction claims that no longer enable anything: a node whose
    kernel-planned placements all diverged off it at decode time would
    otherwise carry a dangling claim the verifier rejects as illegal
    preemption. Only the trivially-safe prune runs here (no placed pods on
    the node → the claim is pure cost, never load-bearing for capacity);
    a node that kept SOME placements keeps its claims — if a rare
    divergence made one illegal, verification rejects the solve and the
    tiered fallback re-derives evictions from scratch."""
    ev = getattr(results, "evictions", None)
    if not ev:
        return
    placed_nodes = {sim.name for sim in results.existing_nodes if sim.pods}
    for node in list(ev):
        if node not in placed_nodes:
            del ev[node]


# -- the tiered-greedy-with-preemption fallback ------------------------------


def host_gang_solve(make_scheduler, pods: Sequence[Pod], existing_nodes=()):
    """Degraded-path solve that preserves gangsched semantics.

    ``make_scheduler`` builds ONE fresh greedy Scheduler (the caller's
    usual fallback construction); the solve then runs band-by-band in
    tier-descending order over that single instance — higher tiers claim
    capacity first, exactly the kernel's packing order, because the greedy
    queue's own cpu/memory sort is tier-blind. Claims and existing-node
    sims accumulate across bands (each ``solve`` call packs into the
    remaining capacity); errors merge across bands. Gang atomicity is then
    enforced post-hoc and a simple host preemption pass serves any
    still-unplaced positive-tier pods from ``existing_nodes``' evictable
    capacity, mirroring the kernel's cheapest-strictly-lower-tier rule."""
    tiers = sorted({pod_tier(p) for p in pods}, reverse=True)
    scheduler = make_scheduler()
    if len(tiers) <= 1:
        results = scheduler.solve(tier_sorted(pods))
    else:
        by_tier: Dict[int, List[Pod]] = {}
        for p in pods:
            by_tier.setdefault(pod_tier(p), []).append(p)
        errors: Dict[str, str] = {}
        results = None
        for t in tiers:
            results = scheduler.solve(tier_sorted(by_tier[t]))
            errors.update(results.pod_errors)
        results.pod_errors = errors
    enforce_atomicity(results, pods)
    node_labels = {
        n.name: getattr(n, "labels", None) or {} for n in existing_nodes
    }
    enforce_distance(results, pods, node_labels)
    _host_preempt(results, pods, existing_nodes)
    # rank permutation LAST: preemption may add gang-free pods but never
    # moves gang members, so the ordering survives it — degraded path and
    # device decode share the identical post-pass (slower, never different)
    rank_order_pods(results, pods, node_labels)
    return results


def _host_preempt(results, pods: Sequence[Pod], existing_nodes) -> None:
    """Place still-unschedulable positive-tier, gang-free pods onto
    existing nodes by evicting the cheapest strictly-lower-tier bound pods
    (SimNode.evictable), recording the eviction set on the results. One
    node per pod, minimal-cost prefix per node, minimal-cost node across
    nodes — the host twin of ops/gangsched.preempt_pass. The placement
    itself runs through ExistingNodeSim.add, so preemption enforces every
    admission check the greedy path does (taints, host ports, volume
    attach limits, requirements, topology) — the eviction only buys
    capacity, never a bypass."""
    from karpenter_core_tpu_torch.controllers.provisioning.scheduling.inflight import (
        IncompatibleError,
    )

    if not existing_nodes:
        return
    errors = results.pod_errors
    if not errors:
        return
    by_uid = {p.uid: p for p in pods}
    cand = [
        by_uid[uid]
        for uid in list(errors)
        if uid in by_uid
        and pod_tier(by_uid[uid]) > 0
        and pod_gang_sig(by_uid[uid]) is None
    ]
    if not cand:
        return
    cand.sort(key=lambda p: -pod_tier(p))
    evictions = getattr(results, "evictions", None)
    if evictions is None:
        return  # a Results shape without the eviction channel
    sims_by_name = {s.name: s for s in results.existing_nodes}
    evicted: set = set()
    for pod in cand:
        t = pod_tier(pod)
        req = resutil.requests_for_pods(pod)
        # (cost, seq, node, prefix of EvictablePod, freed, sim) per node
        candidates: List[tuple] = []
        for seq, node in enumerate(existing_nodes):
            sim = sims_by_name.get(node.name)
            if sim is None:
                # the greedy Scheduler sims every existing node it was
                # built with; a node outside that set has no admission
                # ledger, and preemption must never place without one
                continue
            # the sim's own ledger: requests grows per placement, the
            # freed credit of earlier preemptions rides cached_available
            total = resutil.merge(sim.requests, req)
            if resutil.fits(total, sim.cached_available):
                # fits in an earlier preemption's overshoot residual with
                # zero evictions — cost 0, exactly the kernel's bonus-carry
                # admission (add() below still enforces every check greedy
                # failed this pod on). Reachable only after a prior
                # eviction freed this capacity: greedy itself packed the
                # pristine ledgers.
                candidates.append((0.0, seq, node, [], {}, sim))
                continue
            victims = sorted(
                (
                    e
                    for e in getattr(node, "evictable", ())
                    if e.uid not in evicted and priority_tier(e.priority) < t
                ),
                key=lambda e: (e.cost, e.uid),
            )
            if not victims:
                continue
            prefix: List = []
            freed: dict = {}
            fits = False
            for e in victims:
                prefix.append(e)
                freed = resutil.merge(freed, e.requests)
                if resutil.fits(
                    total, resutil.merge(sim.cached_available, freed)
                ):
                    fits = True
                    break
            if not fits:
                continue
            cost = sum(e.cost for e in prefix)
            candidates.append((cost, seq, node, prefix, freed, sim))
        # cheapest node first; an add() rejection (port conflict, attach
        # limit, topology) reverts the credit and tries the next node, so
        # a requirements-incompatible cheap node never shadows a viable
        # eviction elsewhere
        for _cost, _seq, node, prefix, freed, sim in sorted(
            candidates, key=lambda c: (c[0], c[1])
        ):
            before_avail = dict(sim.cached_available)
            sim.cached_available = resutil.merge(sim.cached_available, freed)
            try:
                sim.add(pod, req)
            except IncompatibleError:
                sim.cached_available = before_avail
                continue
            for e in prefix:
                evicted.add(e.uid)
            if prefix:
                evictions.setdefault(node.name, []).extend(
                    e.uid for e in prefix
                )
            errors.pop(pod.uid, None)
            break
