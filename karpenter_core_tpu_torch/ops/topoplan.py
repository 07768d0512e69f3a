"""Host-side planner lowering topology constraints to device tensors.

The reference evaluates spread/affinity/anti-affinity per pod per node
(topologygroup.go:181-342: nextDomainTopologySpread / nextDomainAffinity /
nextDomainAntiAffinity over per-group domain counters). Here each group
becomes device count state — a per-slot count plane for hostname-keyed
groups (every slot IS a hostname domain) and a count vector over the label
vocab for label-keyed groups — and each class step derives its admissible
domains / per-slot take caps from that state inside the FFD scan
(ops/ffd.py). The planner's job:

* collect the solve's TopologyGroups (own + inverse), split hostname vs
  label-keyed, and build the per-class owner/sel incidence matrices
  (owner = the group CONSTRAINS the class, matching
  topology.go:400-414 _matching_topologies; sel = the group COUNTS the
  class's placements, matching TopologyGroup.counts:121-124);
* decide device eligibility per class — the dominant shapes (zone/hostname
  spread, hostname anti-affinity, zone/hostname affinity) run in-kernel;
  the exotic rest (non-trivial spread node filters, self-selecting
  label-keyed anti-affinity, multiple self-selecting spreads on one key,
  hostPort pods) fall back to the host loop;
* expand each self-selecting label-spread class into one sub-step per
  admissible domain; the kernel water-fills the class's pods across the
  sub-steps' domains from the live counts (the batched equivalent of the
  reference's per-pod min-count domain selection).

Deliberate batching deviations from pod-at-a-time semantics (documented
here, exercised by tests/test_device_topology.py): a class's pods place as
one atomic batch, so "skew holds at each pod's placement instant" becomes
"skew holds at each class boundary"; host-fallback classes place after all
device classes rather than interleaved by size. Both preserve the parity
contract (final-state constraint satisfaction + node-count parity vs the
greedy oracle).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (
    TYPE_AFFINITY,
    TYPE_ANTI_AFFINITY,
    TYPE_SPREAD,
    Topology,
    TopologyGroup,
)
from karpenter_core_tpu_torch.solver.snapshot import PodClass

TYPE_CODE = {TYPE_SPREAD: 0, TYPE_ANTI_AFFINITY: 1, TYPE_AFFINITY: 2}

# sentinel "no bound" for min-domains / ranks
NO_MIN_DOMAINS = -1
RANK_NONE = 1 << 30

# topoaware (ISSUE 20): sentinel domain id for slots/templates with no
# rack attribution — the kernel treats them as the farthest level
TOPO_UNKNOWN = -1


def _trivial_node_filter(group: TopologyGroup) -> bool:
    return all(len(alt) == 0 for alt in group.node_filter.alternatives)


class GangZoneGroup:
    """Synthetic zone-keyed affinity group (gangsched, ISSUE 10): every
    member of a same-zone pod group co-locates in ONE topology zone.

    Duck-types the TopologyGroup surface finalize_arrays consults (key /
    domains / max_skew / min_domains / selects / is_owned_by) and lowers to
    the kernel's existing type-2 (affinity) count state: the first member
    class bootstraps on the first name-ranked admissible zone, pinning its
    slots' zone row to that single value; every later member then sees
    exactly one count>0 domain. No new kernel code — the co-location term
    IS an extra mask tensor over the zone vocab, by construction."""

    type = TYPE_AFFINITY
    max_skew = 1 << 30  # affinity ignores skew
    min_domains = None
    key = apilabels.LABEL_TOPOLOGY_ZONE

    def __init__(self, gang_name: str, member_uids, zone_domains):
        from karpenter_core_tpu_torch.solver.gangs import pod_gang_sig

        self._sig = pod_gang_sig
        self.gang_name = gang_name
        self._uids = frozenset(member_uids)
        self.domains = {z: 0 for z in sorted(zone_domains)}
        self.empty_domains = set(self.domains)

    def selects(self, pod) -> bool:
        g = self._sig(pod)
        return g is not None and g[0] == self.gang_name

    def is_owned_by(self, uid) -> bool:
        return uid in self._uids


def _gang_zone_groups(classes: List[PodClass], topo: Topology) -> list:
    """One GangZoneGroup per same-zone gang present in the class list.
    Requires a non-empty zone domain universe (no zones → nothing to
    co-locate in; the gang simply packs without the synthetic term)."""
    zones = topo.domains.get(apilabels.LABEL_TOPOLOGY_ZONE, ())
    if not zones:
        return []
    # same_zone ORs across members (solver/gangs.collect_gangs contract):
    # every class of a flagged gang joins the group, or an unflagged
    # member would be counted (selects matches by name) yet never pinned
    flagged = {
        g[0]
        for cls in classes
        if (g := getattr(cls, "gang", None)) is not None and g[2]
    }
    by_name: Dict[str, List] = {}
    for cls in classes:
        g = getattr(cls, "gang", None)
        if g is not None and g[0] in flagged:
            by_name.setdefault(g[0], []).extend(p.uid for p in cls.pods)
    return [
        GangZoneGroup(name, uids, zones)
        for name, uids in sorted(by_name.items())
    ]


@dataclass
class DeviceGroup:
    """One topology group lowered to device state."""

    group: TopologyGroup
    inverse: bool  # lives in topo.inverse_topologies
    type_code: int  # 0 spread / 1 anti / 2 affinity
    key: str


@dataclass
class StepSpec:
    """One scan step: a class, optionally pinned to a water-fill domain."""

    class_idx: int  # index into the device class list
    sub_value: int = -1  # vocab value id of the pinned domain (-1: none)
    sub_first: bool = True
    sub_last: bool = True
    wf_group: int = -1  # label-group index driving the water-fill
    wf_key: int = -1  # vocab key id of that group
    zone_rest: Optional[np.ndarray] = None  # [V] bool — this + later domains


@dataclass
class TopoPlan:
    """Planner output. Gh/Gz are >= 1 (padded with a neutral group)."""

    host_groups: List[DeviceGroup]
    label_groups: List[DeviceGroup]
    # groups that cannot be modeled device-side but count device classes;
    # decode re-counts their contributions host-side per (class, slot)
    host_only_groups: List[TopologyGroup]
    device_classes: List[PodClass]
    fallback_classes: List[PodClass]
    fallback_reasons: Dict[int, str]  # id(cls) -> reason
    steps: List[StepSpec]
    # device arrays (filled by finalize_arrays once the vocab is frozen)
    h_type: Optional[np.ndarray] = None  # [Gh] int32
    h_skew: Optional[np.ndarray] = None  # [Gh] int32
    h_sel: Optional[np.ndarray] = None  # [C, Gh] bool
    h_owner: Optional[np.ndarray] = None  # [C, Gh] bool
    z_type: Optional[np.ndarray] = None  # [Gz] int32
    z_skew: Optional[np.ndarray] = None  # [Gz] int32
    z_key: Optional[np.ndarray] = None  # [Gz] int32 vocab key id
    z_mindom: Optional[np.ndarray] = None  # [Gz] int32 (NO_MIN_DOMAINS none)
    z_sel: Optional[np.ndarray] = None  # [C, Gz] bool
    z_owner: Optional[np.ndarray] = None  # [C, Gz] bool
    z_domains: Optional[np.ndarray] = None  # [Gz, V] bool registered universe
    z_rank: Optional[np.ndarray] = None  # [Gz, V] int32 name-sorted rank
    zcount0: Optional[np.ndarray] = None  # [Gz, V] int32 existing-pod counts

    @property
    def Gh(self) -> int:
        return max(len(self.host_groups), 1)

    @property
    def Gz(self) -> int:
        return max(len(self.label_groups), 1)

    def has_device_topology(self) -> bool:
        return bool(self.host_groups or self.label_groups)


def _class_groups(
    cls: PodClass, topo: Topology
) -> Tuple[List[TopologyGroup], List[TopologyGroup]]:
    """(owned groups, inverse groups that constrain this class). Inverse
    groups constrain pods their selector counts (topology.go:400-414)."""
    rep = cls.pods[0]
    owned = [g for g in topo.topologies.values() if g.is_owned_by(rep.uid)]
    inv = [g for g in topo.inverse_topologies.values() if g.selects(rep)]
    return owned, inv


def _eligibility(
    cls: PodClass, owned: List[TopologyGroup], inv: List[TopologyGroup]
) -> Tuple[bool, str, Optional[TopologyGroup]]:
    """Device-representability of a class's constraints. Returns
    (eligible, reason, water-fill group or None)."""
    rep = cls.pods[0]
    if rep.host_ports:
        return False, "hostPort pod with topology constraints", None
    wf: Optional[TopologyGroup] = None
    label_keys_owned: Set[str] = set()
    for g in owned + inv:
        if g.type == TYPE_SPREAD and not _trivial_node_filter(g):
            return False, f"non-trivial spread node filter on {g.key}", None
        if g.key == apilabels.LABEL_HOSTNAME:
            continue
        self_sel = g.selects(rep)
        if g.type == TYPE_ANTI_AFFINITY and self_sel:
            return False, f"self-selecting label anti-affinity on {g.key}", None
        if g.type == TYPE_SPREAD and self_sel:
            if wf is not None:
                return False, "multiple self-selecting label spreads", None
            if g.key in label_keys_owned:
                return False, f"label spread + other group on {g.key}", None
            wf = g
        elif g.key in ({wf.key} if wf is not None else set()):
            return False, f"label spread + other group on {g.key}", None
        label_keys_owned.add(g.key)
    return True, "", wf


def plan_topology(classes: List[PodClass], topo: Topology) -> TopoPlan:
    """Phase A: group collection + per-class eligibility + step expansion
    skeleton (sub-steps are expanded in finalize_arrays when value ids are
    known). Call before the vocab freeze; feed observe_domains() into it."""
    all_groups: List[DeviceGroup] = []
    for g in topo.topologies.values():
        all_groups.append(DeviceGroup(g, False, TYPE_CODE[g.type], g.key))
    for g in topo.inverse_topologies.values():
        all_groups.append(DeviceGroup(g, True, TYPE_CODE[g.type], g.key))
    # synthetic same-zone gang co-location groups (gangsched, ISSUE 10):
    # lowered as ordinary zone-keyed affinity count state; they live only
    # in the plan (never in topo), so the host fallback path is unaware —
    # the atomicity backstop (solver/gangs.enforce_atomicity) covers the
    # decode-divergence edge where a member re-places host-side
    gang_groups = _gang_zone_groups(classes, topo)
    for g in gang_groups:
        all_groups.append(DeviceGroup(g, False, TYPE_CODE[g.type], g.key))

    # groups whose counting/constraining cannot run device-side at all
    host_only = [
        dg.group
        for dg in all_groups
        if dg.group.type == TYPE_SPREAD and not _trivial_node_filter(dg.group)
    ]
    host_only_ids = {id(g) for g in host_only}
    device_groups = [dg for dg in all_groups if id(dg.group) not in host_only_ids]

    host_groups = [dg for dg in device_groups if dg.key == apilabels.LABEL_HOSTNAME]
    label_groups = [dg for dg in device_groups if dg.key != apilabels.LABEL_HOSTNAME]

    device_classes: List[PodClass] = []
    fallback_classes: List[PodClass] = []
    reasons: Dict[int, str] = {}
    wf_by_class: Dict[int, Optional[TopologyGroup]] = {}
    for cls in classes:
        owned, inv = _class_groups(cls, topo)
        if not owned and not inv:
            device_classes.append(cls)
            wf_by_class[id(cls)] = None
            continue
        if any(id(g) in host_only_ids for g in owned):
            fallback_classes.append(cls)
            reasons[id(cls)] = "owns a host-only (node-filtered) group"
            continue
        ok, reason, wf = _eligibility(cls, owned, inv)
        if (
            ok
            and wf is not None
            and wf.key == apilabels.LABEL_TOPOLOGY_ZONE
            and any(g.selects(cls.pods[0]) for g in gang_groups)
        ):
            # a zone water-fill spread and the synthetic same-zone gang
            # affinity fight over one key row — the same conflict
            # _eligibility rejects for real groups, applied here because
            # synthetic groups bypass the owned/inv collection
            ok, reason = False, "zone spread + same-zone gang on one key"
        if ok:
            device_classes.append(cls)
            wf_by_class[id(cls)] = wf
        else:
            fallback_classes.append(cls)
            reasons[id(cls)] = reason

    # Ordering-inversion guard: fallback classes place AFTER the device
    # scan, but a label-keyed anti-affinity OWNER placed in-kernel with an
    # uncommitted key records every value its slot could take
    # (topology.go:541-542 semantics), blocking selected fallback pods the
    # greedy order schedules first. Pull such owners into the fallback set
    # (to fixpoint — moves can cascade) so the whole interacting set
    # resolves in host order.
    label_anti_groups = [
        g
        for g in list(topo.topologies.values())
        + list(topo.inverse_topologies.values())
        if g.type == TYPE_ANTI_AFFINITY and g.key != apilabels.LABEL_HOSTNAME
    ]
    anti_owned_by_class = {
        id(cls): [
            g for g in label_anti_groups if g.is_owned_by(cls.pods[0].uid)
        ]
        for cls in device_classes
    } if label_anti_groups else {}
    moved = bool(anti_owned_by_class)
    while moved:
        moved = False
        fb_reps = [c.pods[0] for c in fallback_classes]
        if not fb_reps:
            break
        for cls in list(device_classes):
            anti_owned = anti_owned_by_class.get(id(cls), ())
            if any(
                g.selects(fr) for g in anti_owned for fr in fb_reps
            ):
                device_classes.remove(cls)
                fallback_classes.append(cls)
                reasons[id(cls)] = (
                    "label anti-affinity owner interacts with a fallback class"
                )
                wf_by_class.pop(id(cls), None)
                moved = True

    plan = TopoPlan(
        host_groups=host_groups,
        label_groups=label_groups,
        host_only_groups=host_only,
        device_classes=device_classes,
        fallback_classes=fallback_classes,
        fallback_reasons=reasons,
        steps=[],
    )
    plan._wf_by_class = wf_by_class  # type: ignore[attr-defined]
    return plan


def observe_domains(plan: TopoPlan, vocab) -> None:
    """Intern every label-group key + registered domain so the frozen vocab
    covers the closed world of topology domains (provisioner.go:251-283)."""
    for dg in plan.label_groups:
        vocab.key_id(dg.key)
        for domain in dg.group.domains:
            vocab.value_id(dg.key, domain)


def finalize_arrays(plan: TopoPlan, frozen, topo: Topology) -> None:
    """Phase B: lower groups to arrays over the frozen vocab and expand
    water-fill sub-steps. Mutates plan in place."""
    C = len(plan.device_classes)
    Gh, Gz, V = plan.Gh, plan.Gz, frozen.V

    plan.h_type = np.zeros((Gh,), dtype=np.int32)
    plan.h_skew = np.zeros((Gh,), dtype=np.int32)
    plan.h_sel = np.zeros((C, Gh), dtype=bool)
    plan.h_owner = np.zeros((C, Gh), dtype=bool)
    plan.z_type = np.zeros((Gz,), dtype=np.int32)
    plan.z_skew = np.zeros((Gz,), dtype=np.int32)
    plan.z_key = np.zeros((Gz,), dtype=np.int32)
    plan.z_mindom = np.full((Gz,), NO_MIN_DOMAINS, dtype=np.int32)
    plan.z_sel = np.zeros((C, Gz), dtype=bool)
    plan.z_owner = np.zeros((C, Gz), dtype=bool)
    plan.z_domains = np.zeros((Gz, V), dtype=bool)
    plan.z_rank = np.full((Gz, V), RANK_NONE, dtype=np.int32)
    plan.zcount0 = np.zeros((Gz, V), dtype=np.int32)

    for gi, dg in enumerate(plan.host_groups):
        plan.h_type[gi] = dg.type_code
        plan.h_skew[gi] = min(dg.group.max_skew, 1 << 30)
    for gi, dg in enumerate(plan.label_groups):
        g = dg.group
        plan.z_type[gi] = dg.type_code
        plan.z_skew[gi] = min(g.max_skew, 1 << 30)
        kid = frozen.keys[dg.key]
        plan.z_key[gi] = kid
        if g.min_domains is not None:
            plan.z_mindom[gi] = g.min_domains
        vmap = frozen.values[kid]
        for rank, domain in enumerate(sorted(g.domains)):
            vid = vmap.get(domain)
            if vid is None:
                continue  # domain outside the closed world never matters
            plan.z_domains[gi, vid] = True
            plan.z_rank[gi, vid] = rank
            plan.zcount0[gi, vid] = g.domains[domain]

    wf_by_class = plan._wf_by_class  # type: ignore[attr-defined]
    label_index = {id(dg.group): gi for gi, dg in enumerate(plan.label_groups)}

    for ci, cls in enumerate(plan.device_classes):
        rep = cls.pods[0]
        owned, inv = _class_groups(cls, topo)
        owned_ids = {id(g) for g in owned}
        for gi, dg in enumerate(plan.host_groups):
            sel = dg.group.selects(rep)
            if dg.inverse:
                # inverse groups: owners RECORD (sel side), selected pods
                # are CONSTRAINED (owner side) — topology.go:244-269,545-547
                plan.h_sel[ci, gi] = id(dg.group) in owned_ids or (
                    dg.group.is_owned_by(rep.uid)
                )
                plan.h_owner[ci, gi] = sel
            else:
                plan.h_sel[ci, gi] = sel
                plan.h_owner[ci, gi] = id(dg.group) in owned_ids
        for gi, dg in enumerate(plan.label_groups):
            sel = dg.group.selects(rep)
            if dg.inverse:
                plan.z_sel[ci, gi] = dg.group.is_owned_by(rep.uid)
                plan.z_owner[ci, gi] = sel
            else:
                plan.z_sel[ci, gi] = sel
                # the is_owned_by disjunct is identity for real groups
                # (owned_ids was built from it) and the ONLY ownership
                # route for synthetic gang groups, which live outside
                # topo.topologies
                plan.z_owner[ci, gi] = (
                    id(dg.group) in owned_ids
                    or dg.group.is_owned_by(rep.uid)
                )

    # --- step expansion ---------------------------------------------------
    steps: List[StepSpec] = []
    for ci, cls in enumerate(plan.device_classes):
        wf = wf_by_class.get(id(cls))
        if wf is None or id(wf) not in label_index:
            steps.append(StepSpec(class_idx=ci))
            continue
        gi = label_index[id(wf)]
        kid = int(plan.z_key[gi])
        # admissible domains: group universe ∧ the pod's STRICT admissible
        # values for the key (pod_domains in topologygroup.go:181-227)
        strict = cls.strict_requirements.get(wf.key)
        vids = [
            vid
            for vid in np.nonzero(plan.z_domains[gi])[0]
            if strict.has(frozen.value_names[kid][vid])
        ]
        # sorted-name order (the reference's tie-break iteration order)
        vids.sort(key=lambda vid: int(plan.z_rank[gi, vid]))
        if not vids:
            # no admissible domain at all: single unsatisfiable step (the
            # kernel sees an empty domain row and reports all pods unplaced)
            steps.append(
                StepSpec(
                    class_idx=ci,
                    wf_group=gi,
                    wf_key=kid,
                    sub_value=-1,
                    zone_rest=np.zeros((V,), dtype=bool),
                )
            )
            continue
        rest = np.zeros((V,), dtype=bool)
        rest[vids] = True
        for i, vid in enumerate(vids):
            zr = rest.copy()
            steps.append(
                StepSpec(
                    class_idx=ci,
                    sub_value=int(vid),
                    sub_first=(i == 0),
                    sub_last=(i == len(vids) - 1),
                    wf_group=gi,
                    wf_key=kid,
                    zone_rest=zr,
                )
            )
            rest[vid] = False
    plan.steps = steps


# -- the network-topology catalog (topoaware, ISSUE 20) ----------------------
# Rack/ICI-adjacency lowering: the `topology.karpenter.sh/rack` (+ optional
# `…/superpod`) label hierarchy on existing nodes and nodeclaim templates
# becomes (a) a small per-domain-pair hop matrix and (b) per-slot /
# per-template domain ids. models/provisioner._prepare_gangsched picks one
# ANCHOR domain per gang and gathers hop-from-anchor rows as the kernel's
# per-step topo_rank planes (ops/ffd level-grouped fill); ops/relax gets the
# same matrix as a class×template cost plane. The hop METRIC itself is
# solver/gangs.hop_distance — one definition across kernel, verifier, twin
# and bench.


@dataclass
class RackPlan:
    """The lowered rack catalog for one solve's slot axis."""

    # sorted distinct (zone, superpod, rack) triples over attributable
    # existing nodes and templates ("" where a level's label is absent)
    domains: List[Tuple[str, str, str]]
    hop: np.ndarray  # [D, D] int32 pairwise hop distance
    slot_domain: np.ndarray  # [N] int32 domain id, TOPO_UNKNOWN elsewhere
    tmpl_domain: np.ndarray  # [S] int32 domain id per template


def _labels_of_triple(t: Tuple[str, str, str]) -> Dict[str, str]:
    zone, superpod, rack = t
    out: Dict[str, str] = {}
    if zone:
        out[apilabels.LABEL_TOPOLOGY_ZONE] = zone
    if superpod:
        out[apilabels.LABEL_TOPOLOGY_SUPERPOD] = superpod
    if rack:
        out[apilabels.LABEL_TOPOLOGY_RACK] = rack
    return out


def _triple_of_labels(labels) -> Optional[Tuple[str, str, str]]:
    """(zone, superpod, rack) of one label dict, or None when the rack
    label is absent — a node without a rack is unattributable and never
    joins the catalog (soundness over completeness)."""
    labels = labels or {}
    rack = labels.get(apilabels.LABEL_TOPOLOGY_RACK)
    if not rack:
        return None
    return (
        labels.get(apilabels.LABEL_TOPOLOGY_ZONE) or "",
        labels.get(apilabels.LABEL_TOPOLOGY_SUPERPOD) or "",
        rack,
    )


def plan_racks(
    node_labels: List[Dict[str, str]],
    template_labels: List[Dict[str, str]],
    n_slots: int,
) -> Optional[RackPlan]:
    """Lower the rack hierarchy for one solve. ``node_labels`` carries one
    label dict per existing-node slot (slots [0, E)); ``template_labels``
    one per nodeclaim template (single-valued rack/superpod/zone
    requirement values, already resolved by the caller). Returns None when
    NO entity carries a rack label — the topoaware subsystem stays fully
    disengaged and every downstream plane keeps its parity-neutral
    all-zeros default."""
    from karpenter_core_tpu_torch.solver import gangs as gangmod

    triples: List[Tuple[str, str, str]] = []
    seen: Set[Tuple[str, str, str]] = set()
    node_triples = [_triple_of_labels(l) for l in node_labels]
    tmpl_triples = [_triple_of_labels(l) for l in template_labels]
    for t in node_triples + tmpl_triples:
        if t is not None and t not in seen:
            seen.add(t)
            triples.append(t)
    if not triples:
        return None
    triples.sort()
    index = {t: i for i, t in enumerate(triples)}
    D = len(triples)
    hop = np.zeros((D, D), dtype=np.int32)
    for i, a in enumerate(triples):
        la = _labels_of_triple(a)
        for j in range(i + 1, D):
            d = gangmod.hop_distance(la, _labels_of_triple(triples[j]))
            hop[i, j] = hop[j, i] = d
    slot_domain = np.full((n_slots,), TOPO_UNKNOWN, dtype=np.int32)
    for si, t in enumerate(node_triples[:n_slots]):
        if t is not None:
            slot_domain[si] = index[t]
    tmpl_domain = np.array(
        [TOPO_UNKNOWN if t is None else index[t] for t in tmpl_triples],
        dtype=np.int32,
    )
    return RackPlan(
        domains=triples, hop=hop, slot_domain=slot_domain,
        tmpl_domain=tmpl_domain,
    )


def gang_anchors(
    rplan: RackPlan,
    gang_names: List[str],
    gang_sizes: List[int],
) -> Dict[str, int]:
    """One anchor domain per gang: greedily the domain whose NEIGHBORHOOD
    absorbs the gang's demand at the smallest hop radius (capacity proxy:
    one pod per slot), with each gang's demand then debited across that
    neighborhood in hop order — the same nearest-first order the level
    fill consumes slots in — so a later gang sees the headroom an earlier
    gang's spill already claimed and anchors in a different superpod (or
    zone) instead of stacking onto one. Ties break on local headroom,
    then sorted domain order; a catalog with no racked existing slots
    anchors on template domains the same way. Pure heuristic — the hard
    bound is enforced post-hoc (solver/gangs.enforce_distance) and
    re-derived by the verifier, so a bad anchor can cost optimality,
    never correctness."""
    from karpenter_core_tpu_torch.solver.gangs import MAX_HOP_DISTANCE

    D = len(rplan.domains)
    headroom = np.zeros((D,), dtype=np.int64)
    for d in rplan.slot_domain:
        if d >= 0:
            headroom[int(d)] += 1
    tmpl_only = not headroom.any()
    if tmpl_only:
        for d in rplan.tmpl_domain:
            if d >= 0:
                headroom[int(d)] += 1
    out: Dict[str, int] = {}
    for name, size in zip(gang_names, gang_sizes):
        need = max(int(size), 1)
        best, best_key = 0, None
        for a in range(D):
            # hop radius at which this anchor's neighborhood absorbs the
            # demand (nearest-first, stable = sorted domain order within
            # a hop level, mirroring the kernel's level-grouped fill)
            order = np.argsort(rplan.hop[a], kind="stable")
            remaining, radius = need, MAX_HOP_DISTANCE + 1
            for d in order:
                remaining -= int(headroom[int(d)])
                if remaining <= 0:
                    radius = int(rplan.hop[a, int(d)])
                    break
            key = (radius, -int(headroom[a]), a)
            if best_key is None or key < best_key:
                best, best_key = a, key
        out[name] = best
        remaining = need
        for d in np.argsort(rplan.hop[best], kind="stable"):
            take = min(remaining, int(headroom[int(d)]))
            headroom[int(d)] -= take
            remaining -= take
            if remaining <= 0:
                break
    return out


def hop_from_anchor(rplan: RackPlan, anchor: int,
                    max_hop: int) -> np.ndarray:
    """[N] int32 hop distance of every slot's domain from the anchor,
    clipped to max_hop; unattributable slots sit at the ceiling. This row
    IS a gang class's topo_rank plane (ops/ffd): level 0 slots fill
    first, then 1, then 2, …"""
    out = np.full(rplan.slot_domain.shape, max_hop, dtype=np.int32)
    known = rplan.slot_domain >= 0
    out[known] = np.minimum(
        rplan.hop[anchor, rplan.slot_domain[known]], max_hop
    )
    return out


def initial_hcounts(plan: TopoPlan, slot_names: List[str], n_slots: int) -> np.ndarray:
    """[Gh, N] counts seeded from each group's live domain counters for the
    existing-node slots (hostname domain == slot). Hostnames with counts but
    no slot never constrain a slot, and hostname min floats at zero
    (topologygroup.go:235-238), so they are safely dropped."""
    out = np.zeros((plan.Gh, n_slots), dtype=np.int32)
    for gi, dg in enumerate(plan.host_groups):
        domains = dg.group.domains
        for si, name in enumerate(slot_names):
            cnt = domains.get(name)
            if cnt:
                out[gi, si] = cnt
    return out
