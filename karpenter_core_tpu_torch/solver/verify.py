"""ResultVerifier: the host-side trust anchor over every solve result.

Constraint-based packing is only safe when the output provably satisfies
the hard constraints ("Priority Matters", PAPERS.md): the operator turns a
``Results`` into NodeClaims and pod bindings, so a corrupt wire result, a
solver bug, or a future optimizing backend (CvxCluster-style relaxation
behind the Solver seam, ROADMAP item 4) that hands back an infeasible
assignment would otherwise reach the cluster unchecked. This module is a
cheap, INDEPENDENT re-check of every hard constraint over the final
assignment — it shares no code with the device kernels and none of the
solver's incremental state, which is what makes it a trust anchor rather
than a second copy of the bug.

Checked invariants (one ``Violation`` per breach, reason-coded):

* ``conservation``  — every input pod lands exactly once OR is reported
                      unschedulable; never both, never neither
* ``double_place``  — a pod appears in two placement groups
* ``structure``     — unknown pod uids, empty fresh claims, instance-type
                      options outside the claim's pool catalog
* ``capacity``      — per-node arithmetic: daemonset overhead (recomputed
                      independently per template) + the group's pod
                      requests must fit at least one surviving instance-
                      type option (fresh claims) / the node's available
                      (existing nodes)
* ``taint``         — every pod tolerates its node's NoSchedule/NoExecute
                      taints (PreferNoSchedule is soft: relaxation may
                      legitimately add the toleration solver-side)
* ``selector``      — node selector / volume zone pins / required node
                      affinity are compatible with the group's
                      requirements or labels (a zone-pinned pod on a
                      claim bound to another zone fails here)
* ``anti_affinity`` — required hostname pod-anti-affinity: no co-located
                      pod matches the term's selector
* ``spread``        — DoNotSchedule topology-spread bounds: hostname
                      spreads bound the per-node count by maxSkew; zone
                      spreads bound max-min over the eligible domains
* ``offering``      — every fresh claim retains at least one available,
                      requirement-compatible offering outside the ICE
                      snapshot (a packing onto stocked-out capacity is a
                      guaranteed create→ICE→delete round)
* ``eviction``      — preemption legality (gangsched, ISSUE 10): every
                      eviction claim's victim is strictly lower tier
                      (utils/disruption.priority_tier) than some pod its
                      freed capacity admitted on that node; a claim that
                      admits nothing is a dangling drain for free
* ``eviction_unknown`` — an eviction claim naming a node outside the solve
                      input or a uid outside that node's evictable set —
                      the operator would drain a pod the solve never saw
* ``gang``          — gang atomicity: a pod group is fully placed (its
                      min-count) or fully unschedulable; a partially
                      materialized gang deadlocks the workload while
                      holding capacity

The pass is O(pods) with per-class dedup: constraint checks depend only on
a pod's spec equivalence class (solver/snapshot._spec_signature), so each
(group, class) pair is checked once and 50k-pod solves verify in
milliseconds, not a second greedy re-solve. Relaxation-aware: only
relax-IMMUNE requirements are enforced (preferences.py can strip preferred
terms, ScheduleAnyway spreads, and all-but-one required affinity term
solver-side, and a sidecar relaxes ITS pod copies, not the caller's), so a
legitimately relaxed result never false-positives — the fuzz-parity suite
pins that guarantee across every seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from karpenter_core_tpu_torch.api import labels as apilabels
from karpenter_core_tpu_torch.api.objects import (
    RESOURCE_PODS,
    TAINT_EFFECT_PREFER_NO_SCHEDULE,
    Pod,
)
from karpenter_core_tpu_torch.scheduling import Requirements, Taints
from karpenter_core_tpu_torch.scheduling.requirements import (
    ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
)
from karpenter_core_tpu_torch.utils import resources as resutil

# capacity comparisons tolerate fixed-point/quantization noise exactly like
# the fuzz-parity invariant checker: a relative ULP band plus an absolute
# floor for tiny quantities
_REL_TOL = 1e-9
_ABS_TOL = 1e-6

REASONS = (
    "conservation",
    "double_place",
    "structure",
    "capacity",
    "taint",
    "selector",
    "anti_affinity",
    "spread",
    "offering",
    "eviction",
    "eviction_unknown",
    "gang",
    "gang_distance",
)


@dataclass
class Violation:
    reason: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.reason}] {self.detail}"


def _fits_with_tolerance(requests: dict, allocatable: dict) -> bool:
    return all(
        qty <= allocatable.get(name, 0.0) * (1 + _REL_TOL) + _ABS_TOL
        for name, qty in requests.items()
    )


def _hard_taints(taints) -> Taints:
    """NoSchedule/NoExecute only: PreferNoSchedule is soft by k8s semantics
    and the relaxation loop may have added the toleration to the SOLVER's
    pod copy (preferences.py), which a sidecar never ships back."""
    return Taints(
        t for t in taints if t.effect != TAINT_EFFECT_PREFER_NO_SCHEDULE
    )


def _immune_requirements(pod: Pod) -> Requirements:
    """The relax-immune half of a pod's scheduling requirements: node
    selector + PVC-derived zone pins. Required node-affinity terms are
    checked separately (any-term: relaxation pops terms from the front but
    can never invent one)."""
    reqs = Requirements.from_labels(pod.node_selector)
    if pod.volume_requirements:
        reqs.add(
            *Requirements.from_node_selector_requirements(
                pod.volume_requirements
            ).values()
        )
    return reqs


def _affinity_term_sets(pod: Pod) -> List[Requirements]:
    """One Requirements per required node-affinity term (terms are OR'd:
    the solver satisfied SOME term, and relaxation only removes terms, so
    a sound check is 'compatible with at least one')."""
    na = pod.affinity.node_affinity if pod.affinity else None
    if na is None or not na.required:
        return []
    return [
        Requirements.from_node_selector_requirements(t.match_expressions)
        for t in na.required
    ]


class _ClassCheck:
    """Per-spec-class cached views (the dedup that keeps the verifier
    O(classes) on the constraint half)."""

    __slots__ = (
        "requests", "immune_reqs", "affinity_alts", "pod",
        "anti_terms", "spread_hard",
    )

    def __init__(self, pod: Pod):
        self.pod = pod
        self.requests = resutil.requests_for_pods(pod)
        self.immune_reqs = _immune_requirements(pod)
        self.affinity_alts = _affinity_term_sets(pod)
        anti = pod.affinity.pod_anti_affinity if pod.affinity else None
        # required hostname anti-affinity only: zone-level anti-affinity
        # needs cross-group attribution the cheap pass doesn't attempt
        self.anti_terms = [
            t for t in (anti.required if anti else [])
            if t.topology_key == apilabels.LABEL_HOSTNAME
            and t.label_selector is not None
        ]
        # DoNotSchedule spreads are relax-immune (only ScheduleAnyway is
        # ever stripped)
        self.spread_hard = [
            c for c in pod.topology_spread_constraints
            if c.when_unsatisfiable == "DoNotSchedule"
        ]


class ResultVerifier:
    """One verifier per solve world (the same constructor inputs every
    scheduler takes), reusable across that world's results."""

    def __init__(
        self,
        nodepools,
        instance_types: Dict[str, list],
        existing_nodes=None,
        daemonset_pods=None,
        topology=None,
        unavailable_offerings: "frozenset | set" = frozenset(),
    ):
        self.nodepools = list(nodepools)
        self.instance_types = instance_types
        self.existing_by_name = {n.name: n for n in (existing_nodes or [])}
        self.daemonset_pods = list(daemonset_pods or [])
        self.topology = topology
        self.unavailable_offerings = frozenset(unavailable_offerings)
        self._pool_catalog_names = {
            pool: {it.name for it in its}
            for pool, its in instance_types.items()
        }
        # daemon overhead per template is recomputed here, independently of
        # the solver's own cache — _daemon_compatible is the shared oracle
        self._overhead_by_pool: Dict[str, dict] = {}
        # zone universe for spread bounds: every zone some nodepool could
        # actually create capacity in, plus existing nodes' zones
        self._zone_universe = self._zones()

    def _zones(self) -> set:
        """The zone half of the solver's own domain universe (the domains
        the greedy/device Topology enforces skew against): pool-intersected
        instance-type zones plus existing nodes' zones — NOT the raw
        offering zones, which a pool restriction may forbid."""
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.topology import (
            domain_universe,
        )

        zones = set(
            domain_universe(self.nodepools, self.instance_types).get(
                apilabels.LABEL_TOPOLOGY_ZONE, set()
            )
        )
        for node in self.existing_by_name.values():
            z = node.labels.get(apilabels.LABEL_TOPOLOGY_ZONE)
            if z:
                zones.add(z)
        return zones

    def _overhead(self, template) -> dict:
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.scheduler import (
            _daemon_compatible,
        )

        cached = self._overhead_by_pool.get(template.nodepool_name)
        if cached is None:
            cached = resutil.requests_for_pods(*[
                p for p in self.daemonset_pods
                if _daemon_compatible(template, p)
            ])
            self._overhead_by_pool[template.nodepool_name] = cached
        return cached

    # -- the pass ----------------------------------------------------------

    def verify(self, results, pods: List[Pod]) -> List[Violation]:
        """All violations in one result (empty list = trusted). ``pods``
        is the exact solve input — conservation is defined against it."""
        out: List[Violation] = []
        class_cache: Dict[tuple, _ClassCheck] = {}
        # two-level cache: the signature is itself ~µs/pod, so repeat
        # lookups for the same pod object (capacity, anti-affinity, and
        # spread passes all touch every pod) hit the id() level instead
        pod_cache: Dict[int, _ClassCheck] = {}

        def check_of(pod: Pod) -> _ClassCheck:
            from karpenter_core_tpu_torch.solver.snapshot import _spec_signature

            got = pod_cache.get(id(pod))
            if got is not None:
                return got
            sig = _spec_signature(pod, True)
            got = class_cache.get(sig)
            if got is None:
                got = class_cache[sig] = _ClassCheck(pod)
            pod_cache[id(pod)] = got
            return got

        # conservation is tracked by OBJECT IDENTITY: both the inproc and
        # the materialized (sidecar) paths bind the caller's own Pod
        # objects into the result, so id() is a uid read that costs a
        # pointer — the uid property (3 string attribute hops per read ×
        # 150k reads at 50k pods) only gets touched on the failure paths,
        # and the counting itself runs in C (Counter over map(id, ...))
        from collections import Counter
        from itertools import chain

        known_ids = set(map(id, pods))

        groups = []  # (label, group_requirements, group_labels, pods, kind)
        for i, claim in enumerate(results.new_node_claims):
            groups.append((f"claim[{i}]", claim, None, claim.pods, "claim"))
        for sim in results.existing_nodes:
            node = self.existing_by_name.get(sim.name)
            if node is None:
                if sim.pods:
                    out.append(Violation(
                        "structure",
                        f"existing node {sim.name!r} is not part of the"
                        " solve input",
                    ))
                continue
            groups.append((f"node[{sim.name}]", sim, node, sim.pods, "node"))

        placed = Counter(chain.from_iterable(
            map(id, group_pods) for _l, _g, _n, group_pods, _k in groups
        ))
        unknown = set(placed) - known_ids
        if unknown:
            for label, _g, _n, group_pods, _k in groups:
                for p in group_pods:
                    if id(p) in unknown:
                        out.append(Violation(
                            "structure",
                            f"{label} places unknown pod uid {p.uid!r}",
                        ))

        # eviction-claim capacity credit (gangsched, ISSUE 10): placements
        # on a node with eviction claims assume the victims' freed
        # capacity (the operator drains before binding), so the capacity
        # check must see it — but ONLY capacity a claim can actually free
        # (uids resolved against the node's own evictable set; legality
        # and unknown-uid violations are reported by _verify_gangsched)
        ev_credit = self._eviction_credit(results)

        for label, group, node, group_pods, kind in groups:
            if kind == "claim" and not group_pods:
                out.append(Violation(
                    "structure", f"{label} holds no pods (a node for free)"
                ))
            if kind == "claim":
                out.extend(self._verify_claim(label, group, check_of))
            else:
                out.extend(self._verify_existing(
                    label, node, group, check_of,
                    credit=ev_credit.get(node.name),
                ))

        # conservation: exactly-once XOR reported unschedulable
        errors = results.pod_errors
        pget = placed.get
        for p in pods:
            n = pget(id(p), 0)
            if n == 1:
                if errors and p.uid in errors:
                    out.append(Violation(
                        "conservation",
                        f"pod {p.metadata.name!r} both placed and reported"
                        f" unschedulable ({errors[p.uid]!r})",
                    ))
            elif n > 1:
                out.append(Violation(
                    "double_place",
                    f"pod {p.metadata.name!r} placed {n} times",
                ))
            elif not errors or p.uid not in errors:
                out.append(Violation(
                    "conservation",
                    f"pod {p.metadata.name!r} neither placed nor reported"
                    " unschedulable",
                ))

        # fast exit for the constraint-free bulk path (the 50k plain-pod
        # shape): every result pod is in pod_cache by now, so one scan of
        # the CLASS cache tells whether any spread work exists at all
        if any(c.spread_hard for c in class_cache.values()):
            out.extend(self._verify_spread(results, check_of))
        out.extend(self._verify_gangsched(results, pods, placed))
        return out

    # -- gangsched claims (ISSUE 10) ---------------------------------------

    def _eviction_credit(self, results) -> Dict[str, dict]:
        """Per-node freed capacity from the result's eviction claims —
        resolved against each node's OWN evictable set so a forged uid
        can never mint capacity (it reports eviction_unknown instead)."""
        evictions = getattr(results, "evictions", None)
        if not evictions:
            return {}
        credit: Dict[str, dict] = {}
        for node_name, uids in evictions.items():
            node = self.existing_by_name.get(node_name)
            if node is None:
                continue
            ev_by_uid = {
                e.uid: e for e in getattr(node, "evictable", ()) or ()
            }
            freed = [
                ev_by_uid[u].requests for u in uids if u in ev_by_uid
            ]
            if freed:
                credit[node_name] = resutil.merge(*freed)
        return credit

    def _verify_gangsched(self, results, pods, placed) -> List[Violation]:
        """Eviction-claim legality + gang atomicity over the final
        assignment. Independent of the kernel: tiers re-derive through
        utils/disruption.priority_tier (the single tier ordering all
        three layers share) and gang membership re-derives from the pod
        annotations (solver/gangs), not from any solver state — which is
        also why the gang scan below runs unconditionally: any gate that
        skipped it would have to trust the solver's own "no gangs" claim.
        The price is one O(pods) annotation pass per verification."""
        from karpenter_core_tpu_torch.solver.gangs import (
            MAX_HOP_DISTANCE,
            claim_topo_labels,
            gang_max_hops_for,
            gang_members,
            gang_min_count,
            placement_hop_bound,
            pod_gang_rank,
            pod_gang_sig,
            topo_sort_key,
        )
        from karpenter_core_tpu_torch.utils.disruption import priority_tier

        out: List[Violation] = []
        evictions = getattr(results, "evictions", None) or {}
        if evictions:
            placed_on: Dict[str, list] = {}
            for sim in results.existing_nodes:
                placed_on.setdefault(sim.name, []).extend(sim.pods)
            for node_name, uids in sorted(evictions.items()):
                node = self.existing_by_name.get(node_name)
                if node is None:
                    out.append(Violation(
                        "eviction_unknown",
                        f"eviction claim targets node {node_name!r}"
                        " outside the solve input",
                    ))
                    continue
                ev_by_uid = {
                    e.uid: e for e in getattr(node, "evictable", ()) or ()
                }
                admitted = placed_on.get(node_name) or []
                # GANG-FREE admitted pods only: both preemption halves gate
                # on solver/gangs.GANG_FREE (device: gang_j == GANG_FREE;
                # host: pod_gang_sig(p) is None), so a claim whose only
                # positive-tier admitted pod is a gang member cannot be
                # legitimate preemption output — the eviction would be
                # serving a placement the atomicity backstop may strip
                max_tier = max(
                    (
                        priority_tier(p.priority)
                        for p in admitted
                        if pod_gang_sig(p) is None
                    ),
                    default=None,
                )
                if max_tier is None:
                    out.append(Violation(
                        "eviction",
                        f"eviction claim on {node_name!r} admits no placed"
                        " gang-free pod — a drain that enables nothing"
                        " preemption could have produced",
                    ))
                elif max_tier <= 0:
                    # the preemption pass serves POSITIVE tiers only: a
                    # claim on a node whose admitted pods are all tier<=0
                    # cannot be its output, whatever the victims' tiers —
                    # rejects forged claims riding an all-default solve
                    out.append(Violation(
                        "eviction",
                        f"eviction claim on {node_name!r} admits no"
                        f" positive-tier pod (max tier {max_tier}) —"
                        " preemption serves positive tiers only",
                    ))
                    max_tier = None  # victim checks below would be vacuous
                for uid in uids:
                    victim = ev_by_uid.get(uid)
                    if victim is None:
                        out.append(Violation(
                            "eviction_unknown",
                            f"eviction claim on {node_name!r} names uid"
                            f" {uid!r} outside the node's evictable set",
                        ))
                        continue
                    vt = priority_tier(victim.priority)
                    if max_tier is not None and vt >= max_tier:
                        out.append(Violation(
                            "eviction",
                            f"illegal preemption on {node_name!r}: victim"
                            f" {uid!r} (tier {vt}) is not strictly below"
                            f" any admitted pod (max tier {max_tier})",
                        ))
        members = gang_members(pods)
        colocated = any(
            (g := pod_gang_sig(p)) is not None and (g[2] or g[3])
            for mp in members.values()
            for p in mp
        )
        # zone / template attribution per placed pod, built only when a
        # gang declares co-location (O(placements) otherwise skipped)
        zone_of: Dict[int, str] = {}
        pool_of: Dict[int, str] = {}
        if colocated:
            for claim in results.new_node_claims:
                zr = claim.requirements.get(apilabels.LABEL_TOPOLOGY_ZONE)
                zvals = zr.sorted_values() if zr is not None else []
                for p in claim.pods:
                    pool_of[id(p)] = claim.template.nodepool_name
                    if len(zvals) == 1:
                        zone_of[id(p)] = zvals[0]
            for sim in results.existing_nodes:
                node = self.existing_by_name.get(sim.name)
                z = (node.labels or {}).get(
                    apilabels.LABEL_TOPOLOGY_ZONE
                ) if node is not None else None
                for p in sim.pods:
                    if z:
                        zone_of[id(p)] = z
        # network-topology attribution (topoaware, ISSUE 20): full topo
        # label dict per placed pod — a fresh claim attributes through its
        # single-valued requirements (claim_topo_labels, the zone rule
        # extended down the hierarchy), an existing node through its
        # labels. Built only when some gang declares a hop bound or
        # carries ranked members.
        topo_of: Dict[int, dict] = {}
        needs_topo = any(
            ((g := pod_gang_sig(p)) is not None and g[4] is not None)
            or pod_gang_rank(p) is not None
            for mp in members.values()
            for p in mp
        )
        if needs_topo:
            for claim in results.new_node_claims:
                lab = claim_topo_labels(claim)
                for p in claim.pods:
                    topo_of[id(p)] = lab
            for sim in results.existing_nodes:
                node = self.existing_by_name.get(sim.name)
                lab = dict(node.labels or {}) if node is not None else {}
                for p in sim.pods:
                    topo_of[id(p)] = lab
        for name, mpods in sorted(members.items()):
            bound = [p for p in mpods if placed.get(id(p), 0)]
            min_count = gang_min_count(mpods)
            if 0 < len(bound) < min_count:
                out.append(Violation(
                    "gang",
                    f"pod group {name!r} partially materialized:"
                    f" {len(bound)}/{len(mpods)} placed, below min-count"
                    f" {min_count} — a gang commits whole or not at all",
                ))
                continue
            if not bound:
                continue
            # co-location flags OR across members (collect_gangs contract)
            same_zone = any(
                (g := pod_gang_sig(p)) is not None and g[2] for p in mpods
            )
            same_tmpl = any(
                (g := pod_gang_sig(p)) is not None and g[3] for p in mpods
            )
            if same_zone:
                # soundness over completeness: only attributable members
                # (single-valued claim zone / labeled existing node) count
                zones = {
                    zone_of[id(p)] for p in bound if id(p) in zone_of
                }
                if len(zones) > 1:
                    out.append(Violation(
                        "gang",
                        f"pod group {name!r} declares same-zone but its"
                        f" members span zones {sorted(zones)}",
                    ))
            if same_tmpl:
                pools = {
                    pool_of[id(p)] for p in bound if id(p) in pool_of
                }
                if len(pools) > 1:
                    out.append(Violation(
                        "gang",
                        f"pod group {name!r} declares same-node-template"
                        f" but its fresh members span templates"
                        f" {sorted(pools)}",
                    ))
            # hard max-hops bound (topoaware, ISSUE 20), re-derived purely
            # from annotations + labels via the SOUND bound: only
            # attributable placements count and a level only raises the
            # bound when both sides carry it and differ — a cluster
            # without rack labels can never manufacture a violation
            # (soundness over completeness)
            max_hops = gang_max_hops_for(mpods)
            if max_hops is not None and max_hops < MAX_HOP_DISTANCE:
                worst = placement_hop_bound(
                    [topo_of.get(id(p)) for p in bound]
                )
                if worst > max_hops:
                    out.append(Violation(
                        "gang_distance",
                        f"pod group {name!r} placement provably spans"
                        f" {worst} network hops, above its declared"
                        f" max-hops bound {max_hops}",
                    ))
            # rank adjacency: within one equivalence class, members sorted
            # by rank must occupy rack-attributable placements in
            # non-decreasing network order (each domain holds one
            # contiguous rank run) — exactly what the solver-side
            # rank_order_pods permutation guarantees, re-derived here
            # from annotations + labels alone
            ranked = [p for p in bound if pod_gang_rank(p) is not None]
            if ranked:
                from karpenter_core_tpu_torch.solver.snapshot import (
                    _spec_signature,
                )

                by_cls: Dict[tuple, list] = {}
                for p in ranked:
                    lab = topo_of.get(id(p)) or {}
                    if not lab.get(apilabels.LABEL_TOPOLOGY_RACK):
                        continue  # unattributable: soundness first
                    by_cls.setdefault(_spec_signature(p, True), []).append(
                        (pod_gang_rank(p), topo_sort_key(lab))
                    )
                for pairs in by_cls.values():
                    pairs.sort()
                    keys = [k for _r, k in pairs]
                    if keys != sorted(keys):
                        out.append(Violation(
                            "gang_distance",
                            f"pod group {name!r} rank order is not"
                            " network-adjacent: rank-sorted members do"
                            " not occupy their topology domains as"
                            " contiguous runs",
                        ))
                        break
        return out

    # -- per-group checks --------------------------------------------------

    def _verify_claim(self, label, claim, check_of) -> List[Violation]:
        out: List[Violation] = []
        pool = claim.template.nodepool_name
        catalog_names = self._pool_catalog_names.get(pool)
        if catalog_names is None:
            return [Violation(
                "structure", f"{label} targets unknown nodepool {pool!r}"
            )]
        foreign = [
            it.name for it in claim.instance_type_options
            if it.name not in catalog_names
        ]
        if foreign:
            out.append(Violation(
                "structure",
                f"{label} offers instance types outside nodepool"
                f" {pool!r}'s catalog: {foreign[:3]}",
            ))
        if not claim.instance_type_options:
            out.append(Violation(
                "capacity", f"{label} retains no instance-type option"
            ))
            return out

        # capacity: independently recomputed daemon overhead + pod sums
        # (shared bucketing helper — see _bucket_group_pods)
        totals = dict(self._overhead(claim.template))
        hard_taints = _hard_taints(claim.template.taints)
        class_counts = self._bucket_group_pods(
            label, claim.pods, totals, hard_taints, check_of, out
        )
        for c, n in class_counts.values():
            for name, qty in c.requests.items():
                totals[name] = totals.get(name, 0.0) + qty * n
            out.extend(self._check_pod_on_claim(
                label, claim, c, hard_taints
            ))
        fits_one = any(
            _fits_with_tolerance(totals, it.allocatable())
            for it in claim.instance_type_options
        )
        if not fits_one:
            out.append(Violation(
                "capacity",
                f"{label} requests {resutil.to_string(totals)} exceed every"
                f" surviving option"
                f" ({[it.name for it in claim.instance_type_options][:3]})",
            ))
        out.extend(self._check_offerings(label, claim))
        if any(c.anti_terms for c, _n in class_counts.values()):
            out.extend(self._check_anti_affinity(
                label, claim.pods, check_of
            ))
        return out

    def _bucket_group_pods(
        self, label, group_pods, totals, hard_taints, check_of, out
    ) -> Dict[int, list]:
        """The shared 50k hot loop: split one group's pods into the
        constraint-free bulk (accumulated INLINE into ``totals`` — their
        only verifiable obligations are capacity and the group's hard
        taints, and the taint verdict is identical for every
        toleration-less pod so one representative check per group
        suffices) and the per-class machinery for everything else.
        Returns ``class_counts`` (id(_ClassCheck) -> [check, count]);
        the classes' requests are NOT yet folded into totals.

        The fast-path gate lists exactly the fields that change a
        VERIFIED obligation: affinity (selector/anti), tolerations, hard
        spreads, node selector, volume zone pins. host_ports/volumes are
        not checked by this pass, so they don't gate. One helper, two
        callers — a future checked field is added to ONE gate."""
        class_counts: Dict[int, list] = {}
        plain = 0
        plain_rep = None
        tget = totals.get  # bound locals: this loop IS the 50k hot path
        for p in group_pods:
            if (
                p.affinity is None
                and not p.tolerations
                and not p.topology_spread_constraints
                and not p.node_selector
                and not p.volume_requirements
            ):
                plain += 1
                plain_rep = p
                for name, qty in p.resource_requests.items():
                    totals[name] = tget(name, 0.0) + qty
                continue
            c = check_of(p)
            slot = class_counts.get(id(c))
            if slot is None:
                class_counts[id(c)] = [c, 1]
            else:
                slot[1] += 1
        if plain:
            totals[RESOURCE_PODS] = (
                totals.get(RESOURCE_PODS, 0.0) + float(plain)
            )
            if hard_taints:
                errs = hard_taints.tolerates(plain_rep)
                if errs:
                    out.append(Violation(
                        "taint",
                        f"{label}: {plain} toleration-less pods"
                        f" {'; '.join(errs)}",
                    ))
        return class_counts

    def _check_pod_on_claim(self, label, claim, c, hard_taints):
        out: List[Violation] = []
        errs = hard_taints.tolerates(c.pod)
        if errs:
            out.append(Violation(
                "taint",
                f"{label}: pod {c.pod.metadata.name!r} {'; '.join(errs)}",
            ))
        errs = claim.requirements.compatible(
            c.immune_reqs, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
        )
        if errs:
            out.append(Violation(
                "selector",
                f"{label}: pod {c.pod.metadata.name!r} selector/volume pins"
                f" incompatible: {errs}",
            ))
        if c.affinity_alts and not any(
            not claim.requirements.compatible(
                alt, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
            )
            for alt in c.affinity_alts
        ):
            out.append(Violation(
                "selector",
                f"{label}: pod {c.pod.metadata.name!r} satisfies none of"
                " its required node-affinity terms",
            ))
        return out

    def _verify_existing(
        self, label, node, sim, check_of, credit=None
    ) -> List[Violation]:
        from karpenter_core_tpu_torch.controllers.provisioning.scheduling.scheduler import (
            node_daemon_pods,
        )

        out: List[Violation] = []
        if not sim.pods:
            return out
        daemons = resutil.requests_for_pods(
            *node_daemon_pods(node, self.daemonset_pods)
        )
        base = resutil.subtract(daemons, node.daemon_requests)
        totals = {k: max(v, 0.0) for k, v in base.items()}
        hard_taints = _hard_taints(node.taints)
        node_reqs = Requirements.from_labels(node.labels)
        class_counts = self._bucket_group_pods(
            label, sim.pods, totals, hard_taints, check_of, out
        )
        for c, n in class_counts.values():
            p = c.pod
            for name, qty in c.requests.items():
                totals[name] = totals.get(name, 0.0) + qty * n
            errs = hard_taints.tolerates(p)
            if errs:
                out.append(Violation(
                    "taint",
                    f"{label}: pod {p.metadata.name!r} {'; '.join(errs)}",
                ))
            errs = node_reqs.compatible(c.immune_reqs)
            if errs:
                out.append(Violation(
                    "selector",
                    f"{label}: pod {p.metadata.name!r} selector/volume pins"
                    f" incompatible with node labels: {errs}",
                ))
            if c.affinity_alts and not any(
                not node_reqs.compatible(alt) for alt in c.affinity_alts
            ):
                out.append(Violation(
                    "selector",
                    f"{label}: pod {p.metadata.name!r} satisfies none of"
                    " its required node-affinity terms",
                ))
        # eviction claims free capacity on this node (drain-before-bind):
        # the credit was resolved against the node's own evictable set
        avail = (
            resutil.merge(dict(node.available), credit)
            if credit else node.available
        )
        if not _fits_with_tolerance(totals, avail):
            out.append(Violation(
                "capacity",
                f"{label} requests {resutil.to_string(totals)} exceed node"
                f" available {resutil.to_string(dict(avail))}",
            ))
        elif credit and _fits_with_tolerance(totals, node.available):
            # the claim must be LOAD-BEARING: a legitimate preemption only
            # fires when the placements could NOT fit the ordinary free
            # capacity (kernel and host twin both gate on it). A claim on
            # a node whose placements fit without the freed credit drains
            # real workload to enable nothing — the forged-claim shape a
            # tier comparison alone cannot catch (any higher-tier pod that
            # landed through ordinary capacity would legalize it).
            out.append(Violation(
                "eviction",
                f"{label}: eviction claim is not load-bearing — placed"
                f" requests {resutil.to_string(totals)} fit the node's own"
                f" available {resutil.to_string(dict(node.available))}",
            ))
        if any(c.anti_terms for c, _n in class_counts.values()):
            out.extend(self._check_anti_affinity(
                label, sim.pods, check_of
            ))
        return out

    def _check_offerings(self, label, claim) -> List[Violation]:
        """At least one option must keep an available, compatible offering
        outside the ICE snapshot — otherwise the launch is a guaranteed
        create→ICE→delete round the solve was supposed to route around."""
        for it in claim.instance_type_options:
            for o in it.offerings:
                if not o.available:
                    continue
                if o.key(it.name) in self.unavailable_offerings:
                    continue
                if not claim.requirements.intersects(o.requirements):
                    return []
        return [Violation(
            "offering",
            f"{label} retains no available offering compatible with its"
            " requirements outside the unavailable-offerings snapshot",
        )]

    def _check_anti_affinity(self, label, group_pods, check_of):
        out: List[Violation] = []
        if len(group_pods) < 2:
            return out
        for p in group_pods:
            c = check_of(p)
            for term in c.anti_terms:
                matches = sum(
                    1 for q in group_pods
                    if term.label_selector.matches(q.metadata.labels or {})
                )
                # the pod itself may match its own selector (self-anti):
                # any OTHER match on the same host is the violation
                own = 1 if term.label_selector.matches(
                    p.metadata.labels or {}
                ) else 0
                if matches > own or (own and matches > 1):
                    out.append(Violation(
                        "anti_affinity",
                        f"{label}: pod {p.metadata.name!r} co-located with"
                        " a pod matching its required hostname"
                        " anti-affinity selector",
                    ))
                    break
        return out

    # -- topology spread ---------------------------------------------------

    def _verify_spread(self, results, check_of) -> List[Violation]:
        """DoNotSchedule spread bounds over the FINAL assignment.

        hostname: a fresh hostname is always creatable, so the domain min
        floats at zero and each node's matching count is bounded by
        maxSkew. zone: counts aggregate over groups attributable to a
        single zone (claims pin one after a spread placement; existing
        nodes are labeled) plus the topology context's existing pods;
        max-min over the ELIGIBLE domains (the universe intersected with
        zones any matching pod could actually take) is bounded by maxSkew.
        Unattributable groups (multi-zone claims) skip the zone check for
        their constraints — soundness over completeness."""
        out: List[Violation] = []
        # collect the distinct hard constraints present in the result
        constraints = {}
        for claim in results.new_node_claims:
            for p in claim.pods:
                for cons in check_of(p).spread_hard:
                    constraints.setdefault(
                        (cons.topology_key, cons.label_selector,
                         cons.max_skew), cons
                    )
        for sim in results.existing_nodes:
            for p in sim.pods:
                for cons in check_of(p).spread_hard:
                    constraints.setdefault(
                        (cons.topology_key, cons.label_selector,
                         cons.max_skew), cons
                    )
        if not constraints:
            return out

        groups = []
        for i, claim in enumerate(results.new_node_claims):
            zone = None
            if claim.requirements.has(apilabels.LABEL_TOPOLOGY_ZONE):
                zvals = claim.requirements[
                    apilabels.LABEL_TOPOLOGY_ZONE
                ].sorted_values()
                if len(zvals) == 1:
                    zone = zvals[0]
            groups.append((f"claim[{i}]", zone, claim.pods, True))
        for sim in results.existing_nodes:
            node = self.existing_by_name.get(sim.name)
            zone = (
                node.labels.get(apilabels.LABEL_TOPOLOGY_ZONE)
                if node is not None else None
            )
            groups.append((f"node[{sim.name}]", zone, sim.pods, False))

        for (key, selector, max_skew), cons in constraints.items():
            if selector is None:
                continue
            if key == apilabels.LABEL_HOSTNAME:
                for label, _zone, group_pods, _fresh in groups:
                    n = sum(
                        1 for p in group_pods
                        if check_of(p).spread_hard
                        and selector.matches(p.metadata.labels or {})
                        and any(
                            c.topology_key == key
                            and c.label_selector == selector
                            for c in check_of(p).spread_hard
                        )
                    )
                    if n > max_skew:
                        out.append(Violation(
                            "spread",
                            f"{label}: {n} pods matching hostname spread"
                            f" {selector} exceed maxSkew {max_skew}",
                        ))
            elif key == apilabels.LABEL_TOPOLOGY_ZONE:
                counts: Dict[str, int] = {}
                attributable = True
                eligible: set = set()
                for _label, zone, group_pods, _fresh in groups:
                    matching = [
                        p for p in group_pods
                        if selector.matches(p.metadata.labels or {})
                    ]
                    if not matching:
                        continue
                    # a selector cohort where some matching pods do NOT
                    # carry the constraint can legally end up skewed (only
                    # constrained placements check the bound) — counting a
                    # subset would manufacture skew, so skip such cohorts:
                    # soundness over completeness
                    if any(
                        not any(
                            c.topology_key == key
                            and c.label_selector == selector
                            for c in check_of(p).spread_hard
                        )
                        for p in matching
                    ):
                        attributable = False
                        break
                    if zone is None:
                        attributable = False
                        break
                    counts[zone] = counts.get(zone, 0) + len(matching)
                    for p in matching:
                        eligible |= self._allowed_zones(check_of(p))
                if not attributable or not counts:
                    continue
                # the topology context's already-bound matching pods count
                # toward the domains too
                if self.topology is not None:
                    for p, labels, name in self.topology.existing_pods:
                        if p.uid in self.topology.excluded_pods:
                            continue
                        if not selector.matches(p.metadata.labels or {}):
                            continue
                        z = labels.get(apilabels.LABEL_TOPOLOGY_ZONE)
                        if z is None:
                            node = self.existing_by_name.get(name)
                            z = (
                                node.labels.get(apilabels.LABEL_TOPOLOGY_ZONE)
                                if node is not None else None
                            )
                        if z is not None:
                            counts[z] = counts.get(z, 0) + 1
                domains = eligible & self._zone_universe or eligible
                if not domains:
                    continue
                # BOTH ends range over the eligible domains only: the
                # topology context may hold historical matching pods in a
                # zone these pods cannot take (affinity-pinned elsewhere),
                # and the solver legally ignores that zone's count — so
                # must the skew bound, or legitimate placements reject
                low = min(counts.get(z, 0) for z in domains)
                high = max(counts.get(z, 0) for z in domains)
                if high - low > max_skew:
                    out.append(Violation(
                        "spread",
                        f"zone spread {selector}: domain counts {counts}"
                        f" skew {high - low} > maxSkew {max_skew}",
                    ))
        return out

    def _allowed_zones(self, c: _ClassCheck) -> set:
        """Zones this pod class could take at all (its immune requirements
        + any affinity alternative), bounding the spread domain set."""
        base = set(self._zone_universe)
        if c.immune_reqs.has(apilabels.LABEL_TOPOLOGY_ZONE):
            zreq = c.immune_reqs[apilabels.LABEL_TOPOLOGY_ZONE]
            if not zreq.complement:
                base = set(zreq.sorted_values())
        if not c.affinity_alts:
            return base
        allowed: set = set()
        for alt in c.affinity_alts:
            if not alt.has(apilabels.LABEL_TOPOLOGY_ZONE):
                return base  # some alternative allows any zone
            areq = alt[apilabels.LABEL_TOPOLOGY_ZONE]
            if areq.complement:
                return base
            allowed |= set(areq.sorted_values())
        return base & allowed if allowed else base


def verify_frontier(frontier) -> Optional[str]:
    """Structural verification of a consolidation-frontier response: None
    when trustworthy, else the defect. The sweep's (ok, n_new, price_lb)
    triples feed binary decisions directly, so garbage here silently
    mis-sizes a disruption command."""
    if frontier is None:
        return None  # "unrepresentable" is a valid, honest answer
    if not isinstance(frontier, list):
        return f"frontier is {type(frontier).__name__}, not a list"
    for i, entry in enumerate(frontier):
        if not isinstance(entry, tuple) or len(entry) != 3:
            return f"frontier[{i}] is not an (ok, n_new, price_lb) triple"
        ok, n_new, price = entry
        if not isinstance(ok, bool):
            return f"frontier[{i}].ok is {type(ok).__name__}, not bool"
        if not isinstance(n_new, int) or isinstance(n_new, bool):
            return f"frontier[{i}].n_new is not an int"
        if n_new < 0:
            return f"frontier[{i}].n_new is negative ({n_new})"
        if not isinstance(price, float) or price != price or price < 0:
            return f"frontier[{i}].price_lb is not a finite non-negative float"
    return None


def reject(violations: List[Violation], path: str, recorder=None) -> None:
    """The shared rejection side effects: one counter bump per distinct
    reason (`solver_result_rejected_total{reason,path}`) and a Warning
    event when a recorder rides along. The CALLER owns the degradation
    (greedy re-solve / host binary search)."""
    from karpenter_core_tpu_torch.metrics import wiring as m

    for reason in sorted({v.reason for v in violations}):
        m.SOLVER_RESULT_REJECTED.inc({"reason": reason, "path": path})
    if recorder is not None:
        from karpenter_core_tpu_torch.events import Event

        recorder.publish(Event(
            involved_object="Solver/result",
            type="Warning",
            reason="SolverResultRejected",
            message=(
                f"{path} solve result failed verification"
                f" ({len(violations)} violation(s):"
                f" {'; '.join(str(v) for v in violations[:3])})"
                " — degraded to greedy"
            ),
        ))
