"""The batched first-fit-decreasing scan over pod classes, plain PyTorch.

Port of ``karpenter_core_tpu/ops/ffd.py``: the same state, the same step,
the same integer-exact float32 arithmetic, written as eager torch ops. It
is the plain version of the hand kernel in ``ops/cuda_ffd.py`` (the CPU
path and the kernel's oracle on the card). Each step places one pod class
over all open slots at once:

* slot feasibility — requirement mask planes ([N,K,V] value masks +
  defines/complement/negative/gt/lt planes) against the class, with the
  closed-world algebra of ``ops/masks.compatible``;
* capacity — per-slot take counts floor((allocatable - requests) / r),
  maximized over the slot's viable instance types; existing nodes use
  their fixed available vector;
* topology — label-group counts over values (``zcount``) and hostname
  counts per slot (``hcount``) give admissible-domain masks, per-slot caps
  and a water-fill quota per pinned sub-step;
* placement — existing nodes first-fit in slot order by an exclusive
  prefix (grouped by network level first when the step carries a
  ``topo_rank`` plane: rack-aware gangs), then in-flight claims
  emptiest-first by a capped water-fill, then ceil(rem / kstar) fresh
  slots from the class's template.

Dtypes follow the JAX package: torch promotes integer sums and cumsums to
int64, so every such reduction is cast back to int32 at the point where
JAX keeps int32 (a wrapped int64 truncated to int32 equals the wrapped
int32 sum). ``_offering_ok`` and the zcount deltas, float32 products in
JAX, are boolean and integer reductions here: exact, and no TF32 can
reach them.

``ffd_solve_batched`` and ``aggregate_takes_batched`` take B independent
problems stacked on a leading axis (cross-tenant batching); the plain
batched scan is ``ffd_solve`` row by row, the oracle of the batched kernel.

"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

BIG = np.float32(3.4e38)
BIGI = 1 << 30
RANK_NONE = 1 << 30
# network-distance levels a slot can sit at from a gang's anchor domain
# (same rack 0 / same superpod 1 / same zone 2 / farther or unknown 3):
# solver/gangs.MAX_HOP_DISTANCE + 1. The existing-slot fill takes all
# level-0 capacity before any level-1 capacity, slot order within a level.
TOPO_LEVELS = 4

_I32 = torch.int32
_F32 = torch.float32


class SlotState(NamedTuple):
    valmask: torch.Tensor  # [N, K, V] bool — intersected allowed values
    defines: torch.Tensor  # [N, K] bool
    complement: torch.Tensor  # [N, K] bool (AND of contributors)
    negative: torch.Tensor  # [N, K] bool (AND of contributors)
    gt: torch.Tensor  # [N, K] int32
    lt: torch.Tensor  # [N, K] int32
    itmask: torch.Tensor  # [N, T] bool — viable instance types (new slots)
    requests: torch.Tensor  # [N, R] float32
    capacity: torch.Tensor  # [N, R] float32 (existing slots; BIG for new)
    kind: torch.Tensor  # [N] int8: 0 unused, 1 existing, 2 new
    template: torch.Tensor  # [N] int32 (new slots; -1 otherwise)
    podcount: torch.Tensor  # [N] int32 — pods placed per slot
    next_free: torch.Tensor  # [] int32
    overflow: torch.Tensor  # [] bool
    hcount: torch.Tensor  # [N, Gh] int32 — hostname-group counts per slot
    zcount: torch.Tensor  # [Gz, V] int32 — label-group counts per value
    carry: torch.Tensor  # [] int32 — remaining pods of the current wf class


class ClassStep(NamedTuple):
    """Per-class scanned inputs; stacked, every field gains a leading [J]."""

    mask: torch.Tensor  # [K, V] bool
    defines: torch.Tensor  # [K] bool
    concrete: torch.Tensor  # [K] bool
    negative: torch.Tensor  # [K] bool
    gt: torch.Tensor  # [K] int32
    lt: torch.Tensor  # [K] int32
    count: torch.Tensor  # [] int32
    requests: torch.Tensor  # [R] float32
    class_it: torch.Tensor  # [T] bool — pod-vs-instance-type compat
    tmpl_ok: torch.Tensor  # [S] bool — compat+taints vs each template
    exist_taint_ok: torch.Tensor  # [N] bool — tolerates existing slot n's taints
    new_template: torch.Tensor  # [] int32 — template for fresh nodes (-1 none)
    kstar: torch.Tensor  # [] int32 — pods per fresh node on the best IT
    smask: torch.Tensor  # [K, V] bool — STRICT admissible values
    h_sel: torch.Tensor  # [Gh] bool — hostname groups counting this class
    h_owner: torch.Tensor  # [Gh] bool — hostname groups constraining it
    z_sel: torch.Tensor  # [Gz] bool
    z_owner: torch.Tensor  # [Gz] bool
    sub_value: torch.Tensor  # [] int32 — water-fill pinned value id (-1 none)
    sub_first: torch.Tensor  # [] bool
    sub_last: torch.Tensor  # [] bool
    wf_group: torch.Tensor  # [] int32 — label-group index for water-fill (-1)
    wf_key: torch.Tensor  # [] int32 — vocab key id of that group
    zone_rest: torch.Tensor  # [V] bool — this + later sub-step domains
    # per-slot network-distance level of each existing slot from this
    # class's gang anchor, in [0, TOPO_LEVELS). None (the default) runs the
    # classic first-fit prefix; only kind == 1 slots consult it (fresh
    # claims keep the water-fill)
    topo_rank: Optional[torch.Tensor] = None  # [N] int32


class FFDStatics(NamedTuple):
    """Solve-constant device tensors."""

    it_alloc: torch.Tensor  # [T, R]
    off_avail: torch.Tensor  # [T, Z, CT] bool
    zone_key: torch.Tensor  # [] int32 — key id of the zone label
    ct_key: torch.Tensor  # [] int32 — key id of the capacity-type label
    tmpl_mask: torch.Tensor  # [S, K, V]
    tmpl_defines: torch.Tensor  # [S, K]
    tmpl_complement: torch.Tensor  # [S, K]
    tmpl_negative: torch.Tensor  # [S, K]
    tmpl_gt: torch.Tensor  # [S, K]
    tmpl_lt: torch.Tensor  # [S, K]
    tmpl_it: torch.Tensor  # [S, T] bool
    tmpl_overhead: torch.Tensor  # [S, R] — daemon overhead requests
    well_known: torch.Tensor  # [K] bool
    gt_none: torch.Tensor  # [] int32
    lt_none: torch.Tensor  # [] int32
    h_type: torch.Tensor  # [Gh] int32: 0 spread / 1 anti / 2 affinity
    h_skew: torch.Tensor  # [Gh] int32
    h_possel0: torch.Tensor  # [Gh] bool — positive count on a non-slot hostname
    z_type: torch.Tensor  # [Gz] int32
    z_skew: torch.Tensor  # [Gz] int32
    z_key: torch.Tensor  # [Gz] int32 — vocab key id per label group
    z_mindom: torch.Tensor  # [Gz] int32 (-1: no minDomains)
    z_domains: torch.Tensor  # [Gz, V] bool — registered domain universe
    z_rank: torch.Tensor  # [Gz, V] int32 — sorted-name rank (RANK_NONE outside)


def _isum(x: torch.Tensor, dim=None) -> torch.Tensor:
    """int32 sum with JAX's wrap-around (torch accumulates in int64)."""
    s = x.sum() if dim is None else x.sum(dim=dim)
    return s.to(_I32)


def _icumsum(x: torch.Tensor) -> torch.Tensor:
    """int32 cumsum along axis 0 (torch returns int64)."""
    return torch.cumsum(x, dim=0).to(_I32)


def _full(like: torch.Tensor, value, dtype) -> torch.Tensor:
    return torch.full((), value, dtype=dtype, device=like.device)


def _class_slot_compatible(state: SlotState, c, statics: FFDStatics):
    """Requirements.Compatible(class -> slot) vectorized over slots; the
    custom-label rule exempts well-known keys on new slots only."""
    overlap = torch.any(state.valmask & c.mask[None, :, :], dim=-1)  # [N, K]
    both = state.defines & c.defines[None, :]
    either_concrete = ~state.complement | c.concrete[None, :]
    crossed = torch.maximum(state.gt, c.gt[None, :]) >= torch.minimum(
        state.lt, c.lt[None, :]
    )
    empty = torch.where(either_concrete, ~overlap, crossed)
    both_negative = state.negative & c.negative[None, :]
    rule2 = both & empty & ~both_negative

    is_new = (state.kind == 2)[:, None]
    allow = statics.well_known[None, :] & is_new
    rule1 = c.defines[None, :] & ~c.negative[None, :] & ~state.defines & ~allow
    return ~torch.any(rule1 | rule2, dim=-1)  # [N]


def _offering_ok(statics: FFDStatics, joined_valmask):
    """[N, T] — instance type t has an available offering compatible with
    the slot's (zone, capacity-type) masks. A boolean any over the small
    (Z, CT) lattice: exact, with no float product to round."""
    Z = statics.off_avail.shape[1]
    CT = statics.off_avail.shape[2]
    zk = statics.zone_key.long()
    ck = statics.ct_key.long()
    zmask = joined_valmask.index_select(1, zk.reshape(1))[:, 0, :Z]  # [N, Z]
    ctmask = joined_valmask.index_select(1, ck.reshape(1))[:, 0, :CT]  # [N, CT]
    off = statics.off_avail  # [T, Z, CT]
    joint = torch.zeros(
        (joined_valmask.shape[0], off.shape[0]), dtype=torch.bool,
        device=off.device,
    )
    for z in range(Z):
        for ct in range(CT):
            joint |= (zmask[:, z] & ctmask[:, ct])[:, None] & off[None, :, z, ct]
    return joint


# No floor margin on the per-slot take counts: requests and capacities are
# integer-valued float32 (milli/Mi quantization in models/provisioner), so
# floor((alloc - req) / r) is exact below 2^24.


def _k_max(state: SlotState, c: ClassStep, statics: FFDStatics, viable_it):
    """Max pods of the class each slot can absorb: ([N] int32, [N, T] the
    per-IT float counts, which double as the post-take fit check)."""
    r = c.requests  # [R]
    big = _full(r, float(BIG), _F32)
    safe_r = torch.where(r > 0, r, torch.ones_like(r))
    head = (statics.it_alloc[None, :, :] - state.requests[:, None, :]) / safe_r
    head = torch.where(r[None, None, :] > 0, head, big)
    k_raw = torch.floor(torch.amin(head, dim=-1))  # [N, T]
    k_it = torch.where(viable_it, k_raw, _full(r, -1.0, _F32))
    k_new = torch.amax(k_it, dim=-1)  # [N]
    head_e = (state.capacity - state.requests) / safe_r
    head_e = torch.where(r[None, :] > 0, head_e, big)
    k_exist = torch.floor(torch.amin(head_e, dim=-1))  # [N]
    k = torch.where(state.kind == 1, k_exist, k_new)
    return torch.clamp(k, 0.0, float(2**30)).to(_I32), k_raw


# ---------------------------------------------------------------------------
# topology: admissible domains, slot caps, water-fill quota


def _label_admissible(state: SlotState, c: ClassStep, statics: FFDStatics):
    """The class's owned label-group constraints as a requirement
    restriction: (restr [K, V] bool, topo_defined [K] bool). Spread admits
    count (+1 if self-selecting) - min <= maxSkew; anti-affinity admits
    empty domains; affinity admits count>0 domains, bootstrapping on the
    first sorted admissible domain."""
    Gz, V = statics.z_domains.shape
    K = c.mask.shape[0]
    dev = c.mask.device
    bigi = _full(state.zcount, BIGI, _I32)
    zero = _full(state.zcount, 0, _I32)
    smask_g = c.smask[statics.z_key.long()]  # [Gz, V]
    padm = smask_g & statics.z_domains
    counts = state.zcount
    cnt = torch.where(padm, counts, bigi)
    minc = torch.amin(cnt, dim=1)  # [Gz]
    supported = _isum(padm, dim=1)
    minc = torch.where(
        (statics.z_mindom >= 0) & (supported < statics.z_mindom), zero, minc
    )
    inc = c.z_sel.to(_I32)
    delta = counts + inc[:, None] - minc[:, None]
    adm_spread = padm & (delta <= statics.z_skew[:, None])
    adm_anti = padm & (counts == 0)
    pos = padm & (counts > 0)
    any_pos = torch.any(pos, dim=1)
    rank = torch.where(padm, statics.z_rank, _full(counts, RANK_NONE, _I32))
    boot = (rank == torch.amin(rank, dim=1, keepdim=True)) & padm
    adm_aff = torch.where(
        any_pos[:, None], pos, c.z_sel[:, None] & boot
    )
    adm = torch.where(
        (statics.z_type == 0)[:, None],
        adm_spread,
        torch.where((statics.z_type == 1)[:, None], adm_anti, adm_aff),
    )

    gidx = torch.arange(Gz, dtype=_I32, device=dev)
    owner = c.z_owner & (gidx != c.wf_group)  # wf group handled via the pin
    karange = torch.arange(K, dtype=_I32, device=dev)
    owner_key = (statics.z_key[:, None] == karange[None, :]) & owner[:, None]
    viol = torch.any(owner_key[:, :, None] & ~adm[:, None, :], dim=0)  # [K, V]
    restr = ~viol
    topo_defined = torch.any(owner_key, dim=0)

    # water-fill pin: the sub-step's key row collapses to the pinned value
    has_wf = c.wf_group >= 0
    varange = torch.arange(V, dtype=_I32, device=dev)
    pin_row = (varange == torch.clamp(c.sub_value, min=0)) & (c.sub_value >= 0)
    wf_key_oh = (karange == torch.clamp(c.wf_key, min=0)) & has_wf
    restr = restr & (~wf_key_oh[:, None] | pin_row[None, :])
    topo_defined = topo_defined | wf_key_oh
    return restr, topo_defined


def _host_caps(state: SlotState, c: ClassStep, statics: FFDStatics):
    """Per-slot take caps from owned hostname-keyed groups:
    (slot_cap [N] int32, fresh_cap [] int32, single_slot [] bool)."""
    counts = state.hcount  # [N, Gh]
    sel = c.h_sel
    owner = c.h_owner
    skew = statics.h_skew
    bigi = _full(counts, BIGI, _I32)
    zero = _full(counts, 0, _I32)
    one = _full(counts, 1, _I32)
    cap_spread = torch.where(
        sel[None, :],
        skew[None, :] - counts,
        torch.where(counts <= skew[None, :], bigi, zero),
    )
    cap_anti = torch.where(
        counts == 0, torch.where(sel, one, bigi)[None, :], zero
    )
    pos_any = statics.h_possel0 | torch.any(counts > 0, dim=0)  # [Gh]
    boot = (~pos_any) & sel & (statics.h_type == 2)
    cap_aff = torch.where(counts > 0, bigi, zero)
    cap_aff = torch.where(boot[None, :], bigi, cap_aff)
    cap = torch.where(
        (statics.h_type == 0)[None, :],
        cap_spread,
        torch.where((statics.h_type == 1)[None, :], cap_anti, cap_aff),
    )
    cap = torch.where(owner[None, :], cap, bigi)
    slot_cap = torch.clamp(torch.amin(cap, dim=1), min=0)  # [N]

    f_cap_g = torch.where(
        statics.h_type == 0,
        torch.where(sel, skew, bigi),
        torch.where(
            statics.h_type == 1,
            torch.where(sel, one, bigi),
            torch.where(boot, bigi, zero),
        ),
    )
    f_cap_g = torch.where(owner, f_cap_g, bigi)
    fresh_cap = torch.clamp(torch.amin(f_cap_g), min=0)
    single_slot = torch.any(boot & owner)
    return slot_cap, fresh_cap, single_slot


# Level-search iterations; callers that know the solve's pod count pass
# ceil(log2(2*pods)) via ffd_solve(level_iters=...).
LEVEL_ITERS = 32


def _level_fill(count, cap, adm, m, rank=None, iters=LEVEL_ITERS):
    """Water-fill m units over admissible entries with per-entry caps:
    binary-search the level L with fill = clip(L - count, 0, cap), then
    hand the remainder one each to the entries sitting exactly at the
    level, lowest rank first (rank=None ties by entry index)."""
    zero = _full(count, 0, _I32)
    cap = torch.clamp(cap, min=0)

    def fill_at(L):
        return torch.where(adm, torch.minimum(torch.clamp(L - count, min=0), cap),
                           zero)

    hi = torch.amax(torch.where(adm, count, zero)) + m
    lo = zero.clone()
    for _ in range(iters):
        mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
        ok = _isum(fill_at(mid)) <= m
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid - 1)
    L = lo
    fill = fill_at(L)
    r = m - _isum(fill)
    elig = adm & (fill < cap) & (count + fill == L)
    if rank is None:
        erank = _icumsum(elig) - elig.to(_I32)  # exclusive: ties by index
    else:
        rk = torch.where(elig, rank, _full(rank, RANK_NONE, _I32))
        erank = _isum((rk[None, :] < rk[:, None]) & elig[None, :], dim=1)
    return fill + (elig & (erank < r)).to(_I32)


def _waterfill_take(count, cap, m, iters=LEVEL_ITERS):
    """Distribute m pods over in-flight slots emptiest-first with per-slot
    caps (the host policy's sort-claims-by-pod-count loop)."""
    return _level_fill(count, cap, cap > 0, m, iters=iters)


def _wf_quota(state: SlotState, c: ClassStep, statics: FFDStatics, m,
              iters=LEVEL_ITERS):
    """Water-fill share of the pinned sub-step domain: each pod joins the
    min-count admissible domain (ties by sorted-name rank); under an
    unsatisfied minDomains each domain caps at maxSkew."""
    g = torch.clamp(c.wf_group, min=0).long()
    counts = state.zcount[g]  # [V]
    padm = c.zone_rest
    skew = statics.z_skew[g]
    full_adm = c.smask[statics.z_key[g].long()] & statics.z_domains[g]
    supported = _isum(full_adm)
    mindom = statics.z_mindom[g]
    mindom_unsat = (mindom >= 0) & (supported < mindom)
    cap = torch.where(
        mindom_unsat, torch.clamp(skew - counts, min=0),
        _full(counts, BIGI, _I32),
    )
    quota = _level_fill(counts, cap, padm, m, rank=statics.z_rank[g],
                        iters=iters)
    return torch.where(
        c.sub_value >= 0, quota[torch.clamp(c.sub_value, min=0).long()],
        _full(quota, 0, _I32),
    )


# ---------------------------------------------------------------------------


def ffd_step(state: SlotState, c: ClassStep, statics: FFDStatics,
             level_iters: int = LEVEL_ITERS):
    """Place one pod class; returns (state', (take [N] int32, unplaced []))."""
    N = state.kind.shape[0]
    dev = state.kind.device
    zero = _full(state.podcount, 0, _I32)

    # -- topology: effective class requirements + caps + quota -------------
    restr, topo_defined = _label_admissible(state, c, statics)
    eff_mask = c.mask & restr
    eff_defines = c.defines | topo_defined
    eff_concrete = c.concrete | topo_defined
    eff_negative = c.negative & ~topo_defined
    c_eff = c._replace(
        mask=eff_mask,
        defines=eff_defines,
        concrete=eff_concrete,
        negative=eff_negative,
    )
    slot_cap, fresh_cap, single_slot = _host_caps(state, c, statics)

    is_wf = c.wf_group >= 0
    carry0 = torch.where(c.sub_first, c.count, state.carry)
    m = torch.where(
        is_wf, _wf_quota(state, c, statics, carry0, iters=level_iters), c.count
    )

    # -- feasibility on open slots ---------------------------------------
    req_ok = _class_slot_compatible(state, c_eff, statics)
    taint_ok = torch.where(
        state.kind == 1,
        c.exist_taint_ok,
        c.tmpl_ok[torch.clamp(state.template, min=0).long()],
    )
    joined_valmask = state.valmask & (
        eff_mask[None, :, :] | ~eff_defines[None, :, None]
    )
    off_ok = _offering_ok(statics, joined_valmask)  # [N, T]
    viable_it = state.itmask & c.class_it[None, :] & off_ok
    k_max, k_raw = _k_max(state, c, statics, viable_it)

    safe_r_step = torch.where(
        c.requests > 0, c.requests, torch.ones_like(c.requests)
    )
    feasible = (
        (state.kind > 0)
        & req_ok
        & taint_ok
        & ((state.kind == 1) | torch.any(viable_it, dim=-1))
    )
    k_eff = torch.minimum(k_max, slot_cap)
    k_eff = torch.where(feasible, k_eff, zero)

    # -- two-phase fill: existing nodes first-fit in slot order, then
    # in-flight claims emptiest-first -----------------------------------
    k_exist_eff = torch.where(state.kind == 1, k_eff, zero)
    if c.topo_rank is None:
        before = _icumsum(k_exist_eff) - k_exist_eff  # exclusive prefix
    else:
        # level-grouped first-fit (rack-aware gangs): all capacity at
        # network level 0 fills before any at level 1, slot order within a
        # level. Integer-exact; an all-zero plane puts every slot in level
        # 0, where the within-level prefix IS the classic exclusive prefix.
        lvl = torch.clamp(c.topo_rank, 0, TOPO_LEVELS - 1)  # [N]
        onehot = lvl[:, None] == torch.arange(
            TOPO_LEVELS, dtype=lvl.dtype, device=dev
        )[None, :]  # [N, L]
        k_lvl = torch.where(onehot, k_exist_eff[:, None],
                            torch.zeros_like(k_exist_eff)[:, None])  # [N, L]
        lvl_tot = _isum(k_lvl, dim=0)  # [L]
        below = _icumsum(lvl_tot) - lvl_tot  # exclusive over levels
        within = _icumsum(k_lvl) - k_lvl  # exclusive inside each level
        before = below[lvl.long()] + _isum(
            torch.where(onehot, within, torch.zeros_like(within)), dim=1
        )
    take_exist = torch.minimum(torch.clamp(m - before, min=0), k_exist_eff)
    rem_claims = m - _isum(take_exist)
    k_claim_eff = torch.where(state.kind == 2, k_eff, zero)
    take_claims = _waterfill_take(
        state.podcount, k_claim_eff, rem_claims, iters=level_iters
    )
    take_normal = take_exist + take_claims
    first_feasible = feasible & (_icumsum(feasible) == 1)
    take_single = torch.where(first_feasible, torch.minimum(k_eff, m), zero)
    take = torch.where(single_slot, take_single, take_normal)
    rem = m - _isum(take)

    # -- open fresh slots -------------------------------------------------
    has_template = (c.new_template >= 0) & (fresh_cap > 0)
    kstar = torch.clamp(
        torch.minimum(torch.clamp(c.kstar, min=1), fresh_cap), min=1
    )
    n_new = torch.where(
        has_template & (rem > 0),
        torch.div(rem + kstar - 1, kstar, rounding_mode="floor"),
        zero,
    )
    # affinity bootstrap places on exactly one slot — a fresh one only when
    # no existing slot admitted anything
    n_new = torch.where(
        single_slot,
        torch.where(_isum(take) > 0, zero, torch.clamp(n_new, max=1)),
        n_new,
    )
    idx = torch.arange(N, dtype=_I32, device=dev)
    fresh = (idx >= state.next_free) & (idx < state.next_free + n_new)
    take_fresh = torch.where(
        fresh,
        torch.minimum(
            torch.clamp(rem - (idx - state.next_free) * kstar, min=0), kstar
        ),
        zero,
    )
    overflow = state.overflow | (state.next_free + n_new > N)
    unplaced_step = rem - _isum(take_fresh)

    s = torch.clamp(c.new_template, min=0).long()
    took = take > 0

    # -- merge class requirement state into slots that took ---------------
    # keys an entity does not define carry NEUTRAL state (all-True valmask,
    # complement/negative True, sentinel bounds), so intersection-on-add is
    # uniform: mask AND, complement AND ~concrete, negative AND, gt max, lt
    # min
    upd = (took | fresh)[:, None] & eff_defines[None, :]  # [N, K]
    fr1 = fresh[:, None]
    base_valmask = torch.where(
        fresh[:, None, None], statics.tmpl_mask[s][None, :, :], state.valmask
    )
    base_defines = torch.where(fr1, statics.tmpl_defines[s][None, :], state.defines)
    base_complement = torch.where(
        fr1, statics.tmpl_complement[s][None, :], state.complement
    )
    base_negative = torch.where(
        fr1, statics.tmpl_negative[s][None, :], state.negative
    )
    base_gt = torch.where(fr1, statics.tmpl_gt[s][None, :], state.gt)
    base_lt = torch.where(fr1, statics.tmpl_lt[s][None, :], state.lt)

    new_valmask = torch.where(
        upd[:, :, None], base_valmask & eff_mask[None, :, :], base_valmask
    )
    new_defines = base_defines | upd
    new_complement = torch.where(
        upd, base_complement & ~eff_concrete[None, :], base_complement
    )
    new_negative = torch.where(
        upd, base_negative & eff_negative[None, :], base_negative
    )
    new_gt = torch.where(upd, torch.maximum(base_gt, c.gt[None, :]), base_gt)
    new_lt = torch.where(upd, torch.minimum(base_lt, c.lt[None, :]), base_lt)

    # -- requests / capacity / itmask -------------------------------------
    take_all = take + take_fresh
    base_requests = torch.where(
        fr1, statics.tmpl_overhead[s][None, :], state.requests
    )
    new_requests = base_requests + take_all[:, None].to(_F32) * c.requests[None, :]

    base_itmask = torch.where(fr1, statics.tmpl_it[s][None, :], state.itmask)
    joined = took | fresh
    # post-take viability without re-reducing [N, T, R]: open slots reuse
    # k_raw >= take and the pre-take off_ok; fresh slots share one [T] row
    # with the template overhead on every dim
    oh = statics.tmpl_overhead[s]  # [R]
    head_f = (statics.it_alloc - oh[None, :]) / safe_r_step[None, :]
    head_f = torch.where(
        c.requests[None, :] > 0,
        head_f,
        torch.where(
            statics.it_alloc >= oh[None, :],
            _full(oh, float(BIG), _F32),
            _full(oh, -1.0, _F32),
        ),
    )
    k_fresh = torch.floor(torch.amin(head_f, dim=-1))  # [T]
    off_fresh = _offering_ok(
        statics, (statics.tmpl_mask[s] & eff_mask)[None, :, :]
    )[0]  # [T]
    take_f = take_all[:, None].to(_F32)
    fit_ok = torch.where(fr1, k_fresh[None, :] >= take_f, k_raw >= take_f)
    off_sel = torch.where(fr1, off_fresh[None, :], off_ok)
    new_itmask = torch.where(
        joined[:, None],
        base_itmask & c.class_it[None, :] & fit_ok & off_sel,
        base_itmask,
    )

    new_kind = torch.where(fresh, torch.full_like(state.kind, 2), state.kind)
    new_template = torch.where(fresh, s.to(_I32), state.template)
    new_capacity = torch.where(
        fr1, _full(state.capacity, float(BIG), _F32), state.capacity
    )

    # -- topology count updates -------------------------------------------
    # hostname groups: every counted pod lands on its slot's hostname domain
    new_hcount = state.hcount + take_all[:, None] * c.h_sel[None, :].to(_I32)
    # label groups: spread/affinity record a placement only once the slot's
    # key row is pinned to one concrete value; anti-affinity records every
    # value the slot could take. Integer deltas (float32 einsums in JAX,
    # exact below 2^24 pods).
    def_c = new_defines & ~new_complement  # [N, K]
    rowcount = _isum(new_valmask, dim=2)  # [N, K]
    vm64 = new_valmask.to(torch.int64)
    ta64 = take_all.to(torch.int64)[:, None]
    w_pin = ta64 * (def_c & (rowcount == 1)).to(torch.int64)
    w_anti = ta64 * def_c.to(torch.int64)
    delta_pin = (w_pin[:, :, None] * vm64).sum(dim=0)  # [K, V]
    delta_anti = (w_anti[:, :, None] * vm64).sum(dim=0)
    zk = statics.z_key.long()
    delta_g = torch.where(
        (statics.z_type == 1)[:, None], delta_anti[zk], delta_pin[zk]
    )  # [Gz, V]
    new_zcount = state.zcount + (delta_g * c.z_sel[:, None].to(torch.int64)).to(_I32)

    placed = m - unplaced_step
    carry_after = carry0 - placed
    unplaced = torch.where(
        is_wf, torch.where(c.sub_last, carry_after, zero), unplaced_step
    )

    state2 = SlotState(
        valmask=new_valmask,
        defines=new_defines,
        complement=new_complement,
        negative=new_negative,
        gt=new_gt,
        lt=new_lt,
        itmask=new_itmask,
        requests=new_requests,
        capacity=new_capacity,
        kind=new_kind,
        template=new_template,
        podcount=state.podcount + take_all,
        next_free=state.next_free + n_new,
        overflow=overflow,
        hcount=new_hcount,
        zcount=new_zcount,
        carry=carry_after,
    )
    return state2, (take_all, unplaced)


def step_at(steps: ClassStep, j: int) -> ClassStep:
    """Step j of a stacked ClassStep."""
    return ClassStep(*(None if x is None else x[j] for x in steps))


def ffd_solve(state: SlotState, classes: ClassStep, statics: FFDStatics,
              level_iters: int = LEVEL_ITERS):
    """Scan all stacked classes; returns (final state, takes [J, N] int32,
    unplaced [J] int32). The input state is not modified."""
    J = classes.count.shape[0]
    takes, unplaced = [], []
    for j in range(J):
        state, (take, unp) = ffd_step(state, step_at(classes, j), statics,
                                      level_iters)
        takes.append(take)
        unplaced.append(unp)
    N = state.kind.shape[0]
    dev = state.kind.device
    if J:
        return state, torch.stack(takes), torch.stack(unplaced)
    return (state, torch.zeros((0, N), dtype=_I32, device=dev),
            torch.zeros((0,), dtype=_I32, device=dev))


def aggregate_takes(takes, unplaced, step_class, num_classes: int):
    """Per-step scan outputs summed to per-class decision planes:
    (takes_by_class [Cp, N], unplaced_by_class [Cp]), an exact integer
    segment sum over the step -> class index. Pad steps carry zero takes,
    so routing them to class 0 is harmless."""
    idx = step_class.long()
    tbc = torch.zeros(
        (num_classes, takes.shape[1]), dtype=takes.dtype, device=takes.device
    ).index_add_(0, idx, takes)
    ubc = torch.zeros(
        (num_classes,), dtype=unplaced.dtype, device=unplaced.device
    ).index_add_(0, idx, unplaced)
    return tbc, ubc


# ---------------------------------------------------------------------------
# the problem batch axis (cross-tenant batching): every leaf of SlotState /
# ClassStep / FFDStatics gains a leading [B] axis, one row per independent
# problem of equal padded shapes


def _row(tree, b: int):
    return type(tree)(*(None if x is None else x[b] for x in tree))


def ffd_solve_batched(state: SlotState, classes: ClassStep,
                      statics: FFDStatics, level_iters: int = LEVEL_ITERS):
    """``ffd_solve`` over stacked problems, row by row; returns (final
    states [B, ...], takes [B, J, N] int32, unplaced [B, J] int32). The
    input state is not modified."""
    B = state.kind.shape[0]
    if B == 0:
        raise ValueError("ffd_solve_batched: no problem rows")
    rows = [
        ffd_solve(_row(state, b), _row(classes, b), _row(statics, b),
                  level_iters)
        for b in range(B)
    ]
    final = SlotState(*(torch.stack(xs) for xs in zip(*(r[0] for r in rows))))
    return (final, torch.stack([r[1] for r in rows]),
            torch.stack([r[2] for r in rows]))


def aggregate_takes_batched(takes, unplaced, step_class, num_classes: int):
    """``aggregate_takes`` over a leading problem axis: takes [B, J, N],
    unplaced [B, J], step_class [B, J] (each problem has its own step ->
    class index) -> ([B, Cp, N], [B, Cp]); one segment sum over the
    flattened (problem, class) index."""
    B, J, N = takes.shape
    rows = torch.arange(B, device=step_class.device)[:, None] * num_classes
    idx = (step_class.long() + rows).reshape(-1)
    tbc = torch.zeros(
        (B * num_classes, N), dtype=takes.dtype, device=takes.device
    ).index_add_(0, idx, takes.reshape(B * J, N))
    ubc = torch.zeros(
        (B * num_classes,), dtype=unplaced.dtype, device=unplaced.device
    ).index_add_(0, idx, unplaced.reshape(B * J))
    return tbc.reshape(B, num_classes, N), ubc.reshape(B, num_classes)
