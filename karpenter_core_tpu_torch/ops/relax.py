"""The relax backend's assignment ops, plain PyTorch.

Port of ``karpenter_core_tpu/ops/relax.py`` (XLA ops there, torch ops on
an explicit device here; none of them is a hand kernel, and none reaches
the FFD kernel: the relax candidate is materialized by the unmodified FFD
scan with the rounded override riding ``ClassStep.new_template``/``kstar``,
which on the card is ``ops/cuda_ffd``'s kernel).

* ``relax_viability`` lowers the prepared planes to the relaxation's
  constraint planes: per (class, template) feasibility, capacity
  pods-per-node (the kstar override), topology-effective pods-per-node
  and $-per-pod.
* ``relax_choose`` runs the projected-gradient assignment over the
  per-class simplex and rounds it to a per-class (new_template, kstar)
  override; ``relax_choose_batched`` is the same computation with a
  leading problem axis on every plane (JAX's ``vmap``), never a loop over
  problems.
* ``relax_score`` ranks a finished solve's SlotState: (unplaced pods,
  fresh nodes, $-cost proxy).

Only the integral outputs (new_template, kstar, changed, the verdict) are
held to the JAX package exactly; the float iterates agree to rounding.
Three places could flip an integral output on an ulp, and each follows
XLA's order on purpose:

* ``_project_rows``' cumulative sum over the template axis is summed left
  to right, one add a column (XLA's CPU ``reduce_window`` order).
  ``torch.cumsum`` accumulates in double on the CPU and in parallel on the
  card, so it is not used.
* ``_gang_consensus``' segment sum adds each gang's member rows in class
  order (XLA's serial scatter-add), with no atomics.
* ``argmax`` takes the first index on a tie, in both frameworks.

``relax_score``'s cost is summed in float64 and rounded once to float32
(see its docstring).
"""
from __future__ import annotations

import torch

# price sentinel for infeasible (class, template) cells and templates with
# no priced offering; far past any real $/node yet small enough that
# float32 sums over a full slot axis stay finite
BIG_PRICE = 1e12

# default projected-gradient iteration count: the objective is linear +
# a small quadratic, so the iterates contract geometrically and 32 rounds
# land within rounding distance of the optimum at any realistic C×S
DEFAULT_ITERS = 32

# strong-convexity weight and step size for the projected-gradient loop
# (costs are normalized to [0, 1] first, so both are scale-free): mu keeps
# the fixed point unique, eta < 1/mu keeps the quadratic term contractive
_MU = 0.05
_ETA = 0.5
# mix weight of the fractional-node term against the $-cost term: $-cost
# leads, node pressure breaks $-ties toward denser packings
_NODE_WEIGHT = 0.5
# mix weight of the cross-domain-hop term (rack-aware gangs): below the
# node term, so nearness breaks ties but never pays an extra node
_TOPO_WEIGHT = 0.25

_F32 = torch.float32


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=_F32, device=like.device)


def relax_viability(
    class_it,  # [C, T] bool — class × instance-type compat
    tmpl_ok,  # [C, S] bool — class × template compat ∧ taints (∧ gang joint)
    tmpl_it,  # [S, T] bool — template's prefiltered instance types
    class_zmask,  # [C, Z] bool
    class_ctmask,  # [C, CT] bool
    tmpl_zmask,  # [S, Z] bool
    tmpl_ctmask,  # [S, CT] bool
    off_avail,  # [T, Z, CT] bool — offering availability lattice
    it_alloc,  # [T, R] float32 (quantized integer units)
    tmpl_overhead,  # [S, R] float32
    class_requests,  # [C, R] float32
    it_price,  # [T] float32 — min available offering price per IT
    k_cap,  # [C] int32 — topology pods-per-host cap (host-floor classes)
):
    """The relaxation's constraint planes: (viable [C, S] bool, k_cs
    [C, S] int32 — capacity pods per fresh node via template s, k_node
    [C, S] int32 — topology-effective pods per node, podcost [C, S]
    float32 — min $/pod over the viable instance types).

    ``k_cap`` caps the effective pods-per-node of classes owning a
    hostname spread (maxSkew) or anti-affinity (1) group; k_cs stays the
    capacity k, since it rides the scan's kstar override and the scan
    enforces the caps itself. The floor arithmetic is
    ``ops/masks.fresh_viability``'s, so k_cs of the chosen template equals
    the kstar that function would report for it."""
    from karpenter_core_tpu_torch.ops.masks import _exact_products

    C, S = tmpl_ok.shape
    T = off_avail.shape[0]
    viable_it = tmpl_it[None, :, :] & class_it[:, None, :]  # [C, S, T]
    zjoin = class_zmask[:, None, :] & tmpl_zmask[None, :, :]  # [C, S, Z]
    ctjoin = class_ctmask[:, None, :] & tmpl_ctmask[None, :, :]
    joined = zjoin[:, :, :, None] & ctjoin[:, :, None, :]  # [C, S, Z, CT]
    # any offering in the joined (zone, capacity type) lattice: a 0/1
    # product whose sums are at most Z*CT, exact in float32
    _exact_products()
    off_ok = torch.matmul(
        joined.reshape(C * S, -1).to(_F32),
        off_avail.reshape(T, -1).to(_F32).T,
    ).reshape(C, S, T) > 0
    head = it_alloc[None, :, :] - tmpl_overhead[:, None, :]  # [S, T, R]
    r = class_requests
    safe_r = torch.where(r > 0, r, torch.ones_like(r))
    inf = _f32(float("inf"), r)
    k_min = torch.full((C, S, T), float("inf"), dtype=_F32, device=r.device)
    for ri in range(r.shape[1]):  # R is small
        ratio_r = head[None, :, :, ri] / safe_r[:, None, None, ri]
        ratio_r = torch.where(r[:, None, None, ri] > 0, ratio_r, inf)
        k_min = torch.minimum(k_min, ratio_r)
    k_it = torch.floor(k_min)  # [C, S, T]
    ok = viable_it & off_ok & tmpl_ok[:, :, None] & (k_it >= 1.0)
    neg1 = _f32(-1.0, r)
    k_s = torch.where(ok, k_it, neg1).amax(dim=-1)  # [C, S]
    viable = k_s >= 1.0
    k_eff = torch.minimum(k_it, k_cap.to(_F32)[:, None, None])
    ppod = torch.where(
        ok,
        it_price[None, None, :] / torch.clamp(k_eff, min=1.0),
        _f32(BIG_PRICE, r),
    )
    podcost = ppod.amin(dim=-1)  # [C, S]
    k_node = torch.where(ok, k_eff, neg1).amax(dim=-1)  # [C, S]
    return (
        viable,
        torch.clamp(k_s, 0, 2**30).to(torch.int32),
        torch.clamp(k_node, 0, 2**30).to(torch.int32),
        podcost,
    )


def _project_rows(y, viable):
    """Euclidean projection of each row of y [..., C, S] onto the
    probability simplex restricted to its viable support (sort-based).
    Rows with empty support project to zero — the rounding pass hands
    them back to the FFD choice. The cumulative sum runs left to right
    (module docstring)."""
    S = y.shape[-1]
    neg = -3e30
    yv = torch.where(viable, y, _f32(neg, y))
    u = torch.sort(yv, dim=-1, descending=True).values
    cols = [u[..., 0]]
    for j in range(1, S):
        cols.append(cols[-1] + u[..., j])
    css = torch.stack(cols, dim=-1)
    j = torch.arange(1, S + 1, dtype=_F32, device=y.device)
    cond = ((u + (1.0 - css) / j) > 0) & (u > neg / 2)
    rho = torch.clamp(cond.to(torch.int32).sum(dim=-1), min=1)  # [..., C]
    css_rho = torch.gather(css, -1, (rho - 1).long().unsqueeze(-1))[..., 0]
    tau = (css_rho - 1.0) / rho.to(_F32)
    x = torch.clamp(y - tau.unsqueeze(-1), min=0.0) * viable.to(y.dtype)
    return torch.where(
        viable.any(dim=-1, keepdim=True), x, torch.zeros_like(x)
    )


def _gang_members(gang_id, num_gangs: int):
    """Each same-template gang's member classes, in class order: (index
    [B, G, M] int64 into the class axis, valid [B, G, M] bool), M the
    largest gang. One host read (M) a call, outside the iterations."""
    B, C = gang_id.shape
    member = gang_id >= 0
    gid = torch.where(member, gang_id, torch.full_like(gang_id, num_gangs))
    # stable sort by (gang, class): members grouped, in class order
    order = torch.argsort(gid.long() * C + torch.arange(C, device=gid.device),
                          dim=-1)
    counts = torch.zeros((B, num_gangs + 1), dtype=torch.int64,
                         device=gid.device)
    counts.scatter_add_(1, gid.long(), torch.ones_like(gid, dtype=torch.int64))
    counts = counts[:, :num_gangs]
    start = torch.cumsum(counts, dim=-1) - counts  # integer: exact
    M = max(int(counts.max()), 1) if num_gangs else 1
    k = torch.arange(M, device=gid.device)
    valid = k[None, None, :] < counts[:, :, None]  # [B, G, M]
    pos = torch.clamp(start[:, :, None] + k[None, None, :], max=C - 1)
    index = torch.gather(order, 1, pos.reshape(B, -1)).reshape(B, -1, M)
    return index, valid


def _gang_consensus(x, gang_id, num_gangs: int, members):
    """Average same-template gang members' rows (the ADMM consensus
    projection), so every member iterates on one shared row and rounds to
    the same template. x [B, C, S]; the per-gang sums add members in class
    order, as XLA's serial scatter-add does."""
    if num_gangs == 0:
        return x
    index, valid = members
    B, G, M = index.shape
    S = x.shape[-1]
    sum_g = torch.zeros((B, G, S), dtype=x.dtype, device=x.device)
    for k in range(M):
        rows = torch.gather(
            x, 1, index[:, :, k, None].expand(B, G, S)
        )
        sum_g = sum_g + torch.where(
            valid[:, :, k, None], rows, torch.zeros_like(rows)
        )
    cnt_g = valid.to(x.dtype).sum(dim=-1)  # [B, G], integers: exact
    member = gang_id >= 0
    gid = torch.clamp(gang_id, min=0).long()
    mean = torch.gather(sum_g, 1, gid[:, :, None].expand(B, -1, S)) / (
        torch.clamp(torch.gather(cnt_g, 1, gid), min=1.0)[:, :, None]
    )
    return torch.where(member[:, :, None], mean, x)


def _relax_iterates(viable, k_node, podcost, counts, gang_id,
                    warm_template, topo_cost=None,
                    iters: int = DEFAULT_ITERS, num_gangs: int = 0):
    """The projected-gradient iterates x [B, C, S] after ``iters`` steps
    (planes as in ``_relax_choose_impl``)."""
    S = viable.shape[-1]
    vf = viable.to(_F32)
    nv = vf.sum(dim=-1, keepdim=True)  # integers: exact
    uniform = vf / torch.clamp(nv, min=1.0)
    # warm start: rows carrying a prior solution start at its vertex; a
    # warm index no longer viable falls back to the uniform start
    wt = torch.clamp(warm_template, min=0).long()
    warm_viable = (warm_template >= 0) & torch.gather(
        viable, -1, wt.unsqueeze(-1)
    )[..., 0]
    onehot = torch.nn.functional.one_hot(wt, S).to(_F32)
    x = torch.where(warm_viable.unsqueeze(-1), onehot, uniform)
    zero = _f32(0.0, vf)

    def normalized(t):
        peak = t.abs().amax(dim=(-2, -1), keepdim=True)
        return t / torch.clamp(peak, min=1e-6)

    # linear objective: pod mass × $/pod, normalized to [0, 1]
    cost = normalized(torch.where(viable, counts.unsqueeze(-1) * podcost,
                                  zero))
    # fractional-node pressure: counts / k_node estimates nodes opened
    nodeshare = normalized(torch.where(
        viable,
        counts.unsqueeze(-1) / torch.clamp(k_node.to(_F32), min=1.0),
        zero,
    ))
    g = cost + _NODE_WEIGHT * nodeshare
    if topo_cost is not None:
        # absent unless the rack-aware prepare engaged: no plane, no term
        g = g + _TOPO_WEIGHT * normalized(torch.where(viable, topo_cost,
                                                      zero))
    members = (_gang_members(gang_id, num_gangs) if num_gangs else None)
    for _ in range(iters):
        y = x - _ETA * (g + _MU * x)
        y = _gang_consensus(y, gang_id, num_gangs, members)
        x = _project_rows(y, viable)
    return x


def _relax_choose_impl(
    viable,  # [B, C, S] bool
    k_cs,  # [B, C, S] int32 — capacity pods/node (rides the kstar override)
    k_node,  # [B, C, S] int32 — topology-effective pods/node
    podcost,  # [B, C, S] float32
    counts,  # [B, C] float32 — pods per class (0 on pad rows)
    gang_id,  # [B, C] int32 — same-template gang index, -1 outside any
    base_template,  # [B, C] int32 — fresh_viability's first-wins choice
    base_kstar,  # [B, C] int32
    warm_template,  # [B, C] int32 — prior solve's template, -1 = none
    topo_cost=None,  # [B, C, S] float32 — gang-anchor hop distance, or None
    iters: int = DEFAULT_ITERS,
    num_gangs: int = 0,
):
    x = _relax_iterates(viable, k_node, podcost, counts, gang_id,
                        warm_template, topo_cost, iters, num_gangs)
    # rounding repair: argmax over the viable support (first index on a
    # tie); classes with empty support or zero mass keep the FFD choice
    xm = torch.where(viable, x, _f32(-1.0, x))
    choice = torch.argmax(xm, dim=-1)  # int64
    top = torch.gather(xm, -1, choice.unsqueeze(-1))[..., 0]
    has = viable.any(dim=-1) & (top > 0)
    nt = torch.where(has, choice.to(torch.int32), base_template)
    ks = torch.where(
        has, torch.gather(k_cs, -1, choice.unsqueeze(-1))[..., 0], base_kstar
    )
    changed = ((nt != base_template) & (counts > 0)).sum(
        dim=-1, dtype=torch.int32
    )
    return nt, ks, changed


def relax_choose(viable, k_cs, k_node, podcost, counts, gang_id,
                 base_template, base_kstar, warm_template, topo_cost=None,
                 iters: int = DEFAULT_ITERS, num_gangs: int = 0):
    """One problem's assignment and rounding: (new_template [C] int32,
    kstar [C] int32, changed [] int32 — classes with pods whose template
    moved off fresh_viability's choice)."""
    args = [viable, k_cs, k_node, podcost, counts, gang_id, base_template,
            base_kstar, warm_template, topo_cost]
    nt, ks, changed = _relax_choose_impl(
        *(None if a is None else a.unsqueeze(0) for a in args),
        iters=iters, num_gangs=num_gangs,
    )
    return nt[0], ks[0], changed[0]


def relax_choose_batched(viable, k_cs, k_node, podcost, counts, gang_id,
                         base_template, base_kstar, warm_template,
                         topo_cost=None, iters: int = DEFAULT_ITERS,
                         num_gangs: int = 0):
    """``relax_choose`` over a leading problem axis B on every plane, in
    one pass of batched ops (row b equals the solo call on row b)."""
    return _relax_choose_impl(
        viable, k_cs, k_node, podcost, counts, gang_id, base_template,
        base_kstar, warm_template, topo_cost, iters=iters,
        num_gangs=num_gangs,
    )


def relax_score(state, tmpl_price, unplaced_bc):
    """Scored-fallback comparator over a FINISHED solve's SlotState:
    (unplaced pods [] int, fresh nodes opened [] int, $-cost proxy []
    float32 — each fresh slot's template min node price).

    The cost is summed in float64 and rounded once to float32. A float64
    sum of n float32 summands is exact, and so the correctly rounded
    float32 sum whatever the slot order, when the largest summand is
    within 2**(29 - log2 n) of the smallest: for the 4,096 slots of a
    relax solve, prices within a factor of 2**17 (about 131,000) of each
    other, which a catalog's offering prices are. A template with no priced
    offering carries BIG_PRICE (1e12); a sum that holds it beside sub-dollar
    prices is not exact, and then the order matters as it does in XLA.
    XLA's float32 sum differs from the exact one by at most a few ulps,
    which can only change the verdict when the two candidates' costs are
    equal to within those ulps (the verdict compares unplaced pods and node
    counts first); chip_smoke.py prints each verdict's margin on the card."""
    fresh = (state.kind == 2) & (state.podcount > 0)
    nodes = fresh.sum(dtype=torch.int32)
    s = torch.clamp(state.template, min=0).long()
    price = tmpl_price[s].to(torch.float64)
    cost = torch.where(fresh, price, torch.zeros_like(price)).sum()
    return unplaced_bc.sum(dtype=torch.int32), nodes, cost.to(_F32)
