"""Prepare-phase feasibility as tensor ops, plain PyTorch.

Port of ``karpenter_core_tpu/ops/masks.py`` (XLA ops there, torch ops
here; none of them is a hand kernel). ``compatible`` evaluates
``Requirements.Compatible`` for every (incoming, receiver) pair under the
closed world of ``solver/vocab.py``:

* Rule 1 (custom labels): the incoming side defines a non-well-known key
  with a positive operator that the receiver does not define.
* Rule 2 (intersects, keys both define): the intersection is empty when
  one side is a concrete set and the vocab masks do not overlap, or both
  are complements whose merged Gt/Lt bounds cross; both-negative pairs are
  exempt.

The per-key overlap is a batched float32 product of 0/1 masks. Its sums
are integers below 2^24, so it is exact for any value-vocab width V (the
JAX package's bf16 product is exact only up to V = 256), provided no
TF32 rounding reaches it: ``_exact_products`` turns TF32 off for CUDA
matrix products before every product here.

``gang_joint_templates`` narrows template viability to what every member
of a same-template gang admits: an integer segment-AND (segment min over
int32), no float.
"""
from __future__ import annotations

import torch


def _exact_products() -> None:
    """Full-float32 CUDA matrix products: TF32 would round 0/1 sums above
    2^11 and break the exact overlap counts."""
    torch.backends.cuda.matmul.allow_tf32 = False


def compatible(
    inc_mask,
    inc_defines,
    inc_concrete,
    inc_negative,
    inc_gt,
    inc_lt,
    rec_mask,
    rec_defines,
    rec_concrete,
    rec_negative,
    rec_gt,
    rec_lt,
    well_known,
    custom_rule: bool = True,
):
    """Pairwise compatibility of incoming [N, K, V] / [N, K] planes against
    receiver [M, K, V] / [M, K] planes; well_known [K] bool. Returns ok
    [N, M] bool."""
    _exact_products()
    a = inc_mask.permute(1, 0, 2).to(torch.float32)  # [K, N, V]
    b = rec_mask.permute(1, 2, 0).to(torch.float32)  # [K, V, M]
    overlap = torch.bmm(a, b) > 0  # [K, N, M]
    overlap = overlap.permute(1, 2, 0)  # [N, M, K]

    both = inc_defines[:, None, :] & rec_defines[None, :, :]  # [N, M, K]
    either_concrete = inc_concrete[:, None, :] | rec_concrete[None, :, :]
    crossed = torch.maximum(inc_gt[:, None, :], rec_gt[None, :, :]) >= (
        torch.minimum(inc_lt[:, None, :], rec_lt[None, :, :])
    )
    empty = torch.where(either_concrete, ~overlap, crossed)
    both_negative = inc_negative[:, None, :] & rec_negative[None, :, :]
    rule2 = both & empty & ~both_negative

    if custom_rule:
        rule1 = (
            inc_defines[:, None, :]
            & ~inc_negative[:, None, :]
            & ~rec_defines[None, :, :]
            & ~well_known[None, None, :]
        )
        bad = rule1 | rule2
    else:
        bad = rule2
    return ~torch.any(bad, dim=-1)


def intersects(
    inc_mask, inc_defines, inc_concrete, inc_negative, inc_gt, inc_lt,
    rec_mask, rec_defines, rec_concrete, rec_negative, rec_gt, rec_lt,
):
    """Pairwise Requirements.Intersects (rule 2 only)."""
    return compatible(
        inc_mask, inc_defines, inc_concrete, inc_negative, inc_gt, inc_lt,
        rec_mask, rec_defines, rec_concrete, rec_negative, rec_gt, rec_lt,
        well_known=torch.zeros(
            inc_mask.shape[1], dtype=torch.bool, device=inc_mask.device
        ),
        custom_rule=False,
    )


def tolerates(entity_taints, pod_tolerates_taint):
    """ok[n, m] = every taint of entity m [M, TA] is tolerated by class n
    [N, TA]."""
    untolerated = entity_taints[None, :, :] & ~pod_tolerates_taint[:, None, :]
    return ~torch.any(untolerated, dim=-1)


def fits(requests, allocatable):
    """ok [N, M] = all-dims requests [N, R] <= allocatable [M, R]; negative
    allocatable never fits."""
    ok = torch.all(requests[:, None, :] <= allocatable[None, :, :], dim=-1)
    return ok & torch.all(allocatable >= 0, dim=-1)[None, :]


def gang_joint_templates(tmpl_ok, gang_id, num_gangs: int):
    """Same-node-template gang co-location as a mask tensor: AND-reduce
    class x template viability within each gang so every member class sees
    only templates EVERY member could open fresh nodes from (the first
    member's choice then binds the gang, since fresh_viability is
    first-template-wins over the joint mask).

    tmpl_ok: [C, S] bool — per-class template viability (compat and taints)
    gang_id: [C] int32 — index of the class's same-template gang, -1 for
             classes outside any such gang (their rows pass through)
    Returns the narrowed [C, S] mask."""
    member = gang_id >= 0
    gid = torch.clamp(gang_id, min=0).long()
    ok_i = torch.where(
        member[:, None], tmpl_ok.to(torch.int32),
        torch.ones_like(tmpl_ok, dtype=torch.int32),
    )
    # segment_min with JAX's identity for empty segments (int32 max)
    joint_g = torch.full(
        (max(num_gangs, 1), tmpl_ok.shape[1]), torch.iinfo(torch.int32).max,
        dtype=torch.int32, device=tmpl_ok.device,
    ).scatter_reduce(
        0, gid[:, None].expand(-1, tmpl_ok.shape[1]), ok_i, reduce="amin",
    )
    joint = joint_g[gid] > 0
    return torch.where(member[:, None], tmpl_ok & joint, tmpl_ok)


def fresh_viability(
    class_it,  # [C, T] bool — class x instance-type compat (intersects)
    tmpl_ok,  # [C, S] bool — class x template compat AND taint tolerance
    tmpl_it,  # [S, T] bool — template's prefiltered instance types
    class_zmask,  # [C, Z] bool — class allowed zones
    class_ctmask,  # [C, CT] bool
    tmpl_zmask,  # [S, Z] bool
    tmpl_ctmask,  # [S, CT] bool
    off_avail,  # [T, Z, CT] bool — offering availability lattice
    it_alloc,  # [T, R] float32 (quantized integer units)
    tmpl_overhead,  # [S, R] float32 — daemon overhead per template
    class_requests,  # [C, R] float32
):
    """Per-class fresh-node viability: the first workable template and the
    max pods per fresh node on its best instance type. Returns
    (new_template [C] int32, -1 when no template works; kstar [C] int32).
    The floor arithmetic matches ops/ffd._k_max exactly."""
    _exact_products()
    T = off_avail.shape[0]
    C, S = tmpl_ok.shape
    viable = tmpl_it[None, :, :] & class_it[:, None, :]  # [C, S, T]
    zjoin = class_zmask[:, None, :] & tmpl_zmask[None, :, :]  # [C, S, Z]
    ctjoin = class_ctmask[:, None, :] & tmpl_ctmask[None, :, :]  # [C, S, CT]
    joined = (zjoin[:, :, :, None] & ctjoin[:, :, None, :]).to(torch.float32)
    off_flat = off_avail.to(torch.float32).reshape(T, -1)  # [T, Z*CT]
    off_ok = (joined.reshape(C * S, -1) @ off_flat.T).reshape(C, S, T) > 0
    head = it_alloc[None, :, :] - tmpl_overhead[:, None, :]  # [S, T, R]
    r = class_requests  # [C, R]
    safe_r = torch.where(r > 0, r, torch.ones_like(r))
    inf = torch.full((), float("inf"), dtype=torch.float32, device=r.device)
    k_min = torch.full((C,) + head.shape[:2], float("inf"),
                       dtype=torch.float32, device=r.device)  # [C, S, T]
    for ri in range(r.shape[1]):  # R is small
        ratio_r = head[None, :, :, ri] / safe_r[:, None, None, ri]
        ratio_r = torch.where(r[:, None, None, ri] > 0, ratio_r, inf)
        k_min = torch.minimum(k_min, ratio_r)
    k_it = torch.floor(k_min)  # [C, S, T]
    ok = viable & off_ok & tmpl_ok[:, :, None]
    k_s = torch.amax(
        torch.where(ok, k_it, torch.full_like(k_it, -1.0)), dim=-1
    )  # [C, S]
    has = k_s >= 1.0
    any_has = torch.any(has, dim=1)
    first_s = torch.argmax(has.to(torch.int32), dim=1)  # first True
    new_template = torch.where(
        any_has, first_s.to(torch.int32), torch.full_like(first_s, -1).to(torch.int32)
    )
    kstar = torch.where(
        any_has,
        torch.gather(k_s, 1, first_s[:, None])[:, 0],
        torch.zeros_like(k_s[:, 0]),
    )
    return new_template, torch.clamp(kstar, 0, float(2**30)).to(torch.int32)
