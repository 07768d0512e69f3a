"""Priority-preemptive packing and gang-atomic placement, plain PyTorch.

Port of ``karpenter_core_tpu/ops/gangsched.py``. The FFD scan
(``ops/ffd.py``) packs a flat bag of pod classes; this layer adds:

* **Gang atomicity** — ``gang_of_step`` maps scan steps to gangs and
  ``gang_min`` carries each gang's min-count. ``gang_solve`` runs the scan,
  measures each gang's placed count and rolls back every gang below its
  min: requirement-plane intersections cannot be un-merged, so the
  rollback is a second scan from the same init state with the failed
  gangs' counts zeroed. JAX gates the second scan with ``lax.cond``; here
  one host read of "did any gang fail" decides it, so a solve runs one
  scan when every gang commits and two when one does not. A second-order
  cascade (a gang that only committed because a failed gang's takes
  warped later placements) is caught by a final mask: its takes zero and
  the whole group reports unplaced.
* **Priority tiers with simulated preemption** — ``preempt_pass`` treats
  strictly-lower-tier pods bound on existing nodes as evictable capacity
  for still-unplaced positive-tier, gang-free classes: per node, the
  cheapest sufficient prefix of its cost-ordered evictable pods is priced
  (cumulative freed capacity -> pods admitted), and nodes are claimed
  cheapest-cost-per-admitted-pod first, at most ``NODE_ROUNDS`` a class.

``gang_solve_with``, ``gang_solve_batched_with`` and
``gang_solve_sharded_with`` take the scan function, so the kernel route
(``ops/cuda_ffd.cuda_gang_solve[_sharded]``) runs the same
rollback and guard around the hand kernel. The preemption pass is
torch ops on the device (the JAX package lowers it through XLA, with no
Pallas kernel). Its float carry is bit-equal to the JAX package's: the
small evictable-pod axis P is summed in one fixed left-to-right order (the
order of XLA's ``reduce_window`` cumsum), never by a parallel scan, and
``argmin`` ties take the first index as ``jnp.argmin`` does. Steps that
the host knows are disabled (tier <= 0, or in a gang) take nothing and
change no carry, so the class loop skips them; no host read sits inside
the loops. ``preempt_pass_batched`` walks every row in one pass, as the
JAX package's ``vmap`` does (its op count does not grow with B), and the
solo pass is its one-row case.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from karpenter_core_tpu_torch.ops.ffd import (
    BIG,
    LEVEL_ITERS,
    ClassStep,
    FFDStatics,
    SlotState,
    _class_slot_compatible,
    _isum,
    ffd_solve,
    ffd_solve_batched,
)
from karpenter_core_tpu_torch.solver.gangs import GANG_FREE

# Preemption fan-out bound: one class's remaining pods spread over at most
# this many preempted nodes a solve; wider demand stays unschedulable
NODE_ROUNDS = 8

_I32 = torch.int32
_F32 = torch.float32


class EvPlanes(NamedTuple):
    """Evictable bound pods per existing slot, cost-sorted ((disruption
    cost, uid) ascending), the pod axis padded to P; masked by tier at
    use."""

    req: torch.Tensor  # [N, P, R] float32 — quantized freed-capacity vectors
    tier: torch.Tensor  # [N, P] int32 (pad: BIGI — never strictly lower)
    cost: torch.Tensor  # [N, P] float32 — utils/disruption.eviction_cost
    valid: torch.Tensor  # [N, P] bool


# ---------------------------------------------------------------------------
# gang-atomic solve


def _gang_failures(takes, gang_of_step, gang_min):
    """[..., G] bool — gangs whose placed count missed their min (any
    leading problem axes). Padded gangs carry min 0 and never fail."""
    G = gang_min.shape[-1]
    placed_step = _isum(takes, dim=-1)  # [..., J]
    seg = torch.where(
        gang_of_step >= 0, gang_of_step, torch.full_like(gang_of_step, G)
    ).long()
    placed_g = torch.zeros(
        (*placed_step.shape[:-1], G + 1), dtype=_I32, device=takes.device
    ).scatter_add_(-1, seg, placed_step)[..., :G]
    return placed_g < gang_min


def _step_failed(takes, gang_of_step, gang_min):
    """[..., J] bool — steps of a kernel gang (index >= 0) that failed."""
    failed = _gang_failures(takes, gang_of_step, gang_min)
    at = failed.gather(-1, torch.clamp(gang_of_step, min=0).long())
    return (gang_of_step >= 0) & at


def _guard(classes, gang_of_step, gang_min, step_failed, takes, unplaced):
    """The cascade guard: a gang that fails after the rollback has its
    takes zeroed too, and every dropped gang reports its class count
    unplaced on the class's (sub_)last step."""
    dropped = step_failed | _step_failed(takes, gang_of_step, gang_min)
    takes = torch.where(dropped[..., None], torch.zeros_like(takes), takes)
    unplaced = torch.where(
        dropped,
        torch.where(classes.sub_last, classes.count,
                    torch.zeros_like(classes.count)),
        unplaced,
    )
    return takes, unplaced


def gang_solve_with(solve, state: SlotState, classes: ClassStep,
                    statics: FFDStatics, gang_of_step, gang_min,
                    level_iters: int = LEVEL_ITERS):
    """The gang-atomic scan around ``solve`` (a scan that leaves its input
    state untouched): returns (final state, takes [J, N], unplaced [J])."""
    final, takes, unplaced = solve(state, classes, statics, level_iters)
    step_failed = _step_failed(takes, gang_of_step, gang_min)
    if bool(step_failed.any()):  # the one host read: roll back?
        classes2 = classes._replace(count=torch.where(
            step_failed, torch.zeros_like(classes.count), classes.count))
        final, takes, unplaced = solve(state, classes2, statics, level_iters)
    takes, unplaced = _guard(classes, gang_of_step, gang_min, step_failed,
                             takes, unplaced)
    return final, takes, unplaced


def gang_solve_batched_with(solve_batched, state: SlotState,
                            classes: ClassStep, statics: FFDStatics,
                            gang_of_step, gang_min,
                            level_iters: int = LEVEL_ITERS):
    """``gang_solve_with`` over stacked problems (every leaf with a leading
    [B]): when any row's gang fails, the whole stack is scanned again with
    each row's failed counts zeroed, and each row that failed takes the
    second scan (a row with no failure scans its unchanged inputs again,
    and keeps its first answer), so every row equals its solo answer."""
    return gang_solve_sharded_with(
        solve_batched, [(state, classes, statics, gang_of_step, gang_min)],
        level_iters)[0]


def gang_solve_sharded_with(solve_batched, shards, level_iters=LEVEL_ITERS):
    """``gang_solve_batched_with`` over the shards of a problem axis, each
    a (state, classes, statics, gang_of_step, gang_min) tuple on its own
    device: every shard's first scan is launched before the first host
    read, so the devices scan together; then each shard decides its
    rollback scan. Returns each shard's (final, takes, unplaced)."""
    firsts = [solve_batched(st, cl, stc, level_iters)
              for st, cl, stc, _g, _m in shards]
    return [_gang_finish_batched(solve_batched, first, *shard, level_iters)
            for first, shard in zip(firsts, shards)]


def _gang_finish_batched(solve_batched, first, state, classes, statics,
                         gang_of_step, gang_min, level_iters):
    """The rollback and the guard after a stack's first scan."""
    final, takes, unplaced = first
    step_failed = _step_failed(takes, gang_of_step, gang_min)  # [B, J]
    row_failed = step_failed.any(dim=1)
    if bool(row_failed.any()):  # the one host read: roll back?
        classes2 = classes._replace(count=torch.where(
            step_failed, torch.zeros_like(classes.count), classes.count))
        final2, takes2, unplaced2 = solve_batched(state, classes2, statics,
                                                  level_iters)

        def pick(a2, a1):
            sel = row_failed.view(-1, *([1] * (a1.dim() - 1)))
            return torch.where(sel, a2, a1)

        final = SlotState(*(pick(a2, a1) for a2, a1 in zip(final2, final)))
        takes = pick(takes2, takes)
        unplaced = pick(unplaced2, unplaced)
    takes, unplaced = _guard(classes, gang_of_step, gang_min, step_failed,
                             takes, unplaced)
    return final, takes, unplaced


def gang_solve(state: SlotState, classes: ClassStep, statics: FFDStatics,
               gang_of_step, gang_min, level_iters: int = LEVEL_ITERS):
    """The plain gang-atomic solve (``ffd_solve`` scans). The input state is
    not modified."""
    return gang_solve_with(ffd_solve, state, classes, statics, gang_of_step,
                           gang_min, level_iters)


def gang_solve_batched(state: SlotState, classes: ClassStep,
                       statics: FFDStatics, gang_of_step, gang_min,
                       level_iters: int = LEVEL_ITERS):
    """The plain gang-atomic solve over stacked problems
    (``ffd_solve_batched`` scans). The input state is not modified."""
    return gang_solve_batched_with(ffd_solve_batched, state, classes,
                                   statics, gang_of_step, gang_min,
                                   level_iters)


def gang_solve_sharded(shards, level_iters: int = LEVEL_ITERS):
    """The plain gang-atomic solve over the shards of a problem axis
    (``gang_solve_sharded_with`` with ``ffd_solve_batched`` scans)."""
    return gang_solve_sharded_with(ffd_solve_batched, shards, level_iters)


# ---------------------------------------------------------------------------
# the preemption pass


def _node_prefix_fit(avail, elig, req, cost, r):
    """Every node's eviction price curve: cumulative freed capacity over
    the cost-ordered eligible prefix -> (kfit [..., N, P+1] pods admitted
    after evicting the first j, cost0 [..., N, P+1] cumulative cost of
    that prefix); j = 0 is the eviction-free residual fit. Leading problem
    axes broadcast (r: [..., R]). The P axis is summed left to right, one
    element at a time."""
    P = elig.shape[-1]
    req_e = torch.where(elig[..., None], req, 0.0)  # [..., N, P, R]
    cost_e = torch.where(elig, cost, 0.0)  # [..., N, P]
    run_f = torch.zeros_like(avail)  # [..., N, R]
    run_c = torch.zeros_like(cost[..., 0])  # [..., N]
    freed, costs = [run_f], [run_c]
    for p in range(P):
        run_f = run_f + req_e[..., p, :]
        run_c = run_c + cost_e[..., p]
        freed.append(run_f)
        costs.append(run_c)
    freed0 = torch.stack(freed, dim=-2)  # [..., N, P+1, R]
    cost0 = torch.stack(costs, dim=-1)  # [..., N, P+1]
    r = r[..., None, None, :]
    pos = r > 0
    safe_r = torch.where(pos, r, 1.0)
    head = (avail[..., None, :] + freed0) / safe_r
    head = torch.where(pos, head, float(BIG))
    kfit = torch.floor(torch.amin(head, dim=-1))
    return torch.clamp(kfit, 0.0, float(2**30)).to(_I32), cost0


def _lead(tree):
    """``tree`` with a leading problem axis of one row."""
    return type(tree)(*(None if x is None else x[None] for x in tree))


def preempt_pass(state: SlotState, classes: ClassStep, statics: FFDStatics,
                 step_tier, step_gang, unplaced, ev: EvPlanes,
                 node_rounds: int = NODE_ROUNDS):
    """Serve still-unplaced positive-tier gang-free classes from evictable
    capacity, class by class with an (evicted, capacity bonus) carry.
    Returns (extra takes [J, N] int32, unplaced' [J] int32, evicted [N, P]
    bool) exactly as the JAX package's ``preempt_pass``: the one-row case
    of ``preempt_pass_batched``."""
    out = _preempt_rows(
        _lead(state), _lead(classes), _lead(statics), step_tier[None],
        step_gang[None], unplaced[None], _lead(ev), node_rounds)
    return tuple(x[0] for x in out)


def preempt_pass_batched(state: SlotState, classes: ClassStep,
                         statics: FFDStatics, step_tier, step_gang, unplaced,
                         ev: EvPlanes, node_rounds: int = NODE_ROUNDS):
    """``preempt_pass`` over stacked problems (every leaf with a leading
    [B]), all rows in one walk of the class axis, as JAX's vmap: (extra
    takes [B, J, N], unplaced' [B, J], evicted [B, N, P])."""
    return _preempt_rows(state, classes, statics, step_tier, step_gang,
                         unplaced, ev, node_rounds)


def _preempt_rows(state, classes, statics, step_tier, step_gang, unplaced,
                  ev, node_rounds):
    """The pass over [B] rows. The walk covers the union of the rows'
    enabled steps (tier > 0 and gang-free; the one host read of the
    call). At a step that is not its own a row takes nothing, and
    ``torch.where`` on ``act`` leaves its carry as it was (its scores may
    be finite or inf; neither reaches the carry)."""
    B, N, P = ev.tier.shape
    dev = state.kind.device
    evicted = torch.zeros((B, N, P), dtype=torch.bool, device=dev)
    bonus = torch.zeros_like(state.requests)  # [B, N, R]
    extra = torch.zeros((B, classes.count.shape[1], N), dtype=_I32,
                        device=dev)
    m_left = unplaced.to(_I32).clone()
    # gang-free is exactly GANG_FREE: GANG_FALLBACK_STRADDLING marks a gang
    # member whose atomicity is host-enforced (solver/gangs.py)
    on = (step_tier > 0) & (step_gang == GANG_FREE)  # [B, J]
    steps = np.nonzero(np.asarray(on.cpu()).any(axis=0))[0]
    if not len(steps):
        return extra, m_left, evicted
    exist = state.kind == 1
    free = state.capacity - state.requests
    slot = torch.arange(N, device=dev)
    pod = torch.arange(P, device=dev)
    zero_i = torch.zeros((), dtype=_I32, device=dev)
    inf = torch.full((), float("inf"), dtype=_F32, device=dev)
    R = state.requests.shape[-1]
    for j in steps.tolist():
        c = ClassStep(*(None if x is None else x[:, j] for x in classes))
        on_j = on[:, j]  # [B]
        m = unplaced[:, j].to(_I32)  # [B]
        ok_node = exist & c.exist_taint_ok & _class_slot_compatible(
            state, c, statics)  # [B, N]
        elig = ev.valid & ~evicted & (ev.tier < step_tier[:, j, None, None])
        kfit, cost0 = _node_prefix_fit(free + bonus, elig, ev.req, ev.cost,
                                       c.requests)
        kfit = torch.where((ok_node & (on_j & (m > 0))[:, None])[..., None],
                           kfit, 0)
        take = torch.zeros((B, N), dtype=_I32, device=dev)
        used = torch.zeros((B, N), dtype=torch.bool, device=dev)
        for _ in range(node_rounds):
            t_full = torch.where(used, zero_i,
                                 torch.minimum(kfit[..., P], m[:, None]))
            # minimal prefix reaching the node's target take (kfit grows
            # with j, so the count of prefixes below target IS the index)
            jneed = torch.clamp(_isum(kfit < t_full[..., None], dim=-1),
                                0, P)
            costn = cost0.gather(-1, jneed.long()[..., None])[..., 0]
            score = torch.where(t_full > 0, costn / t_full.to(_F32), inf)
            n_star = torch.argmin(score, dim=-1, keepdim=True)  # [B, 1]
            t = t_full.gather(1, n_star)[:, 0]
            act = (t > 0) & on_j
            jn = jneed.gather(1, n_star)[:, 0]
            # jneed indexes the physical prefix (ineligible rows add zero),
            # so the evicted set is the eligible pods inside that prefix
            newly = (elig.gather(1, n_star[..., None].expand(B, 1, P))[:, 0]
                     & (pod < jn[:, None]) & act[:, None])  # [B, P]
            hit = slot == n_star  # [B, N]
            evicted = evicted | (hit[..., None] & newly[:, None, :])
            req_n = ev.req.gather(
                1, n_star[..., None, None].expand(B, 1, P, R))[:, 0]
            req_new = torch.where(newly[..., None], req_n, 0.0)  # [B, P, R]
            freed_n = torch.zeros_like(c.requests)  # [B, R]
            for p in range(P):
                freed_n = freed_n + req_new[:, p]
            delta = torch.where(
                act[:, None], freed_n - t.to(_F32)[:, None] * c.requests, 0.0)
            bonus = bonus + torch.where(hit[..., None], delta[:, None, :], 0.0)
            t_act = torch.where(act, t, zero_i)  # [B]
            take = take + torch.where(hit, t_act[:, None], zero_i)
            used = used | (hit & act[:, None])
            m = m - t_act
        extra[:, j] = take
        m_left[:, j] = m
    return extra, m_left, evicted
