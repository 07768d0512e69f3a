"""The least time the card could take for an FFD scan launch.

A frozen copy of the port's bound arithmetic (``chip_smoke._bound_terms``
and ``_stack_bound``; ``ops/cuda_ffd.PEAK_*``): the larger of every input
and output byte once over the card's memory bandwidth, and the float32
operations the inputs need (open slots x compatible types x (3R + 2) a
step) over the float32 peak outside the tensor cores. Peaks are NVIDIA's
data sheet for one H100 SXM at its full 700 W; the run prints the card's
power limit beside them.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

import torch

PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree if x is not None)


def _stored_bytes(*trees) -> int:
    """Bytes of the leaves, a leaf expanded with stride 0 over its leading
    axis counted once."""
    def one(x):
        if x.dim() and x.shape[0] > 1 and x.stride(0) == 0:
            x = x[0]
        return x.numel() * x.element_size()

    return sum(one(x) for t in trees for x in t if x is not None)


def _row(tree, b: int):
    return type(tree)(*(None if x is None else x[b] for x in tree))


def scan_ops(kind0: torch.Tensor, class_it: torch.Tensor, R: int,
             takes: torch.Tensor) -> float:
    """Float32 operations of one problem's scan: each step works on the
    slots open at its start (existing ones from the first step, a fresh
    one from the step that first puts pods on it) against the class's
    compatible types, (3R + 2) operations each."""
    J, N = takes.shape
    took = takes > 0
    first = torch.where(took.any(0), took.int().argmax(0),
                        torch.full((N,), J, device=takes.device))
    first = torch.where(kind0 > 0, torch.zeros_like(first), first)
    opened = torch.bincount(first.clamp(max=J), minlength=J + 1)[:J]
    open_before = torch.cumsum(opened, 0)
    types = class_it.sum(1)
    return float((open_before * types).sum()) * (3 * R + 2)


def solo_terms(init, steps, statics, state, takes, unplaced
               ) -> Tuple[int, float]:
    """(bytes, operations) of one solo scan at the wrapper's interface."""
    moved = (_nbytes(init) + _nbytes(steps) + _nbytes(statics)
             + _nbytes(state) + takes.numel() * 4 + unplaced.numel() * 4)
    return moved, scan_ops(init.kind, steps.class_it,
                           init.requests.shape[1], takes)


def stack_terms(kind0, steps, statics, state, takes, unplaced
                ) -> Tuple[int, float]:
    """(bytes, operations) of a stacked scan at its own interface: each
    row's slot state read and written as the kernel holds it (its plane
    packed), a leaf shared over the rows read once."""
    ops = sum(scan_ops(kind0[b], _row(steps, b).class_it,
                       state.requests.shape[-1], takes[b])
              for b in range(takes.shape[0]))
    moved = (2 * _nbytes(state) + _stored_bytes(steps, statics)
             + takes.numel() * 4 + unplaced.numel() * 4)
    return moved, ops


def bound_s(terms: Iterable[Tuple[int, float]]) -> Tuple[float, str]:
    """The least seconds for launches with these (bytes, operations), and
    which peak binds."""
    terms: List = list(terms)
    t_bytes = sum(t[0] for t in terms) / PEAK_BYTES_S
    t_ops = sum(t[1] for t in terms) / PEAK_F32_OPS_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
