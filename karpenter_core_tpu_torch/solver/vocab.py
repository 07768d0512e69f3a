"""Closed-world vocabulary for one solve.

The reference's Requirement algebra works over unbounded string sets with
complement representation (requirement.go:33-40). On device, every solve
runs against a closed world: the union of label keys/values mentioned by any
pod requirement, NodePool/template requirement, instance type, offering, or
live node in the snapshot (the domain universe the reference provisioner
assembles at provisioner.go:251-283). Under that closed world every
requirement lowers exactly to a boolean mask over the key's value list plus
(concrete?, negative?, gt, lt) scalars — see ops/masks.py for the exactness
argument.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from karpenter_core_tpu_torch.scheduling.requirement import (
    NEGATIVE_OPERATORS,
    Requirement,
)
from karpenter_core_tpu_torch.scheduling.requirements import Requirements

# Sentinel integer bounds (ops compare with >=; values are label-value ints,
# well inside these).
GT_NONE = -(2**30)
LT_NONE = 2**30


class Vocab:
    """Interner for label keys and per-key value domains."""

    def __init__(self):
        self.keys: Dict[str, int] = {}
        self.key_names: List[str] = []
        self.values: List[Dict[str, int]] = []  # per key: value -> vid
        self.value_names: List[List[str]] = []

    def key_id(self, key: str) -> int:
        kid = self.keys.get(key)
        if kid is None:
            kid = len(self.key_names)
            self.keys[key] = kid
            self.key_names.append(key)
            self.values.append({})
            self.value_names.append([])
        return kid

    def value_id(self, key: str, value: str) -> int:
        kid = self.key_id(key)
        vocab = self.values[kid]
        vid = vocab.get(value)
        if vid is None:
            vid = len(self.value_names[kid])
            vocab[value] = vid
            self.value_names[kid].append(value)
        return vid

    def observe_requirements(self, reqs: Requirements) -> None:
        # canonical observation order: key/value ids are POSITIONAL, so two
        # observers walking the same logical requirements in different dict/
        # set orders would otherwise mint different id assignments — and
        # with them different FrozenVocab.fingerprint()s for the same
        # closed world (the prepared-state cache key)
        for key, req in sorted(reqs.items()):
            self.key_id(key)
            for v in sorted(req.values):
                self.value_id(key, v)

    def observe_labels(self, labels: dict) -> None:
        for k, v in sorted(labels.items()):
            self.value_id(k, v)

    @property
    def num_keys(self) -> int:
        return len(self.key_names)

    @property
    def max_values(self) -> int:
        return max((len(v) for v in self.value_names), default=1)

    def finalize(self) -> "FrozenVocab":
        K = self.num_keys
        V = max(self.max_values, 1)
        # integer value of each vocab entry (for Gt/Lt masks); NaN-free:
        # non-integer values get LT_NONE so no bound ever admits them.
        int_values = np.full((K, V), LT_NONE, dtype=np.int64)
        valid = np.zeros((K, V), dtype=bool)
        for kid, names in enumerate(self.value_names):
            for vid, name in enumerate(names):
                valid[kid, vid] = True
                try:
                    int_values[kid, vid] = int(name)
                except ValueError:
                    pass
        return FrozenVocab(
            keys=dict(self.keys),
            key_names=list(self.key_names),
            values=[dict(v) for v in self.values],
            value_names=[list(v) for v in self.value_names],
            K=K,
            V=V,
            int_values=int_values,
            valid=valid,
        )


@dataclass
class FrozenVocab:
    keys: Dict[str, int]
    key_names: List[str]
    values: List[Dict[str, int]]
    value_names: List[List[str]]
    K: int
    V: int
    int_values: np.ndarray  # [K, V] int64 (LT_NONE for non-integer values)
    valid: np.ndarray  # [K, V] bool — padded slots are False
    well_known_mask: np.ndarray = field(default=None)  # [K] set by encoder

    def fingerprint(self) -> tuple:
        """Structural identity of the closed world: same keys, same values,
        same id assignment. Two solves whose vocabs share a fingerprint can
        share every tensor encoded over the vocab (the prepared-state cache
        key in models/provisioner); building vocabs in canonical sorted
        order (see models/provisioner._build_vocab) makes the fingerprint
        stable across drifting pod mixes with the same label universe."""
        return (
            tuple(self.key_names),
            tuple(tuple(names) for names in self.value_names),
        )


@dataclass
class EntityMasks:
    """Requirement tensors for N entities over a FrozenVocab.

    mask[n,k,v]   — entity n allows value v for key k (Requirement.has under
                    the closed world; includes own Gt/Lt filtering)
    defines[n,k]  — key k present in the entity's Requirements map
    concrete[n,k] — non-complement representation (op In / DoesNotExist)
    negative[n,k] — operator() ∈ {NotIn, DoesNotExist}
    gt/lt[n,k]    — integer bounds with GT_NONE/LT_NONE sentinels
    """

    mask: np.ndarray  # [N, K, V] bool
    defines: np.ndarray  # [N, K] bool
    concrete: np.ndarray  # [N, K] bool
    negative: np.ndarray  # [N, K] bool
    gt: np.ndarray  # [N, K] int32
    lt: np.ndarray  # [N, K] int32

    @property
    def n(self) -> int:
        return self.mask.shape[0]


def encode_requirements_batch(
    vocab: FrozenVocab, batch: List[Requirements]
) -> EntityMasks:
    """Lower a batch of Requirements to mask tensors. The vocab must already
    have observed every requirement in the batch."""
    N, K, V = len(batch), vocab.K, vocab.V
    mask = np.zeros((N, K, V), dtype=bool)
    defines = np.zeros((N, K), dtype=bool)
    concrete = np.zeros((N, K), dtype=bool)
    negative = np.zeros((N, K), dtype=bool)
    gt = np.full((N, K), GT_NONE, dtype=np.int64)
    lt = np.full((N, K), LT_NONE, dtype=np.int64)

    for n, reqs in enumerate(batch):
        # graftlint: disable=GL201 -- writes land at vocab-assigned kid
        # indices, so iteration order cannot affect the tensors
        for key, req in reqs.items():
            kid = vocab.keys[key]
            defines[n, kid] = True
            concrete[n, kid] = not req.complement
            negative[n, kid] = req.operator() in NEGATIVE_OPERATORS
            if req.greater_than is not None:
                gt[n, kid] = req.greater_than
            if req.less_than is not None:
                lt[n, kid] = req.less_than
            mask[n, kid] = _requirement_mask(vocab, kid, req)
    return EntityMasks(
        mask=mask,
        defines=defines,
        concrete=concrete,
        negative=negative,
        # clamp to the sentinel bounds before narrowing: Gt/Lt bounds come
        # off the solve wire (codec._decode_req) as arbitrary ints, and an
        # unclamped astype WRAPS — a hostile 2**40 bound would flip sign
        # inside the int32 device planes. Within the closed world the
        # clamp is exact: every integer vocab value lies strictly inside
        # (GT_NONE, LT_NONE), so a bound at/beyond a sentinel admits (or
        # excludes) exactly the same values the raw bound would, and the
        # host-side mask above already folded the raw bound exactly.
        gt=np.clip(gt, GT_NONE, LT_NONE).astype(np.int32),
        lt=np.clip(lt, GT_NONE, LT_NONE).astype(np.int32),
    )


def decode_requirements(
    vocab: FrozenVocab,
    valmask_row: np.ndarray,  # [K, V] bool
    defines_row: np.ndarray,  # [K] bool
    complement_row: np.ndarray,  # [K] bool
    gt_row: np.ndarray,  # [K] int32
    lt_row: np.ndarray,  # [K] int32
) -> "Requirements":
    """Inverse of encode_requirements_batch for one entity row.

    Rebuilds host Requirements from the device slot planes — used by the
    decode path to materialize a fresh claim's joined requirements (template
    ∧ joined classes ∧ topology tightenings) without replaying the host
    algebra per add. Exact within the closed world: a complement row's
    excluded set is reconstructed as the vocab values the mask rejects that
    the Gt/Lt bounds alone would admit, so ``has()`` agrees with the
    original for every value any solve entity can mention."""
    from karpenter_core_tpu_torch.scheduling.requirement import _within

    reqs = Requirements()
    for kid in np.nonzero(defines_row)[0]:
        key = vocab.key_names[kid]
        names = vocab.value_names[kid]
        gt = int(gt_row[kid])
        lt = int(lt_row[kid])
        gt_o = gt if gt != GT_NONE else None
        lt_o = lt if lt != LT_NONE else None
        mask = valmask_row[kid]
        if not complement_row[kid]:
            vals = {names[v] for v in np.nonzero(mask[: len(names)])[0]}
            reqs.add(Requirement(key, values=vals))
        else:
            excl = {
                names[v]
                for v in range(len(names))
                if not mask[v] and _within(names[v], gt_o, lt_o)
            }
            reqs.add(
                Requirement(
                    key,
                    complement=True,
                    values=excl,
                    greater_than=gt_o,
                    less_than=lt_o,
                )
            )
    return reqs


def _requirement_mask(vocab: FrozenVocab, kid: int, req: Requirement) -> np.ndarray:
    """mask[v] = req.has(value_names[kid][v]) vectorized."""
    V = vocab.V
    out = np.zeros((V,), dtype=bool)
    names = vocab.value_names[kid]
    if req.complement:
        out[: len(names)] = True
        for v in req.values:
            vid = vocab.values[kid].get(v)
            if vid is not None:
                out[vid] = False
    else:
        for v in req.values:
            vid = vocab.values[kid].get(v)
            if vid is not None:
                out[vid] = True
    if req.greater_than is not None or req.less_than is not None:
        ints = vocab.int_values[kid]
        bound_ok = np.ones((V,), dtype=bool)
        if req.greater_than is not None:
            bound_ok &= ints > req.greater_than
        if req.less_than is not None:
            bound_ok &= ints < req.less_than
        # non-integer vocab entries carry LT_NONE and fail any gt bound /
        # pass lt trivially — force them out explicitly
        bound_ok &= ints != LT_NONE
        out &= bound_ok
    out &= vocab.valid[kid]
    return out
