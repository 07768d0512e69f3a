"""The port's prepare-phase mask ops against the JAX package's, exactly.

Inputs are made from a numpy seed and handed to both. One more case runs
``compatible`` at a value-vocab width of 300 against a numpy set-algebra
oracle: the port's overlap count is exact for any width (the JAX package's
bf16 product is exact only up to 256).
"""
import numpy as np
import pytest
import torch

from karpenter_core_tpu.ops import masks as jmasks
from karpenter_core_tpu_torch.ops import masks as tmasks
from tests.torch_threads import one_torch_thread  # noqa: F401

GT_NONE = np.iinfo(np.int32).min
LT_NONE = np.iinfo(np.int32).max


def planes(rng, n, K, V):
    mask = rng.random((n, K, V)) < 0.4
    defines = rng.random((n, K)) < 0.6
    concrete = rng.random((n, K)) < 0.7
    negative = rng.random((n, K)) < 0.2
    gt = np.where(rng.random((n, K)) < 0.3, rng.integers(0, 8, (n, K)),
                  GT_NONE).astype(np.int32)
    lt = np.where(rng.random((n, K)) < 0.3, rng.integers(4, 12, (n, K)),
                  LT_NONE).astype(np.int32)
    return mask, defines, concrete, negative, gt, lt


def _t(*xs):
    return [torch.tensor(x) for x in xs]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("custom_rule", [True, False])
def test_compatible_matches_jax(seed, custom_rule):
    rng = np.random.default_rng(seed)
    K, V = 6, 9
    inc = planes(rng, 7, K, V)
    rec = planes(rng, 5, K, V)
    well_known = rng.random(K) < 0.5
    ref = np.asarray(jmasks.compatible(*inc, *rec, well_known,
                                       custom_rule=custom_rule))
    got = tmasks.compatible(*_t(*inc), *_t(*rec), torch.tensor(well_known),
                            custom_rule=custom_rule).numpy()
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


@pytest.mark.parametrize("seed", range(3))
def test_intersects_matches_jax(seed):
    rng = np.random.default_rng(10 + seed)
    inc = planes(rng, 6, 5, 7)
    rec = planes(rng, 8, 5, 7)
    ref = np.asarray(jmasks.intersects(*inc, *rec))
    got = tmasks.intersects(*_t(*inc), *_t(*rec)).numpy()
    assert np.array_equal(got, ref)


def test_tolerates_matches_jax():
    rng = np.random.default_rng(3)
    taints = rng.random((6, 4)) < 0.4
    tol = rng.random((9, 4)) < 0.5
    ref = np.asarray(jmasks.tolerates(taints, tol))
    got = tmasks.tolerates(*_t(taints, tol)).numpy()
    assert np.array_equal(got, ref)


def test_fits_matches_jax():
    rng = np.random.default_rng(4)
    req = rng.integers(0, 6, (7, 4)).astype(np.float32)
    alloc = rng.integers(-1, 8, (5, 4)).astype(np.float32)
    ref = np.asarray(jmasks.fits(req, alloc))
    got = tmasks.fits(*_t(req, alloc)).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("seed", range(4))
def test_fresh_viability_matches_jax(seed):
    rng = np.random.default_rng(20 + seed)
    C, S, T, Z, CT, R = 9, 3, 17, 3, 2, 4
    args = (
        rng.random((C, T)) < 0.7,  # class_it
        rng.random((C, S)) < 0.8,  # tmpl_ok
        rng.random((S, T)) < 0.7,  # tmpl_it
        rng.random((C, Z)) < 0.7,  # class_zmask
        rng.random((C, CT)) < 0.8,  # class_ctmask
        rng.random((S, Z)) < 0.8,  # tmpl_zmask
        rng.random((S, CT)) < 0.8,  # tmpl_ctmask
        rng.random((T, Z, CT)) < 0.5,  # off_avail
        rng.integers(0, 64000, (T, R)).astype(np.float32),  # it_alloc
        rng.integers(0, 900, (S, R)).astype(np.float32),  # tmpl_overhead
        np.where(rng.random((C, R)) < 0.3, 0,
                 rng.integers(1, 9000, (C, R))).astype(np.float32),
    )
    nt_ref, ks_ref = (np.asarray(x) for x in jmasks.fresh_viability(*args))
    nt, ks = tmasks.fresh_viability(*_t(*args))
    assert nt.dtype == torch.int32 and ks.dtype == torch.int32
    assert np.array_equal(nt.numpy(), nt_ref)
    assert np.array_equal(ks.numpy(), ks_ref)


def _oracle_compatible(inc, rec, well_known):
    """Requirements.Compatible by explicit set algebra, pair by pair."""
    im, idf, ic, ineg, igt, ilt = inc
    rm, rdf, rc, rneg, rgt, rlt = rec
    N, K, _ = im.shape
    M = rm.shape[0]
    ok = np.ones((N, M), dtype=bool)
    for n in range(N):
        for m in range(M):
            for k in range(K):
                values = set(np.flatnonzero(im[n, k])) & set(
                    np.flatnonzero(rm[m, k]))
                if ic[n, k] or rc[m, k]:
                    empty = not values
                else:
                    empty = max(igt[n, k], rgt[m, k]) >= min(ilt[n, k],
                                                             rlt[m, k])
                rule2 = (idf[n, k] and rdf[m, k] and empty
                         and not (ineg[n, k] and rneg[m, k]))
                rule1 = (idf[n, k] and not ineg[n, k] and not rdf[m, k]
                         and not well_known[k])
                if rule1 or rule2:
                    ok[n, m] = False
    return ok


def test_compatible_exact_at_wide_vocab():
    rng = np.random.default_rng(7)
    K, V = 3, 300
    inc = list(planes(rng, 5, K, V))
    rec = list(planes(rng, 4, K, V))
    # dense rows: overlaps of up to ~300 values, and one disjoint pair
    inc[0] = rng.random((5, K, V)) < 0.97
    rec[0] = rng.random((4, K, V)) < 0.97
    inc[0][0, 0] = np.arange(V) % 2 == 0
    rec[0][0, 0] = np.arange(V) % 2 == 1
    inc[1][0, 0] = rec[1][0, 0] = inc[2][0, 0] = True
    well_known = np.array([True, False, True])
    got = tmasks.compatible(*_t(*inc), *_t(*rec),
                            torch.tensor(well_known)).numpy()
    assert np.array_equal(got, _oracle_compatible(inc, rec, well_known))
    assert not got[0, 0]
