"""The host pipeline's per-pair passes (``ops/features``, ``ops/pairs``,
``ops/bounds_update``) held against the JAX package's, on the same numpy
inputs (port of tests/test_ops.py:25-252).

Every result must be bit-equal: the passes are gathers, sorts, max, min,
|a - b| and a + b, which round once and identically in both packages.
The distances are integer-valued (as edit distances are), so ties are
everywhere; the tie cases of the device branches check ROADMAP H1
(lax.top_k's lower-index-first order, kept by stable sorts).
"""

import numpy as np
import pytest
import torch

from annchor_tpu.ops import pairs as jax_pairs
from annchor_tpu.ops.bounds_update import tighten_bounds as jax_tighten
from annchor_tpu.ops.features import anchor_membership as jax_membership
from annchor_tpu.ops.features import bounds_and_dad as jax_bounds
from annchor_tpu.ops.features import shared_anchor_counts as jax_counts
from annchor_tpu_torch.ops import pairs
from annchor_tpu_torch.ops.bounds_update import tighten_bounds
from annchor_tpu_torch.ops.features import (
    anchor_membership,
    bounds_and_dad,
    shared_anchor_counts,
)

torch.set_num_threads(2)

NX = 60


@pytest.fixture(scope="module")
def state():
    """Integer-valued anchor distances and all pairs of 60 points, with
    exact integer distances d (an L1 metric on a small grid)."""
    rng = np.random.default_rng(11)
    P = rng.integers(0, 6, size=(NX, 3))
    A = rng.choice(NX, 7, replace=False)
    D = np.abs(P[:, None, :] - P[None, A, :]).sum(axis=2).astype(np.float64)
    iu = np.triu_indices(NX, k=1)
    IJs = np.stack(iu, axis=1).astype(np.int32)
    d = np.abs(P[IJs[:, 0]] - P[IJs[:, 1]]).sum(axis=1).astype(np.float64)
    return rng, D, IJs, d


def test_bounds_and_dad_bit_equal(state):
    rng, D, IJs, _ = state
    got = bounds_and_dad(D, IJs[:, 0], IJs[:, 1], device="cpu", chunk=4096)
    want = jax_bounds(D, IJs[:, 0], IJs[:, 1])
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, w)
    # query pairs against a second anchor-distance matrix
    QD = D[rng.choice(NX, 10)] + rng.integers(0, 3, size=(10, D.shape[1]))
    I = rng.integers(0, NX, size=40)
    J = rng.integers(0, 10, size=40)
    for g, w in zip(
        bounds_and_dad(D, I, J, DJ=QD, device="cpu"), jax_bounds(D, I, J, DJ=QD)
    ):
        np.testing.assert_array_equal(g, w)
    assert all(a.shape == (0,) for a in bounds_and_dad(D, [], [], device="cpu"))


@pytest.mark.parametrize("locality", [3, 7, 9])
def test_anchor_membership_and_counts_bit_equal(state, locality):
    """Nearest anchors with ties to the lower anchor index (H1); a
    locality above the anchor count means every anchor."""
    _, D, _, _ = state
    S, sid = anchor_membership(D, locality)
    S_j, sid_j = jax_membership(D, locality)
    np.testing.assert_array_equal(sid.numpy(), np.asarray(sid_j))
    np.testing.assert_array_equal(S.numpy(), np.asarray(S_j))
    np.testing.assert_array_equal(
        shared_anchor_counts(S).numpy(), np.asarray(jax_counts(S_j))
    )


@pytest.mark.parametrize("subset", [None, 200, 700], ids=["full", "200", "700"])
def test_build_point_index_bit_equal(state, subset):
    rng, _, IJs, _ = state
    if subset is None:
        sub = IJs
    else:
        sub = IJs[np.sort(rng.choice(len(IJs), subset, replace=False))]
    P, cnt = pairs.build_point_index(sub, NX)
    P_j, cnt_j = jax_pairs.build_point_index(sub, NX)
    assert P.dtype == np.int32 and cnt.dtype == np.int32
    np.testing.assert_array_equal(P, np.asarray(P_j))
    np.testing.assert_array_equal(cnt, np.asarray(cnt_j))


def test_build_point_index_single_bit_equal(state):
    rng = state[0]
    endpoints = rng.integers(0, 8, size=50)
    for a, b in zip(
        pairs.build_point_index_single(endpoints, 8),
        jax_pairs.build_point_index_single(endpoints, 8),
    ):
        np.testing.assert_array_equal(a, b)


def test_point_gather(state):
    _, _, IJs, d = state
    P, _ = pairs.build_point_index(IJs[:300], NX)
    got = pairs.point_gather(torch.as_tensor(d[:300]), torch.as_tensor(P).long(), -5.0)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_pairs.point_gather(d[:300].astype(np.float32), P, -5.0))
    )


@pytest.fixture(scope="module")
def fit_state(state):
    """A fit-like state: estimates near the exact distances (integer
    noise: ties abound), 60 % uncomputed, on a pair subset."""
    rng, _, IJs, d = state
    keep = np.sort(rng.choice(len(IJs), 1200, replace=False))
    IJ = IJs[keep]
    RA = np.maximum(d[keep] + rng.integers(-2, 3, size=len(keep)), 0)
    ncm = rng.random(len(keep)) < 0.6
    P, cnt = jax_pairs.build_point_index(IJ, NX)
    return IJ, RA.astype(np.float64), ncm, np.asarray(P), np.asarray(cnt)


@pytest.mark.parametrize("k", [0, 5, 40])
def test_kth_smallest_per_point_bit_equal(fit_state, k, monkeypatch):
    IJ, RA, _, P, _ = fit_state
    got = pairs.kth_smallest_per_point(RA, P, k)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, jax_pairs.kth_smallest_per_point(RA, P, k))
    # the float32 branch against the JAX package's jitted one
    monkeypatch.setattr(pairs, "SMALL_MAX_ENTRIES", 0)
    kk = min(k, P.shape[1] - 1)
    np.testing.assert_array_equal(
        pairs.kth_smallest_per_point(RA, P, kk),
        np.asarray(jax_pairs._kth_smallest_jit(RA, P, kk), dtype=np.float64),
    )


@pytest.mark.parametrize("nmin", [10, 25, 40])
def test_guarantee_nmin_bit_equal(fit_state, nmin, monkeypatch):
    IJ, RA, ncm, P, cnt = fit_state
    got = pairs.guarantee_nmin(RA, ncm, P, cnt, nmin)
    np.testing.assert_array_equal(got, jax_pairs.guarantee_nmin(RA, ncm, P, cnt, nmin))
    assert (got == -1).any() and (ncm[got == -1]).all()
    # the float32 branch against the JAX package's jitted marks
    n_computed = (~np.append(ncm, True)[P]).sum(axis=1)
    n_todo = np.maximum(nmin - n_computed, 0).astype(np.int32)
    want = np.asarray(jax_pairs._guarantee_marks(RA.astype(np.float32), ncm, P, cnt, n_todo))
    monkeypatch.setattr(pairs, "SMALL_MAX_ENTRIES", 0)
    np.testing.assert_array_equal(pairs.guarantee_nmin(RA, ncm, P, cnt, nmin) == -1, want)


def test_empirical_cdf_probs_bit_equal(state):
    rng = state[0]
    errs = {0: np.sort(rng.normal(size=50)), 1: np.sort(rng.integers(-3, 4, 30).astype(float)),
            2: np.zeros(0)}
    p = np.concatenate([rng.normal(size=40), rng.integers(-3, 4, 20).astype(float)])
    labels = rng.integers(0, 3, size=60)
    got = pairs.empirical_cdf_probs(p, labels, errs)
    np.testing.assert_array_equal(got, jax_pairs.empirical_cdf_probs(p, labels, errs))


@pytest.mark.parametrize("nn", [1, 7, 30])
def test_knn_from_pairs_bit_equal(fit_state, nn, monkeypatch):
    """The small branch is the JAX package's host code; the large one
    (float32, stable sort) must give lax.top_k's lower-column-first order
    on the many ties here (H1)."""
    IJ, RA, ncm, P, _ = fit_state
    for g, w in zip(
        pairs.knn_from_pairs(RA, IJ, P, ncm, nn),
        jax_pairs.knn_from_pairs(RA, IJ, P, ncm, nn),
    ):
        np.testing.assert_array_equal(g, w)
    cols_j = np.asarray(
        jax_pairs._knn_select(RA.astype(np.float32), ncm, P, nn, IJ.shape[0])
    )
    cols = pairs._knn_select(
        torch.as_tensor(RA, dtype=torch.float32), torch.as_tensor(ncm),
        torch.as_tensor(P).long(), nn, IJ.shape[0],
    )
    np.testing.assert_array_equal(cols.numpy(), cols_j)
    monkeypatch.setattr(pairs, "SMALL_MAX_ENTRIES", 0)
    ngi, _, ids = pairs.knn_from_pairs(RA, IJ, P, ncm, nn)
    np.testing.assert_array_equal(ids, np.take_along_axis(P, cols_j, axis=1))


@pytest.mark.parametrize("max_cols", [16384, 16], ids=["dense", "column_subsample"])
def test_tighten_bounds_bit_equal(state, max_cols):
    """Both branches, on exact integer distances: bit-equal to the JAX
    package, never widening the interval, never crossing the truth."""
    rng, _, IJs, d = state
    ncm = rng.random(len(IJs)) < 0.6
    RA = np.where(ncm, 0.0, d)
    pending = np.flatnonzero(ncm)[:300]
    lb_old = np.maximum(d[pending] - rng.integers(0, 4, 300), 0)
    ub_old = d[pending] + rng.integers(0, 4, 300)
    got = tighten_bounds(NX, IJs, RA, ncm, IJs[pending], lb_old, ub_old,
                         max_cols=max_cols, chunk=4096)
    want = jax_tighten(NX, IJs, RA, ncm, IJs[pending], lb_old, ub_old, max_cols=max_cols)
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, w)
    lb_new, ub_new = got
    assert (lb_new >= lb_old).all() and (ub_new <= ub_old).all()
    assert (lb_new <= d[pending]).all() and (ub_new >= d[pending]).all()
    assert (ub_new < ub_old).any()


def _lexsort_keys(seed, n=6000):
    """Keys with np.lexsort's hard cases: floats among -0.0, +0.0,
    -inf, +inf, NaN of either sign and a few values in long runs, and
    int64 keys above 2**31 in long runs."""
    rng = np.random.default_rng(seed)
    pool = np.array([-0.0, 0.0, -np.inf, np.inf, np.nan, np.copysign(np.nan, -1.0),
                     1.5, -2.0])
    return {
        "f": rng.choice(pool, size=n),
        "g": rng.integers(-2, 3, size=n) * 0.0 + rng.integers(0, 2, size=n),
        "i": rng.integers(0, 5, size=n) * (1 << 40) + rng.integers(0, 3, size=n),
        "j": rng.integers(0, 3, size=n) - (1 << 33),
    }


LEXSORT_KEYS = ["f", "i", "fi", "if", "gf", "fgi", "jgf", "ij"]


@pytest.mark.parametrize("names", LEXSORT_KEYS)
def test_lexsort_stable_matches_numpy(names):
    """``lexsort_stable`` gives np.lexsort's order, ties in input order,
    -0.0 equal to +0.0 and every NaN last (ROADMAP H7)."""
    keys = _lexsort_keys(len(names))
    cols = [keys[c] for c in names]
    got = pairs.lexsort_stable([torch.as_tensor(c) for c in cols])
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.lexsort(cols))

