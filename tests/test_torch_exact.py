"""The port's exact oracles (``exact_knn``, ``exact_rows``,
``exact_query_rows``) on the CPU: the port's copy of
``tests/test_exact.py``, then each branch held against the JAX package
on the same inputs.

Tolerances: edit distances and the host branch's float64 values are
bit-equal, with indices in the same order at tied distances (both
packages break ties by the lower column).  The dense branch computes in
float32 in both packages but sums each row of squared differences in
another order, so its distances agree within 8 float32 ulps (see
``tests/test_torch_metrics.py``), and indices must agree wherever the
gap to the next distance exceeds that.
"""

import numpy as np
import pytest
import torch

import annchor_tpu as at
import annchor_tpu_torch as att
import annchor_tpu_torch.metrics as tm
from annchor_tpu_torch.datasets import make_strings
from annchor_tpu_torch.ops import levenshtein_myers
from annchor_tpu_torch.ops.pairs import row_smallest_k

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def strings():
    X, _ = make_strings(n=300, n_clusters=8, length=60, seed=3, evolve=True)
    return list(X)


@pytest.fixture(scope="module")
def tied_strings():
    """Strings built to tie: duplicates, and one-substitution variants of
    a few seeds, so many rows hold equal distances at their k-th place."""
    rng = np.random.default_rng(11)
    seeds = ["".join(rng.choice(list("ACGT"), size=24)) for _ in range(6)]
    out = []
    for t in range(90):
        s = list(seeds[t % 6])
        if t % 3:
            pos = int(rng.integers(0, len(s)))
            s[pos] = "ACGT"[("ACGT".index(s[pos]) + 1) % 4]
        out.append("".join(s))
    return out


def _oracle_knn(X, metric, k):
    n = len(X)
    f = att.get_function_from_input(metric, None, device="cpu")
    D = np.zeros((n, n))
    iu = np.triu_indices(n, k=1)
    D[iu] = f.batch(X, X, np.stack(iu, axis=1))
    D += D.T
    idx = np.argsort(D, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(D, idx, axis=1)


# -- the port's copy of tests/test_exact.py ---------------------------------


def test_exact_knn_strings_matches_bruteforce(strings):
    k = 7
    oi, od = _oracle_knn(strings, "levenshtein", k)
    idx, dist = att.exact_knn(strings, "levenshtein", k=k, block=32, device="cpu")
    assert idx.shape == (len(strings), k)
    np.testing.assert_array_equal(dist, od)
    assert (dist[:, 0] == 0).all()


def test_exact_knn_rows_subset(strings):
    rows = np.array([5, 17, 123])
    idx, dist = att.exact_knn(strings, "levenshtein", k=5, rows=rows, block=2,
                              device="cpu")
    oi, od = _oracle_knn(strings, "levenshtein", 5)
    np.testing.assert_array_equal(dist, od[rows])


def test_exact_knn_euclidean_blobs(blobs):
    X, _ = blobs
    X = X[:200]
    k = 6
    oi, od = _oracle_knn(X, "euclidean", k)
    idx, dist = att.exact_knn(X, "euclidean", k=k, block=64, device="cpu")
    np.testing.assert_allclose(dist, od, atol=1e-5)


def test_exact_rows_matches_batch(strings):
    rows = np.array([0, 42])
    R = att.exact_rows(strings, "levenshtein", rows=rows, block=2, device="cpu")
    f = att.get_function_from_input("levenshtein", None, device="cpu")
    n = len(strings)
    for t, r in enumerate(rows):
        IJ = np.stack([np.full(n, r), np.arange(n)], axis=1)
        np.testing.assert_array_equal(R[t], f.batch(strings, strings, IJ))


def test_exact_query_rows(strings):
    X, Q = strings[:250], strings[250:]
    R = att.exact_query_rows(X, Q, "levenshtein", block=8, device="cpu")
    assert R.shape == (len(Q), len(X))
    f = att.get_function_from_input("levenshtein", None, device="cpu")
    XQ = X + Q
    IJ = np.stack([np.full(len(X), 250 + 3), np.arange(len(X))], axis=1)
    np.testing.assert_array_equal(R[3], f.batch(XQ, XQ, IJ))


def test_exact_knn_full_population_compare(strings):
    """exact_knn output slots straight into compare_neighbor_graphs."""
    k = 8
    idx, dist = att.exact_knn(strings, "levenshtein", k=k, device="cpu")
    assert att.compare_neighbor_graphs((idx, dist), (idx, dist), k) == 0


def test_exact_query_rows_preserves_engine_cache(strings):
    """The X + Q oracle must not evict the fitted dataset's encoding from
    the Levenshtein engine's one-dataset cache."""
    f = att.get_function_from_input("levenshtein", None, device="cpu")
    eng = f.batch
    assert isinstance(eng, tm._LevenshteinEngine)
    enc_before = eng._encode(strings)
    att.exact_query_rows(strings, strings[:5], f, device="cpu")
    assert eng._encode(strings) is enc_before


def test_exact_rows_scalar_metric_blocked(blobs):
    """The no-batch-engine path gives correct full rows."""
    X, _ = blobs
    X = X[:60]
    f = att.Metric(lambda a, b: float(np.abs(a - b).sum()), name="l1")
    rows = np.array([3, 17, 41])
    R = att.exact_rows(list(X), f, rows=rows, block=2, device="cpu")
    for t, r in enumerate(rows):
        np.testing.assert_allclose(R[t], np.abs(X - X[r]).sum(axis=1), rtol=1e-9)


# -- parity with the JAX package --------------------------------------------


def test_levenshtein_exact_bit_equal_to_jax(tied_strings):
    """K1's plain version plus the stable top-k give the JAX package's
    indices and distances, tie order included; rows and query rows too."""
    X = tied_strings
    k = 9
    idx, dist = att.exact_knn(X, "levenshtein", k=k, block=16, device="cpu")
    jidx, jdist = at.exact_knn(X, "levenshtein", k=k, block=16)
    # the set really ties at the k-th place
    assert (dist[:, k - 1] == dist[:, k - 2]).sum() > 30
    np.testing.assert_array_equal(dist, jdist)
    np.testing.assert_array_equal(idx, jidx)
    rows = np.array([0, 7, 44, 89])
    np.testing.assert_array_equal(
        att.exact_rows(X, "levenshtein", rows=rows, block=3, device="cpu"),
        at.exact_rows(X, "levenshtein", rows=rows, block=3))
    np.testing.assert_array_equal(
        att.exact_query_rows(X[:70], X[70:], "levenshtein", block=4, device="cpu"),
        at.exact_query_rows(X[:70], X[70:], "levenshtein", block=4))


def test_myers_blocks_capped_by_pairs(tied_strings, monkeypatch):
    """A block of sources is cut to EXACT_BLOCK_PAIRS pairs; the results
    do not depend on the cut."""
    want = att.exact_knn(tied_strings, "levenshtein", k=5, device="cpu")
    monkeypatch.setattr(levenshtein_myers, "EXACT_BLOCK_PAIRS", 200)
    blocks = levenshtein_myers._source_blocks(np.arange(90), 90, 64)
    assert [b.shape[0] for b in blocks] == [2] * 45
    got = att.exact_knn(tied_strings, "levenshtein", k=5, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_dense_exact_knn_matches_jax(blobs):
    X, _ = blobs
    X = X[:300]
    k = 8
    for kind in ("euclidean", "sqeuclidean", "cosine"):
        idx, dist = att.exact_knn(X, kind, k=k, block=64, device="cpu")
        jidx, jdist = at.exact_knn(X, kind, k=k, block=64)
        scale = np.abs(jdist).astype(np.float32)
        if kind == "cosine":
            scale = np.maximum(scale, np.float32(1))
        tol = 8 * np.spacing(scale).astype(np.float64)
        assert (np.abs(dist - jdist) <= tol).all(), kind
        # indices agree wherever neither neighbour is within tolerance of
        # the next one in its row
        gap = np.diff(jdist, axis=1)
        clear = np.ones_like(jidx, dtype=bool)
        clear[:, 1:] &= gap > 2 * tol[:, 1:]
        clear[:, :-1] &= gap > 2 * tol[:, :-1]
        assert clear.mean() > 0.8, kind
        np.testing.assert_array_equal(idx[clear], jidx[clear])


def test_host_exact_bit_equal_to_jax(blobs):
    """A Python metric takes the host branch in both packages: the same
    argpartition and stable argsort, so bit-equal results."""
    X, _ = blobs
    X = np.round(X[:120], 1)  # rounded coordinates: many tied L1 distances

    def l1(a, b):
        return float(np.abs(a - b).sum())

    idx, dist = att.exact_knn(X, att.Metric(l1), k=6, block=32, device="cpu")
    jidx, jdist = at.exact_knn(X, at.Metric(l1), k=6, block=32)
    np.testing.assert_array_equal(dist, jdist)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(
        att.exact_query_rows(X[:100], X[100:], att.Metric(l1), block=7, device="cpu"),
        at.exact_query_rows(X[:100], X[100:], at.Metric(l1), block=7))


def test_row_smallest_k_breaks_ties_by_lower_index():
    d = torch.tensor([[3, 1, 2, 1, 1, 0], [5, 5, 5, 5, 5, 5]], dtype=torch.int32)
    vals, idx = row_smallest_k(d, 4)
    assert vals.tolist() == [[0, 1, 1, 1], [5, 5, 5, 5]]
    assert idx.tolist() == [[5, 1, 3, 4], [0, 1, 2, 3]]
