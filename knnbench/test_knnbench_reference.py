"""The plain references agree with a direct dynamic program and with a
small linear program solved another way."""

import os
import sys

import numpy as np
import pytest
from scipy.optimize import linprog

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from knnbench.reference import emd, levenshtein  # noqa: E402


def _direct(a, b):
    d = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev, d[0] = d[0], i
        for j, cb in enumerate(b, 1):
            prev, d[j] = d[j], min(d[j] + 1, d[j - 1] + 1, prev + (ca != cb))
    return d[-1]


def _strings(rng, n, lo, hi, alphabet):
    return ["".join(rng.choice(list(alphabet), size=rng.integers(lo, hi + 1))) for _ in range(n)]


@pytest.mark.parametrize("alphabet,lo,hi", [("ACGT", 0, 40), ("ab", 1, 70), ("αβγ𝔸x", 0, 12)])
def test_levenshtein_against_direct_dp(alphabet, lo, hi):
    rng = np.random.default_rng(len(alphabet))
    A, B = _strings(rng, 60, lo, hi, alphabet), _strings(rng, 60, lo, hi, alphabet)
    got = levenshtein.pair_distances(A, B)
    assert got.tolist() == [_direct(a, b) for a, b in zip(A, B)]


def test_levenshtein_control_saturates():
    rng = np.random.default_rng(1)
    A, B = _strings(rng, 20, 0, 300, "ACGT"), _strings(rng, 20, 0, 300, "ACGT")
    exact = levenshtein.pair_distances(A, B)
    capped = levenshtein.pair_distances(A, B, cap=levenshtein.INT8_MAX)
    assert capped.tolist() == np.minimum(exact, 127).tolist() and exact.max() > 127


def test_levenshtein_rows_and_judge():
    rng = np.random.default_rng(2)
    X, Q = _strings(rng, 30, 5, 25, "ACGT"), _strings(rng, 3, 5, 25, "ACGT")
    R = levenshtein.full_rows(X, Q)
    assert R[1, 7] == _direct(Q[1], X[7])
    ids = np.argsort(R, axis=1, kind="stable")[:, :5]
    (rep,), top = levenshtein.judge(X, Q, [ids], 5, {})
    assert np.array_equal(rep, np.take_along_axis(R, ids, axis=1))
    assert np.array_equal(top, np.sort(R, axis=1)[:, :5])


def _dense_lp(a, b, M):
    n, m = len(a), len(b)
    A = np.zeros((n + m, n * m))
    for i in range(n):
        A[i, i * m:(i + 1) * m] = 1
    for j in range(m):
        A[n + j, j::m] = 1
    res = linprog(M.ravel(), A_eq=A, b_eq=np.concatenate([a, b]), bounds=(0, None))
    return res.fun


def test_emd_against_a_small_lp():
    rng = np.random.default_rng(3)
    C = np.linalg.norm(rng.normal(size=(6, 2))[:, None] - rng.normal(size=(6, 2))[None], axis=-1)
    C = C + C.T
    for _ in range(10):
        a = rng.integers(0, 5, size=6).astype(float) + (rng.random(6) < 0.2)
        b = rng.integers(0, 5, size=6).astype(float) + 1
        a[0] += 1
        got = emd.emd(a / a.sum(), b / b.sum(), C)
        assert got == pytest.approx(_dense_lp(a / a.sum(), b / b.sum(), C), abs=1e-12)


def _digits(n):
    """The first n of the benchmark's digit images, float64."""
    with np.load(os.path.join(HERE, "data", "digits.npz")) as z:
        return z["images"][:n].astype(np.float64)


def test_emd_point_masses_and_bounds():
    from knnbench.datagen import grid_cost_matrix

    M = grid_cost_matrix(8, 8)
    a, b = np.zeros(64), np.zeros(64)
    a[0], b[63] = 1, 1
    assert emd.emd(a, b, M) == pytest.approx(np.hypot(7, 7), abs=1e-12)
    X = emd.unit_mass(_digits(40))
    lb = emd.sliced_lower_bounds(X[0], X, (8, 8))
    exact = np.array([emd.emd(X[0], x, M) for x in X])
    assert (lb <= exact).all() and lb[0] <= 0 and (lb[1:] > 0.5 * exact[1:]).mean() > 0.5


def test_emd_judge_finds_the_true_rows():
    from knnbench.datagen import grid_cost_matrix

    X = _digits(60)
    params = {"cost_matrix": grid_cost_matrix(8, 8), "grid": (8, 8)}
    H = emd.unit_mass(X)
    full = np.array([[emd.emd(H[q], h, params["cost_matrix"]) for h in H] for q in (3, 17)])
    ids = np.argsort(full, axis=1, kind="stable")[:, :6]
    (rep,), top = emd.judge(X, X[[3, 17]], [ids], 6, params)
    assert np.allclose(rep, np.take_along_axis(full, ids, axis=1), atol=1e-12)
    assert np.allclose(top, np.sort(full, axis=1)[:, :6], atol=1e-12)
    ci, cd = emd.control(X, X[[3, 17]], 6, params)
    gap = np.abs(cd - np.take_along_axis(full, ci, axis=1)).max()
    assert 1e-9 < gap < 1e-5
