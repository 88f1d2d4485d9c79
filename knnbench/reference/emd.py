"""Exact earth mover's distance (1-Wasserstein) between histograms, as
the transport linear program in its textbook form, solved by SciPy's
HiGHS simplex: independent of the program's network simplex.

A row's k nearest are found without solving the LP against every index
item: the distance to a grid point set under its Euclidean ground cost
is at least the 1-D Wasserstein distance of the histograms projected on
any direction (projection is 1-Lipschitz), so the largest of 16 sliced
distances is a lower bound.  The LP runs on the reported ids and the k
items of least bound; the k-th smallest of those is an upper bound on
the row's true k-th distance, and every item whose lower bound does not
exceed it is solved exactly too.

The control is the same computation in float32: the histograms and the
costs rounded to float32 and each distance returned in float32 (about
1e-7 of its size), in place of the float64 the configuration states.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.optimize import linprog

N_DIRECTIONS = 16
_LP_OPTIONS = {"primal_feasibility_tolerance": 1e-10, "dual_feasibility_tolerance": 1e-10,
               "presolve": False}


def unit_mass(X):
    X = np.asarray(X, dtype=np.float64)
    return X / X.sum(axis=1, keepdims=True)


def emd(a, b, M, dtype=np.float64):
    """The optimal transport cost between histograms a and b of unit
    mass under the cost matrix M, with a, b and M held in ``dtype``."""
    a = np.asarray(a, dtype=dtype).astype(np.float64)
    b = np.asarray(b, dtype=dtype).astype(np.float64)
    ia, ib = np.flatnonzero(a), np.flatnonzero(b)
    a, b = a[ia], b[ib]
    # both sides exactly balanced in the held precision's rounding
    b = b * (a.sum() / b.sum())
    na, nb = ia.size, ib.size
    c = np.asarray(M, dtype=dtype).astype(np.float64)[np.ix_(ia, ib)].ravel()
    rows = np.concatenate([np.repeat(np.arange(na), nb), na + np.tile(np.arange(nb), na)])
    cols = np.concatenate([np.arange(na * nb), np.arange(na * nb)])
    A = sp.csr_matrix((np.ones(2 * na * nb), (rows, cols)), shape=(na + nb, na * nb))
    res = linprog(c, A_eq=A, b_eq=np.concatenate([a, b]), bounds=(0, None), method="highs",
                  options=_LP_OPTIONS)
    if res.status != 0:
        raise RuntimeError("the transport LP failed: %s" % res.message)
    return float(np.asarray(res.fun, dtype=dtype))


def sliced_lower_bounds(h, H, grid):
    """Lower bounds on EMD(h, H[r]) for every r, for the Euclidean
    ground cost between the points of an (rows, cols) grid."""
    xy = np.stack(np.meshgrid(np.arange(grid[0]), np.arange(grid[1]), indexing="ij"),
                  -1).reshape(-1, 2).astype(np.float64)
    best = np.zeros(H.shape[0])
    for t in np.linspace(0.0, np.pi, N_DIRECTIONS, endpoint=False):
        p = xy @ np.array([np.cos(t), np.sin(t)])
        o = np.argsort(p, kind="stable")
        cdf = np.cumsum(H[:, o] - h[o], axis=1)[:, :-1]
        best = np.maximum(best, np.abs(cdf) @ np.diff(p[o]))
    # the bound carries the rounding of its sums: keep it below the LP's
    return best * (1 - 1e-9) - 1e-12


def _row(q, H, M, grid, k, seed_ids, dtype):
    """Exact distances {id: d} from q to every item that can be among its
    k nearest, and to ``seed_ids``."""
    lb = sliced_lower_bounds(q, H, grid)
    done = {}
    first = set(int(i) for i in seed_ids if i >= 0) | set(np.argsort(lb, kind="stable")[:k].tolist())
    for i in sorted(first):
        done[i] = emd(q, H[i], M, dtype)
    thr = np.sort(np.fromiter(done.values(), dtype=np.float64))[min(k, len(done)) - 1]
    for i in np.flatnonzero(lb <= thr):
        if int(i) not in done:
            done[int(i)] = emd(q, H[i], M, dtype)
    return done


def judge(index, queries, reported_ids, k, params, device="cpu"):
    H, Q = unit_mass(index), unit_mass(queries)
    M = np.asarray(params["cost_matrix"], dtype=np.float64)
    ids = [np.asarray(x) for x in reported_ids]
    reps = [np.full(x.shape, np.nan) for x in ids]
    top = np.empty((Q.shape[0], k))
    for r in range(Q.shape[0]):
        seeds = np.unique(np.concatenate([x[r] for x in ids]))
        done = _row(Q[r], H, M, params["grid"], k, seeds, np.float64)
        for x, rep in zip(ids, reps):
            rep[r] = [done[int(i)] if i >= 0 else np.nan for i in x[r]]
        top[r] = np.sort(np.fromiter(done.values(), dtype=np.float64))[:k]
    return reps, top


def control(index, queries, k, params, device="cpu"):
    H, Q = unit_mass(index), unit_mass(queries)
    M = np.asarray(params["cost_matrix"], dtype=np.float64)
    out_i = np.empty((Q.shape[0], k), dtype=np.int64)
    out_d = np.empty((Q.shape[0], k))
    for r in range(Q.shape[0]):
        done = _row(Q[r], H, M, params["grid"], k, (), np.float32)
        ids = np.array(sorted(done), dtype=np.int64)
        d = np.array([done[i] for i in ids])
        o = np.argsort(d, kind="stable")[:k]
        out_i[r], out_d[r] = ids[o], d[o]
    return out_i, out_d
