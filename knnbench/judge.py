"""The numbers that decide ``correct``, each held to its limit.

An answer row is what the program reported for one point: ids and
distances, the point itself first in a fit's graph.  The reference
gives the true distance of each reported id and the row's true k
smallest distances.  Over the rows judged:

* ``dist_gap``: the largest gap between a distance the program reports
  as exact and the true distance of its id;
* ``miss_share``: the share of the row's true k nearest distances that
  no reported distance matches (within the cell's ``match_tol``): a
  missed neighbour or a wrong value.

A missing id (-1) or a non-finite distance matches nothing.
"""

from __future__ import annotations

import numpy as np


def _misses(got, want, tol):
    """How many of ``want`` no element of ``got`` matches within tol
    (each element matching at most once), both sorted ascending."""
    got = np.sort(got[np.isfinite(got)])
    matched, g = 0, 0
    for w in np.sort(want):
        while g < got.size and got[g] < w - tol:
            g += 1
        if g < got.size and got[g] <= w + tol:
            matched += 1
            g += 1
    return want.size - matched


def numbers(ids, dists, exact, rep_true, top_true, tol):
    """The numbers over rows: ``ids``, ``dists`` the reported rows
    (rows, k); ``exact`` the program's flags of exact entries (or None:
    all); ``rep_true``, ``top_true`` the reference's."""
    ids = np.asarray(ids)
    dists = np.asarray(dists, dtype=np.float64)
    valid = ids >= 0
    flagged = valid if exact is None else valid & np.asarray(exact, dtype=bool)
    gaps = np.abs(dists - rep_true)[flagged]
    gap = float(gaps.max()) if gaps.size else 0.0
    if not np.isfinite(gap):
        gap = float("inf")
    k = top_true.shape[1]
    miss = sum(_misses(np.where(valid[r], dists[r], np.nan), top_true[r], tol)
               for r in range(ids.shape[0]))
    return {"dist_gap": gap, "miss_share": miss / (ids.shape[0] * k)}


def worst(readings):
    """The largest reading of each number over several judged answers."""
    out = {}
    for r in readings:
        for name, v in r.items():
            out[name] = max(out.get(name, v), v)
    return out


def verdict(values, limits):
    """(correct, [(name, value, limit)]) for the numbers that have a
    limit; a number compared is correct when it does not exceed it."""
    rows = [(name, float(values[name]), float(limit)) for name, limit in limits.items()]
    return all(v <= lim for _, v, lim in rows), rows
