"""The benchmark's inputs, made from the run's seed.

A configuration's rows come from its generator, ``generators/<name>.py``
(``make(spec, root)``: the rows, a function of the spec alone), found
by the name its ``data.generator`` gives.  ``split`` turns them into one
seed's index and query pool: the Query Example's protocol holds out
every ``holdout_every``-th row as the pool, and the seed permutes both.
So every seed asks the same work of the program, in another order.

``grid_cost_matrix`` is a frozen copy of the program's ground metric of
an h x w grid.
"""

from __future__ import annotations

import numpy as np


def grid_cost_matrix(h=8, w=8):
    """Euclidean distance between the pixel positions of an h x w grid."""
    xy = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"), -1).reshape(h * w, 2)
    return np.linalg.norm(xy[:, None, :] - xy[None, :, :], axis=-1).astype(np.float64)


def with_cost_matrix(kw):
    """Keyword arguments with ``cost_matrix_grid`` [h, w] replaced by the
    grid's ``cost_matrix``; returns (arguments, grid or None)."""
    kw = dict(kw)
    grid = kw.pop("cost_matrix_grid", None)
    if grid is not None:
        kw["cost_matrix"] = grid_cost_matrix(*grid)
    return kw, grid


def stream(seed, purpose):
    """An independent generator for one use of the run's seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), purpose]))


def take(rows, ids):
    """Rows ``ids`` of a list or an array, as a new object."""
    if isinstance(rows, list):
        return [rows[i] for i in ids]
    return rows[np.asarray(ids, dtype=np.int64)]


class Data:
    """One seed's inputs: ``index`` (what the program fits) and ``pool``
    (the held-out queries; empty when the cell asks none)."""

    def __init__(self, index, pool):
        self.index = index
        self.pool = pool

    def copy_index(self):
        """A fresh copy of the index: a new object, so that nothing the
        program keys on an input's identity carries from one fit to the
        next."""
        if isinstance(self.index, list):
            return list(self.index)
        return self.index.copy()


def split(rows, queries, seed):
    """``rows`` as the seed's index and query pool: with ``queries``
    (the configuration's ``queries`` spec) every ``holdout_every``-th
    row is held out as the pool, the rest is the index; the seed
    permutes each."""
    every = int((queries or {}).get("holdout_every", 0))
    held = np.zeros(len(rows), dtype=bool)
    if every:
        held[::every] = True
    index, pool = np.flatnonzero(~held), np.flatnonzero(held)
    index = index[stream(seed, 1).permutation(index.size)]
    pool = pool[stream(seed, 2).permutation(pool.size)]
    return Data(take(rows, index), take(rows, pool))
