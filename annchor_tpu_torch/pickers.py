"""Anchor pickers (reference annchor/pickers.py:18-128).

Each picker returns (A, D, evals): anchor indices, the (nx, n_anchors)
anchor-distance matrix, and the number of metric evaluations spent.
Every anchor column is one batched one-vs-all metric evaluation.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "MaxMinAnchorPicker",
    "RandomAnchorPicker",
    "SelectedAnchorPicker",
    "ExternalAnchorPicker",
]


def _column(ann, ix):
    """Exact distances from point ix to every point (one anchor column)."""
    IJ = np.stack(
        [np.full(ann.nx, ix, dtype=np.int64), np.arange(ann.nx)], axis=1
    )
    return np.asarray(ann.get_exact_ijs(ann.f, ann.X, IJ), dtype=np.float64)


class MaxMinAnchorPicker:
    """Greedy farthest-point (max-min) anchors.

    Reproduces the reference quirk (pickers.py:43-50) that the running
    minimum for anchors i >= 1 excludes the first (random) anchor's
    column, and uses the legacy numpy RNG so pinned-seed anchor sets
    match the reference and the JAX package.
    """

    def get_anchors(self, ann):
        nx, na = ann.nx, ann.n_anchors
        np.random.seed(ann.random_seed)
        ix = np.random.randint(nx)

        # the engine's device loop, unless the user overrode the
        # pairwise evaluator (whose call sequence is then the contract)
        fused = getattr(ann.metric.batch, "fused_maxmin", None)
        if fused is not None and getattr(
            ann.get_exact_ijs, "_annchor_default", False
        ):
            A, D = fused(ann.X, na, ix, verbose=ann.verbose)
            return np.asarray(A, dtype=int), D, na * nx

        from annchor_tpu_torch.progress import progress

        D = np.full((na, nx), np.inf)
        A = np.zeros(na, dtype=int)
        for i in progress(range(na), "anchor columns", ann.verbose, na):
            A[i] = ix
            D[i] = _column(ann, ix)
            if i == 0:
                ix = int(np.argmax(D[0]))
            else:
                ix = int(np.argmax(np.min(D[1:], axis=0)))
        return A, D.T, na * nx


class RandomAnchorPicker:
    def get_anchors(self, ann):
        nx, na = ann.nx, ann.n_anchors
        np.random.seed(ann.random_seed)
        A = np.random.choice(np.arange(nx), na, replace=False)
        IJ = np.array(
            [[i, j] for i in A for j in range(nx)], dtype=np.int64
        )
        D = np.asarray(ann.get_exact_ijs(ann.f, ann.X, IJ)).reshape(na, nx)
        return A, D.T, na * nx


class SelectedAnchorPicker:
    """User-specified anchor indices (reference pickers.py:86-107)."""

    def __init__(self, A):
        self.A = np.asarray(A, dtype=int)

    def get_anchors(self, ann):
        nx = ann.nx
        A = self.A
        na = len(A)
        IJ = np.array(
            [[i, j] for i in A for j in range(nx)], dtype=np.int64
        )
        D = np.asarray(ann.get_exact_ijs(ann.f, ann.X, IJ)).reshape(na, nx)
        return A, D.T, na * nx


class ExternalAnchorPicker:
    """Anchors that are not members of X (reference pickers.py:55-83);
    distances are evaluated with the query-side backend so batched
    engines still apply."""

    def __init__(self, A):
        self.A = A
        # mirrored from the reference API (pickers.py:58); the flag is
        # unused there too but user subclasses may rely on its presence
        self.is_anchor_safe = False

    def get_anchors(self, ann):
        nx, na = ann.nx, ann.n_anchors
        geq = ann._get_exact_query_ijs_for(ann.f)
        IJ = np.array(
            [[j, i] for i in range(na) for j in range(nx)], dtype=np.int64
        )
        D = (
            np.asarray(geq(ann.f, ann.X, self.A, IJ))
            .reshape(na, nx)
            .astype(np.float64)
        )
        return np.array([]), D.T, na * nx
