"""Batched graph shortest-path metric (a copy of the JAX package's
``graph_sp.py``).

The reference's graph workload calls a per-pair dijkstra closure (~2.6
ms a call, reference doc/user_guide.rst:556-560).  A single-source
dijkstra prices a point against every other point, so a batch of pairs
groups by source into a few single-source solves, which scipy's C
dijkstra computes in one call; the rows are cached for the life of the
metric (a fit touches at most nx sources).  The solves run on the host:
the metric has no device engine, and a fit evaluates its pairs through
the host hop of ``Annchor._eval_pairs``.
"""

from __future__ import annotations

import numpy as np

from annchor_tpu_torch.metrics import Metric

__all__ = ["GraphShortestPathMetric", "shortest_path_metric"]


class _SPEngine:
    """Source-grouped shortest-path pair evaluator with an SSSP cache."""

    def __init__(self, A_csr, directed: bool = False):
        self.A = A_csr
        self.directed = directed
        n = A_csr.shape[0]
        self._rows = np.full((n, A_csr.shape[1]), np.nan, dtype=np.float64)
        self._have = np.zeros(n, dtype=bool)

    def _ensure(self, sources):
        from scipy.sparse.csgraph import dijkstra

        need = np.unique(sources)
        need = need[~self._have[need]]
        if need.shape[0]:
            self._rows[need] = dijkstra(self.A, directed=self.directed, indices=need)
            self._have[need] = True

    def __call__(self, X, Z, IJ):
        IJ = np.asarray(IJ, dtype=np.int64)
        if IJ.shape[0] == 0:
            return np.zeros(0, dtype=np.float64)
        Xv = np.asarray(X, dtype=np.int64).reshape(-1)
        Zv = Xv if Z is X else np.asarray(Z, dtype=np.int64).reshape(-1)
        src = Xv[IJ[:, 0]]
        dst = Zv[IJ[:, 1]]
        self._ensure(src)
        return self._rows[src, dst]


def GraphShortestPathMetric(A_csr, directed: bool = False) -> Metric:
    """Metric over vertex indices of a weighted (scipy CSR) graph.

    X entries are vertex ids; the distance is the shortest-path length
    (inf between components).  The batch engine groups pair batches by
    source vertex and caches SSSP rows, so a fit costs at most nx
    dijkstra solves."""
    eng = _SPEngine(A_csr, directed=directed)

    def scalar(x, y):
        eng._ensure(np.array([int(x)]))
        return float(eng._rows[int(x), int(y)])

    return Metric(scalar, eng, name="graph_shortest_path")


def shortest_path_metric(A_csr):
    """Per-pair closure over the same graph (reference style: one dijkstra
    per call, no batching), for tests of the plug-in path against the
    batched engine."""
    from scipy.sparse.csgraph import dijkstra

    def sp_dist(x, y):
        row = dijkstra(A_csr, directed=False, indices=[int(x)])
        return float(row[0, int(y)])

    return sp_dist
