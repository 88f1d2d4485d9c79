"""Exact k-NN ground truth at scale, without the O(n^2) matrix.

Port of the JAX package's ``exact.py``.  The reference's accuracy
contract compares every row against an exact graph (reference
annchor/tests/test_annchor.py:95-102), which its ``BruteForce`` supplies
only up to a few thousand points.  Here each block of source rows is
evaluated against every column and reduced to its k smallest on the
fit's device, so the host only ever sees (block, k):

* ``levenshtein``: one pair batch of the hand-written kernel per block
  (``ops/levenshtein_myers.myers_knn`` / ``myers_rows``);
* ``euclidean``, ``sqeuclidean``, ``cosine``: the dense engine's gather
  and reduction (``_dense_knn``);
* any other metric (exact EMD, graph shortest paths, Python callables):
  the metric's batched engine (for exact EMD on a card, K12) or its
  scalar on the host (``_host_knn``, ``_blocked_rows``).

Ties are broken by the lower column index, as the JAX package's
``lax.top_k`` breaks them; the host branch keeps the JAX package's
``argpartition`` order.
"""

from __future__ import annotations

import numpy as np
import torch

from annchor_tpu_torch.metrics import (
    Metric,
    _DenseBatchEngine,
    _LevenshteinEngine,
    get_function_from_input,
)
from annchor_tpu_torch.ops.levenshtein_myers import myers_knn, myers_rows
from annchor_tpu_torch.ops.pairs import row_smallest_k
from annchor_tpu_torch.progress import progress

__all__ = ["exact_knn", "exact_rows", "exact_query_rows"]


def _resolve(func, func_kwargs, device):
    if isinstance(func, Metric):
        return func
    return get_function_from_input(func, func_kwargs, device)


def _dense_knn(engine, X, k, rows, block, verbose):
    """Blocked exact k-NN through the dense engine on its device."""
    Xd = engine._data_dev(X)
    n = Xd.shape[0]
    dev = engine.device
    cols = torch.arange(n, device=dev)
    idx_out = np.empty((rows.shape[0], k), dtype=np.int64)
    dist_out = np.empty((rows.shape[0], k), dtype=np.float64)
    for s in progress(range(0, rows.shape[0], block), "exact rows", verbose):
        blk = torch.as_tensor(rows[s : s + block], device=dev)
        d = engine._chunks(Xd, Xd, blk.repeat_interleave(n), cols.repeat(blk.shape[0]))
        dist, idx = row_smallest_k(d.view(blk.shape[0], n), k)
        dist_out[s : s + blk.shape[0]] = dist.cpu().numpy()
        idx_out[s : s + blk.shape[0]] = idx.cpu().numpy()
    return idx_out, dist_out


def _batch_eval(metric):
    if metric.batch is not None:
        return metric.batch
    return lambda X, Z, IJ: np.array(
        [metric.scalar(X[i], Z[j]) for i, j in IJ], dtype=np.float64
    )


def _blocked_rows(ev, X, Z, row_ids, n_cols, block, verbose):
    """Full distance rows through a batched evaluator, ``block`` rows per
    call (one call per row would pay the evaluator's set-up per row)."""
    row_ids = np.asarray(row_ids, dtype=np.int64)
    out = np.empty((row_ids.shape[0], n_cols), dtype=np.float64)
    cols = np.arange(n_cols, dtype=np.int64)
    for s in progress(range(0, row_ids.shape[0], block), "exact rows", verbose):
        blk = row_ids[s : s + block]
        IJ = np.stack([np.repeat(blk, n_cols), np.tile(cols, blk.shape[0])], axis=1)
        out[s : s + blk.shape[0]] = np.asarray(
            ev(X, Z, IJ), dtype=np.float64
        ).reshape(blk.shape[0], n_cols)
    return out


def _host_knn(metric, X, k, rows, block, verbose):
    n = len(X)
    ev = _batch_eval(metric)
    idx_out = np.empty((rows.shape[0], k), dtype=np.int64)
    dist_out = np.empty((rows.shape[0], k), dtype=np.float64)
    for s in progress(range(0, rows.shape[0], block), "exact rows", verbose):
        blk = rows[s : s + block]
        # (block, n) resident at a time, never O(n^2)
        D = _blocked_rows(ev, X, X, blk, n, block, False)
        part = np.argpartition(D, min(k - 1, n - 1), axis=1)[:, :k]
        d_part = np.take_along_axis(D, part, axis=1)
        order = np.argsort(d_part, axis=1, kind="stable")
        idx_out[s : s + blk.shape[0]] = np.take_along_axis(part, order, axis=1)
        dist_out[s : s + blk.shape[0]] = np.take_along_axis(d_part, order, axis=1)
    return idx_out, dist_out


def _rows(rows, n):
    if rows is None:
        return np.arange(n, dtype=np.int64)
    return np.asarray(rows, dtype=np.int64)


def exact_knn(X, func, func_kwargs=None, k=16, rows=None, block=64,
              verbose=False, device="cuda"):
    """Exact k smallest neighbours per row (self included at d = 0).

    Returns (indices int64 (R, k), distances float64 (R, k)), ascending.
    ``rows=None`` computes every row: a full exact k-NN graph, directly
    comparable with ``Annchor.neighbor_graph`` through
    ``compare_neighbor_graphs`` (with k = n_neighbors there).  ``device``
    is where a built-in metric's engine runs."""
    metric = _resolve(func, func_kwargs, device)
    n = len(X)
    rows = _rows(rows, n)
    k = int(min(k, n))
    eng = metric.batch
    if isinstance(eng, _LevenshteinEngine):
        return myers_knn(eng._encode(X), k, rows=rows, block=block, verbose=verbose)
    if isinstance(eng, _DenseBatchEngine):
        return _dense_knn(eng, X, k, rows, block, verbose)
    return _host_knn(metric, X, k, rows, block, verbose)


def exact_rows(X, func, func_kwargs=None, rows=None, block=64, verbose=False,
               device="cuda"):
    """Full exact distance rows float64 (R, n) for the given row indices."""
    metric = _resolve(func, func_kwargs, device)
    n = len(X)
    rows = _rows(rows, n)
    eng = metric.batch
    if isinstance(eng, _LevenshteinEngine):
        return myers_rows(eng._encode(X), rows, block=block, verbose=verbose)
    return _blocked_rows(_batch_eval(metric), X, X, rows, n, block, verbose)


def exact_query_rows(X, Q, func, func_kwargs=None, block=64, verbose=False,
                     device="cuda"):
    """Exact distance rows float64 (nq, nx) from out-of-sample queries Q
    to X."""
    metric = _resolve(func, func_kwargs, device)
    nx, nq = len(X), len(Q)
    eng = metric.batch
    if isinstance(eng, _LevenshteinEngine):
        # a throwaway joint encoding of X + Q: entering it in the engine's
        # one-dataset cache would evict the fitted dataset's encoding
        enc = eng.build(list(X) + list(Q))
        return myers_rows(enc, np.arange(nx, nx + nq, dtype=np.int64), block=block,
                          n_keep=nx, verbose=verbose)
    # engines take (X, Z, IJ) with IJ[:, 0] indexing the first argument
    return _blocked_rows(_batch_eval(metric), Q, X, np.arange(nq, dtype=np.int64),
                         nx, block, verbose)
