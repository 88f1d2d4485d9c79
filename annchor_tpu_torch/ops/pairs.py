"""Candidate-pair bookkeeping on padded tensors.

Port of the JAX package's ``ops/pairs.py``.  The reference tracks the
ragged per-point pair lists in numba typed Dicts (``get_IJs_from_check``,
reference annchor/utils.py:494-540); here, as in the JAX package, the
one core structure is a padded point-incidence matrix

    P_idx: int32 (nx, max_deg)  indices into the flat pair array IJs,
                                padded with m (a sentinel slot)
    P_cnt: int32 (nx,)          the true degree of each point

and every per-point operation (k-th smallest thresholds, guarantee_nmin,
k-NN assembly) is a masked gather and a sort over it, in torch on the
caller's device.  The inputs and results are host numpy arrays, as the
host pipeline keeps its per-pair state in numpy.

Precision and tie order follow the JAX package's two branches.  Below
``SMALL_MAX_ENTRIES`` incidence entries (every fit at nx <= 4096) the
JAX package runs these passes in float64 on the host, and the port
computes in float64 too.  Above it the JAX package runs them in float32
with ``lax.top_k``, which breaks ties by the lower index; the port
computes in float32 with stable sorts, which keep that order (ROADMAP
H1).  The k-NN selection of the small branch is the JAX package's own
host code: its ``np.argpartition`` fixes the order among tied distances
in a way no device sort reproduces, and the reported graph must equal
the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from annchor_tpu_torch.ops.device_pipeline import (
    guarantee_mark_rows,
    penalised_knn_cols,
    pidx_from_pairs,
    pidx_full,
)

__all__ = [
    "lexsort_stable",
    "build_point_index",
    "build_point_index_single",
    "point_gather",
    "kth_smallest_per_point",
    "kth_smallest_per_point_dev",
    "guarantee_nmin",
    "guarantee_nmin_dev",
    "empirical_cdf_probs",
    "empirical_cdf_probs_dev",
    "knn_from_pairs",
    "row_smallest_k",
]

F32_INF = float("inf")
SMALL_MAX_ENTRIES = 64_000_000


def _index(P_idx, device):
    """P_idx as an int64 tensor on the device."""
    if isinstance(P_idx, torch.Tensor):
        return P_idx.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(P_idx, dtype=np.int64), device=device)


def _dtype_for(P):
    return torch.float64 if P.numel() < SMALL_MAX_ENTRIES else torch.float32


def lexsort_stable(keys):
    """``np.lexsort(keys)`` on tensors of one device: the indices that
    sort by the last key, then the one before it, and so on, ties kept
    in input order.  One stable sort a key, least significant first.

    Float keys are compared as numpy compares them (ROADMAP H7): -0.0
    and +0.0 are equal, and every NaN sorts last.  A radix sort, which
    the card's stable sort is, orders the bits, so each float key has
    its zeros made +0.0 and its NaNs the positive NaN first."""
    order = None
    for key in keys:
        if key.is_floating_point():
            key = key.masked_fill(key == 0, 0.0).masked_fill(key.isnan(), float("nan"))
        if order is None:
            order = torch.sort(key, stable=True).indices
        else:
            order = order[torch.sort(key[order], stable=True).indices]
    return order


def build_point_index(IJs, nx: int, device="cpu"):
    """The padded incidence matrix of the (m, 2) pair array.

    Pairs are canonical (IJs[:, 0] < IJs[:, 1]); each pair id appears in
    the rows of both endpoints (reference I dict, utils.py:526-540).  Row
    p lists first the pairs with p on the left, then those with p on the
    right, each in pair-id order.  Returns (P_idx int32 (nx, max_deg),
    P_cnt int32 (nx,)) as numpy arrays."""
    IJs = np.asarray(IJs)
    m = IJs.shape[0]
    if (
        m == nx * (nx - 1) // 2
        and m
        and IJs[0, 0] == 0
        and IJs[0, 1] == 1
        and IJs[-1, 0] == nx - 2
    ):
        # complete candidate set in canonical row-major order: the
        # incidence matrix has a closed form
        return (
            pidx_full(nx, device).cpu().numpy(),
            np.full(nx, nx - 1, dtype=np.int32),
        )
    ij = torch.as_tensor(IJs.astype(np.int64).reshape(m, 2), device=device)
    counts = torch.bincount(ij.reshape(-1), minlength=nx)
    max_deg = int(counts.max()) if m else 1
    P = pidx_from_pairs(ij[:, 0], ij[:, 1], nx, max_deg)
    return P.cpu().numpy(), counts.to(torch.int32).cpu().numpy()


def build_point_index_single(endpoints, n: int, device="cpu"):
    """Padded incidence matrix when each pair belongs to exactly one
    point (the query path: pairs are (database, query) and are indexed
    by their query endpoint only, reference query_functions.py:49-59).
    Returns (P_idx int32 (n, max_deg), P_cnt int32 (n,)) as numpy."""
    e = torch.as_tensor(np.asarray(endpoints, dtype=np.int64), device=device)
    m = e.shape[0]
    order = torch.argsort(e, stable=True)
    counts = torch.bincount(e, minlength=n)
    max_deg = int(counts.max()) if m else 1
    starts = torch.cumsum(counts, 0) - counts
    se = e[order]
    cols = torch.arange(m, device=e.device) - starts[se]
    P = torch.full((n, max_deg), m, dtype=torch.int32, device=e.device)
    P[se, cols] = order.to(torch.int32)
    return P.cpu().numpy(), counts.to(torch.int32).cpu().numpy()


def point_gather(values, P_idx, pad_value):
    """Gather a per-pair tensor into the padded per-point layout:
    values (m,) -> (nx, max_deg), with sentinel slots = pad_value."""
    pad = torch.full((1,), pad_value, dtype=values.dtype, device=values.device)
    return torch.cat([values, pad])[P_idx]


def _kth_smallest(RA, P, k: int):
    vals = point_gather(RA, P, F32_INF)
    kk = min(int(k), vals.shape[1] - 1)
    return torch.kthvalue(vals, kk + 1, dim=1).values


def kth_smallest_per_point_dev(RA, P, k: int):
    """``kth_smallest_per_point`` on tensors: RA (m,) float on P's
    device, P the int64 incidence matrix.  Returns float64 (nx,) there."""
    return _kth_smallest(RA.to(_dtype_for(P)), P, k).double()


def kth_smallest_per_point(RA, P_idx, k: int, device="cpu"):
    """thresh[i] = (k+1)-th smallest RefineApprox among i's pairs
    (reference annchor.py:399-404 uses np.partition(..., nn)[nn]).
    Returns np.float64 (nx,)."""
    P = _index(P_idx, device)
    RA_t = torch.as_tensor(np.asarray(RA), dtype=_dtype_for(P), device=device)
    return kth_smallest_per_point_dev(RA_t, P, k).cpu().numpy()


def _guarantee_marks(RA, ncm, P, nmin: int):
    """Per-pair marks for guarantee_nmin (``guarantee_mark_rows`` over
    the whole incidence matrix).  Returns bool (m,)."""
    m = RA.shape[0]
    mark_rows = guarantee_mark_rows(
        point_gather(RA, P, F32_INF), point_gather(ncm, P, False), P < m, nmin
    )
    # marking is idempotent, so repeated ids need no reduction
    marks = torch.zeros(m + 1, dtype=torch.bool, device=RA.device)
    marks[P[mark_rows]] = True
    return marks[:m]


def guarantee_nmin(RA, ncm, P_idx, P_cnt, nmin: int, device="cpu"):
    """Force at least nmin computed-or-forced pairs per point.

    Reference (utils.py:606-621): points with fewer than nmin computed
    pairs get their smallest uncomputed RefineApprox entries set to -1
    so the refinement step picks them.  The reference loops points
    sequentially (later points observe earlier -1 writes); this marks
    in a single pass, as the JAX package does, which changes only the
    tie order of forced pairs.  Returns the updated RA (np.float64
    copy)."""
    P = _index(P_idx, device)
    RA_t = torch.as_tensor(np.asarray(RA, dtype=np.float64), device=device)
    ncm_t = torch.as_tensor(np.asarray(ncm, dtype=bool), device=device)
    return guarantee_nmin_dev(RA_t, ncm_t, P, nmin).cpu().numpy()


def guarantee_nmin_dev(RA, ncm, P, nmin: int):
    """``guarantee_nmin`` on tensors: RA float64 (m,) and ncm bool (m,)
    on P's device.  Returns the updated float64 RA there (a new tensor)."""
    marks = _guarantee_marks(RA.to(_dtype_for(P)), ncm, P, int(nmin))
    return RA.masked_fill(marks, -1.0)


def empirical_cdf_probs(p, labels, errs_by_label, device="cpu"):
    """prob[k] = empirical CDF of the residual distribution of pair k's
    bin, evaluated at margin p[k] (reference get_probs,
    utils.py:581-589).

    p: (m,) float; labels: (m,) int bin labels; errs_by_label: dict
    label -> sorted residual array.  Returns np.float64 (m,)."""
    p = torch.as_tensor(np.asarray(p, dtype=np.float64), device=device)
    labels = torch.as_tensor(np.asarray(labels), device=device)
    return empirical_cdf_probs_dev(p, labels, errs_by_label).cpu().numpy()


def empirical_cdf_probs_dev(p, labels, errs_by_label):
    """``empirical_cdf_probs`` on tensors: p float64 (m,) and labels (m,)
    on one device.  The residuals go up in one copy.  Returns float64
    (m,) there."""
    errs = [(label, np.asarray(e, dtype=np.float64))
            for label, e in errs_by_label.items() if len(e)]
    prob = torch.zeros(p.shape[0], dtype=torch.float64, device=p.device)
    if not errs:
        return prob
    flat = torch.as_tensor(np.concatenate([e for _, e in errs]), device=p.device)
    at = 0
    for label, e in errs:
        # side "left", as np.searchsorted's default
        cdf = torch.searchsorted(flat[at:at + len(e)], p).double() / len(e)
        prob = torch.where(labels == label, cdf, prob)
        at += len(e)
    return prob


def _knn_select(RA32, ncm, P, nn: int, m: int):
    """Each point's nn best pair slots (``penalised_knn_cols``: ties to
    the lower column, as ``lax.top_k`` breaks them)."""
    return penalised_knn_cols(
        point_gather(RA32, P, F32_INF), point_gather(ncm, P, True), P < m, nn
    )


def knn_from_pairs(RA, IJs, P_idx, ncm, nn: int, device="cpu"):
    """k-NN graph assembly (reference get_nn, utils.py:383-429).

    The reported distances are read from the float64 RA, so exact metric
    values keep full precision end to end.  Returns (ngi, ngd, pair_ids),
    each (nx, nn)."""
    nx = P_idx.shape[0]
    m = IJs.shape[0]
    P_np = np.asarray(P_idx)
    if P_np.size < SMALL_MAX_ENTRIES:  # the JAX package's host branch
        padded = np.append(np.asarray(RA, dtype=np.float64), np.inf)
        vals = padded[P_np]
        ncm_pad = np.append(np.asarray(ncm, dtype=bool), True)[P_np]
        valid = P_np < m
        mx = np.max(np.where(valid, vals, -np.inf), axis=1, keepdims=True)
        d = np.where(valid, vals + np.where(ncm_pad, mx, 0.0), np.inf)
        if d.shape[1] < nn:  # fewer candidate slots than neighbours
            pad = np.full((d.shape[0], nn - d.shape[1]), np.inf)
            d = np.concatenate([d, pad], axis=1)
            P_np = np.concatenate(
                [P_np, np.full((d.shape[0], nn - P_np.shape[1]), m)],
                axis=1,
            )
        kk = min(nn - 1, d.shape[1] - 1)
        part = np.argpartition(d, kk, axis=1)[:, :nn]
        dd = np.take_along_axis(d, part, axis=1)
        order = np.argsort(dd, axis=1, kind="stable")
        cols = np.take_along_axis(part, order, axis=1)
    else:
        P = _index(P_np, device)
        cols = _knn_select(
            torch.as_tensor(np.asarray(RA), dtype=torch.float32, device=device),
            torch.as_tensor(np.asarray(ncm, dtype=bool), device=device),
            P, int(nn), m,
        ).cpu().numpy()
    pair_ids = np.take_along_axis(P_np, cols, axis=1)
    pair_sum = np.concatenate([np.asarray(IJs).sum(axis=1), [0]]).astype(
        np.int64
    )
    ngi = pair_sum[pair_ids.astype(np.int64)] - np.arange(nx)[:, None]
    ngi = np.where(pair_ids < m, ngi, -1)
    RA64 = np.concatenate([np.asarray(RA, np.float64), [np.inf]])
    ngd = RA64[pair_ids]
    return ngi.astype(np.int64), ngd, pair_ids


def row_smallest_k(d, k: int):
    """The k smallest entries of each row of the (S, n) tensor d, ascending,
    ties broken by the lower column index as ``lax.top_k`` breaks them (a
    stable sort; ``torch.topk`` gives no tie order, ROADMAP H1).  Returns
    (values (S, k), column indices int64 (S, k)) on d's device."""
    vals, idx = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]
