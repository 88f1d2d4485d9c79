"""Device-resident fit pipeline on one device.

Port of the JAX package's single-device ``ops/device_pipeline.py``: the
dense mode (nx <= 4096) and the scale path's sparse mode.  The whole
per-pair state of a fit lives on one device as

    lb, ub, dad, RA : (m,) f32      ij_i, ij_j : (m,) i32
    ncm             : (m,) bool     P_idx      : (nx, max_deg) i32

and the orchestrator (``annchor.Annchor``) only moves the sample rows,
the regression coefficients and the chosen pair ids across the host
link.  The stage programs are plain functions on tensors, so a test can
start any of them from the JAX package's own state (``convert.py``).
Above MAX_FULL_MATRIX_NX points the tropical tighten's (nx, nx) matrix
gives way to the column-subsampled ``tighten_cols``.  After the fit the
nearest-enemy extras append pairs to the live state and run their
per-point passes over its incidence matrix (``enemy_refine_select``,
``enemy_knn``, ``cover_incidence``).

Parity with the JAX programs:

* every top-k of the reference (``lax.top_k`` breaks ties by the lower
  index) is a stable sort here, ascending or descending, then a slice;
* every argsort is stable, as ``jnp.argsort`` is;
* the sample draw takes its uniforms from the caller (see
  ``default_uniforms``), so a test can hand it JAX's stream.

The edit distances themselves come from the caller's ``batch_dev``
(the metric engine), which on a CUDA device is the hand-written pair
kernel; on a CUDA device the dense tighten's product is the hand-written
K4 (``tropical_product``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from annchor_tpu_torch import parallel, trace
from annchor_tpu_torch.ops import tropical_cuda
from annchor_tpu_torch.ops.bounds_update import _build_E
from annchor_tpu_torch.ops.features import bounds_dad_dev

F32_INF = float("inf")

# the tropical tighten's (nx, nx) matrices up to here; beyond it the
# column-subsampled tighten
MAX_FULL_MATRIX_NX = 4096


def default_uniforms(random_seed: int, loop_num: int, m: int, device):
    """The sample draw's (m,) float32 uniforms in [0, 1): a
    ``torch.Generator`` seeded from (random_seed, loop_num).  The JAX
    package draws ``jax.random.uniform(fold_in(PRNGKey(seed), loop))``
    instead; the two streams differ, so parity tests inject JAX's."""
    seed = np.random.SeedSequence([int(random_seed), int(loop_num)])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed.generate_state(1, np.uint64)[0] >> 1))
    return torch.rand(m, generator=gen, dtype=torch.float32, device=device)


def _threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011) on uint32
    arrays, the block cipher under ``jax.random``'s default PRNG."""
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def jax_threefry_uniforms(random_seed: int, loop_num: int, m: int, device):
    """The uniforms the JAX package's sample draw uses,
    ``jax.random.uniform(fold_in(PRNGKey(random_seed), loop_num), (m,))``
    (threefry-2x32, partitionable counters), recomputed in numpy
    without JAX.  With this source a fit draws the reference's samples."""
    if not 0 <= int(random_seed) < 2**31:
        raise ValueError("random_seed must lie in [0, 2**31)")
    with np.errstate(over="ignore"):
        zero = np.zeros(1, np.uint32)
        k1, k2 = _threefry2x32(
            np.uint32(0), np.uint32(random_seed), zero,
            np.full(1, loop_num, np.uint32),
        )
        idx = np.arange(m, dtype=np.uint64)
        b1, b2 = _threefry2x32(
            k1[0], k2[0], (idx >> np.uint64(32)).astype(np.uint32),
            idx.astype(np.uint32),
        )
    bits = ((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)
    r = bits.view(np.float32) - np.float32(1.0)
    return torch.as_tensor(r, device=device)


# ---------------------------------------------------------------------------
# stage programs (functions of device tensors)


def features(D32, ij_i, ij_j, chunk: int = 1 << 18):
    """LB/UB/dad for every pair (``ops.features.bounds_dad_dev``), in
    chunks of ``chunk`` pairs; the int32 pair columns index directly."""
    return bounds_dad_dev(D32, D32, ij_i, ij_j, chunk)


def _linear_predict(lb, ub, dad, inner_edges, coefs, icepts):
    """The per-bin linear model at every pair (bins (lo, hi])."""
    labels = torch.searchsorted(inner_edges, dad, right=False)
    c = coefs[labels]
    return lb * c[:, 0] + ub * c[:, 1] + dad * c[:, 2] + icepts[labels]


def predict_pairs(lb, ub, dad, inner_edges, coefs, icepts):
    """Prediction of appended pairs (the nearest-enemy path), clipped to
    their bounds whether or not the fit is metric, as the JAX package's
    ``_predict_pairs``."""
    pred = _linear_predict(lb, ub, dad, inner_edges, coefs, icepts)
    return torch.minimum(torch.maximum(pred, lb), ub)


def regress_update(lb, ub, dad, RA, ncm, inner_edges, coefs, icepts,
                   sample_ids, sample_y, is_metric: bool, init: bool):
    """Predict every pair from the per-bin linear model, clip to the
    bounds (metric spaces), land the sample exacts.  Returns (RA', ncm').

    Bins are (lo, hi] (``searchsorted`` left on the interior edges).
    The prediction is lb*c0 + ub*c1 + dad*c2 + ic, rounded after every
    operation; XLA may contract it into fused multiply-adds, so RA can
    differ from the JAX program's in the last few ulps."""
    pred = _linear_predict(lb, ub, dad, inner_edges, coefs, icepts)
    if is_metric:
        pred = torch.minimum(torch.maximum(pred, lb), ub)
    ncm2 = ncm.clone()
    ncm2[sample_ids] = False
    RA2 = pred if init else torch.where(ncm2, pred, RA)
    RA2[sample_ids] = sample_y
    return RA2, ncm2


def predict_sample_host(regression, sample_features):
    """The unclipped per-bin prediction at the sample rows, on the host
    in float32 (same expression and bin convention as
    ``regress_update``), for the residual model."""
    c = np.asarray(regression.coefs, np.float32)
    ic = np.asarray(regression.intercepts, np.float32)
    inner = np.asarray(regression.sample_bins[1:-1], np.float32)
    lb = sample_features[:, 0].astype(np.float32)
    ub = sample_features[:, 1].astype(np.float32)
    dad = sample_features[:, 2].astype(np.float32)
    labels = np.searchsorted(inner, dad, side="left")
    pred = (
        lb * c[labels, 0]
        + ub * c[labels, 1]
        + dad * c[labels, 2]
        + ic[labels]
    )
    return pred.astype(np.float64)


def sample_draw(dad, ncm, r, ilo: int, ihi: int, pool_n: int, quotas,
                equal_mass: bool = False):
    """Stratified without-replacement sample over the not-computed pool.

    Bin edges are a linspace between the pool's ilo-th and ihi-th order
    statistics of dad (or, with ``equal_mass``, pool quantiles); bin b
    contributes quotas[b] ids, uniform within the bin.  ``r`` holds the
    (m,) uniforms.  Returns (ids (sum(quotas),) with -1 where a bin ran
    short, got (K,), inner edges (K-1,))."""
    dev = dad.device
    n_bins = len(quotas)
    inf = torch.tensor(F32_INF, dtype=torch.float32, device=dev)
    svals = torch.sort(torch.where(ncm, dad, inf)).values
    if equal_mass:
        qix = (torch.arange(1, n_bins, device=dev) * pool_n) // n_bins
        inner = svals[qix]
    else:
        lo = svals[ilo]
        hi = svals[ihi]
        steps = torch.arange(n_bins - 1, dtype=torch.float32, device=dev)
        denom = torch.tensor(
            float(max(n_bins - 2, 1)), dtype=torch.float32, device=dev
        )
        inner = lo + (hi - lo) * steps / denom
    labels = torch.searchsorted(inner, dad, right=True)

    # group the pool by bin with a random order inside each bin: labels
    # are < n_bins and the key < 1, so label + key sorts bin-major
    sort_key = torch.where(ncm, labels.to(torch.float32) + r * 0.999, inf)
    order = torch.argsort(sort_key, stable=True)

    pool_labels = torch.where(ncm, labels, n_bins)
    counts = torch.bincount(pool_labels, minlength=n_bins + 1)[:n_bins]
    starts = torch.cumsum(counts, 0) - counts
    # sentinel tail so an under-full last bin never runs off the end
    order = torch.cat(
        [order, torch.full((max(quotas),), -1, dtype=order.dtype, device=dev)]
    )
    picks, got = [], []
    for b, q in enumerate(quotas):
        ids_b = order[starts[b] + torch.arange(q, device=dev)]
        take_b = torch.clamp(counts[b], max=q)
        valid = (torch.arange(q, device=dev) < take_b) & (ids_b >= 0)
        picks.append(torch.where(valid, ids_b, -1))
        got.append(take_b)
    return torch.cat(picks), torch.stack(got), inner


def pidx_full(nx: int, device):
    """Incidence matrix of the all-pairs candidate set in closed form:
    pair (a, b), a < b, has id a*nx - a(a+1)/2 + (b - a - 1)."""
    i = torch.arange(nx, dtype=torch.int64, device=device)[:, None]
    s = torch.arange(nx - 1, dtype=torch.int64, device=device)[None, :]
    partner = s + (s >= i).to(torch.int64)
    a = torch.minimum(i, partner)
    b = torch.maximum(i, partner)
    return (a * nx - a * (a + 1) // 2 + (b - a - 1)).to(torch.int32)


def pidx_from_pairs(ij_i, ij_j, nx: int, max_deg: int, lb=None):
    """Padded (nx, max_deg) incidence matrix by a counting sort over the
    endpoint list (pad = m).  Row p lists p's pairs in the order of the
    stable sort: first those with p = ij_i, then those with p = ij_j,
    each in pair-id order.

    With ``lb`` (the pairs' lower bounds) the matrix is degree-capped:
    each row keeps its ``max_deg`` pairs of smallest lower bound, in
    ascending lower-bound order (a stable sort by lb, then a stable sort
    by endpoint), and drops the rest.  Every pair stays in the flat pair
    state; only the per-point passes lose a hub's farthest candidates."""
    dev = ij_i.device
    m = ij_i.shape[0]
    endpoints = torch.cat([ij_i, ij_j]).long()
    if lb is None:
        order = torch.argsort(endpoints, stable=True)
    else:
        o1 = torch.argsort(lb.repeat(2), stable=True)
        order = o1[torch.argsort(endpoints[o1], stable=True)]
    se = endpoints[order]
    counts = torch.bincount(endpoints, minlength=nx)
    starts = torch.cumsum(counts, 0) - counts
    cols = torch.arange(2 * m, device=dev) - starts[se]
    pair_ids = (order % max(m, 1)).to(torch.int32)  # order indexes [ij_i, ij_j]
    if lb is not None:
        fits = cols < max_deg
        se, cols, pair_ids = se[fits], cols[fits], pair_ids[fits]
    P = torch.full((nx, max_deg), m, dtype=torch.int32, device=dev)
    P[se, cols] = pair_ids
    return P


# resident (nx, max_deg) incidence budget: 2 GB of int32
PIDX_BUDGET_ELEMS = 1 << 29


def _row_block(nx: int, max_deg: int, budget: int = 1 << 27) -> int:
    """Row-block size keeping the (block, max_deg) f32 temporaries of
    the per-point passes under ~budget bytes."""
    return int(min(nx, max(256, budget // (4 * max(max_deg, 1)))))


def _row_blocks(nx: int, blk: int):
    """Block starts; the tail block is clamped to end at nx and may
    overlap its predecessor (rewriting identical values)."""
    return [min(t * blk, nx - blk) for t in range((nx + blk - 1) // blk)]


def guarantee_mark_rows(vals, ncm_rows, valid, nmin: int):
    """Per incidence row, the uncomputed slots whose estimate lies below
    the n_todo-th smallest uncomputed estimate, where n_todo is what the
    row lacks of ``nmin`` computed pairs (reference utils.py:606-621,
    marked in one pass as the JAX package does).  vals, ncm_rows, valid:
    (rows, max_deg).  Returns the bool (rows, max_deg) marks."""
    todo_vals = torch.where(ncm_rows, vals, F32_INF)
    n_computed = ((~ncm_rows) & valid).sum(dim=1)
    n_todo = torch.clamp(nmin - n_computed, 0, vals.shape[1] - 1)
    svals = torch.sort(todo_vals, dim=1).values
    kth = torch.gather(svals, 1, n_todo[:, None])
    return (todo_vals < kth) & ncm_rows & (n_todo[:, None] > 0)


def penalised_knn_cols(vals, ncm_rows, valid, nn: int):
    """Per incidence row, the columns of the nn smallest estimates, where
    uncomputed pairs carry a +rowmax penalty so computed pairs win
    (reference get_nn, utils.py:383-429); ties to the lower column, as
    ``lax.top_k`` breaks them."""
    mx = torch.where(valid, vals, -F32_INF).amax(dim=1, keepdim=True)
    d = torch.where(valid, vals + torch.where(ncm_rows, mx, 0.0), F32_INF)
    return torch.sort(d, dim=1, stable=True).indices[:, :nn]


def select_point_pass(RA_pad, ncm_ext, P_idx, m: int, kk: int, guarantee: bool,
                      nmin: int):
    """The selection's per-point pass over the incidence rows ``P_idx``
    (a block of rows; pad ids >= m): each row's threshold, the (kk+1)-th
    smallest estimate, and with ``guarantee`` the marks of the pairs that
    ``guarantee_mark_rows`` picks.  RA_pad and ncm_ext carry a sentinel
    past the last pair id.  Returns (thresholds (rows,), marks bool
    (len(RA_pad),) or None)."""
    dev = RA_pad.device
    nrows, max_deg = P_idx.shape
    blk = _row_block(nrows, max_deg)
    thresh = torch.zeros(nrows, dtype=torch.float32, device=dev)
    marks = torch.zeros(RA_pad.shape[0], dtype=torch.bool, device=dev) if guarantee else None
    for start in _row_blocks(nrows, blk):
        rows = P_idx[start : start + blk].long()
        vals = RA_pad[rows]
        thresh[start : start + blk] = torch.sort(vals, dim=1).values[:, kk]
        if guarantee:
            mark_rows = guarantee_mark_rows(vals, ncm_ext[rows], rows < m, nmin)
            marks[rows[mark_rows]] = True
    return thresh, marks


def select_pair_probs(thresh, RAg, ncm, ij_i, ij_j, dad, inner_edges, cdf_grid,
                      cdf_lo, cdf_inv, cdf_hi):
    """The selection's per-pair pass: the probability, read from the
    per-bin CDF grid, that each uncomputed pair's margin beats the larger
    endpoint threshold; -1 for computed pairs."""
    margin = torch.maximum(thresh[ij_i.long()], thresh[ij_j.long()]) - RAg
    K, G = cdf_grid.shape
    labels = torch.clamp(torch.searchsorted(inner_edges, dad, right=True), 0, K - 1)
    lo = cdf_lo[labels]
    hi = cdf_hi[labels]
    x = (margin - lo) * cdf_inv[labels]
    # truncation toward zero then clip, as XLA's saturating convert
    # (NaN reads 0; those entries are overwritten below anyway)
    cell = torch.nan_to_num(x, nan=0.0).clamp(0, G - 1).to(torch.int64)
    prob = cdf_grid.reshape(-1)[labels * G + cell]
    prob = torch.where(margin > hi, torch.ones_like(prob), prob)
    prob = torch.where(margin < lo, torch.zeros_like(prob), prob)
    return torch.where(ncm, prob, torch.full_like(prob, -1.0))


def top_ids(prob, k: int):
    """Ids of the k largest entries, ties to the lower id (``lax.top_k``)."""
    return torch.sort(prob, descending=True, stable=True).indices[:k]


def select(RA, ncm, ij_i, ij_j, dad, P_idx, inner_edges, cdf_grid, cdf_lo,
           cdf_inv, cdf_hi, nn: int, n_ref: int, guarantee: bool, nmin: int):
    """Refinement selection (reference annchor.py:395-473).

    Per point, the threshold is the (nn+1)-th smallest RA over its
    incidence row; with ``guarantee``, each point's smallest uncomputed
    estimates are marked so that at least ``nmin`` of its pairs are
    computed or chosen.  Each uncomputed pair then gets the empirical
    probability that its margin beats the larger endpoint threshold,
    read from the per-bin CDF grid, and the n_ref most probable pairs
    are chosen, ties to the lower pair id.

    Returns (chosen ids (n_ref,), thresholds (nx,), ij_i, ij_j at the
    chosen ids)."""
    m = RA.shape[0]
    kk = min(nn, P_idx.shape[1] - 1)
    thresh, marks = select_point_pass(
        _ext(RA, F32_INF), _ext(ncm, False), P_idx, m, kk, guarantee, nmin
    )
    RAg = torch.where(marks[:m], torch.full_like(RA, -1.0), RA) if guarantee else RA
    prob = select_pair_probs(thresh, RAg, ncm, ij_i, ij_j, dad, inner_edges, cdf_grid,
                             cdf_lo, cdf_inv, cdf_hi)
    chosen = top_ids(prob, n_ref)
    return chosen, thresh, ij_i[chosen], ij_j[chosen]


def scatter_exact(RA, ncm, ids, vals):
    """Land a batch of exact distances (in place)."""
    RA[ids] = vals
    ncm[ids] = False
    return RA, ncm


def tropical_product(E, V, Einf, y0: int, y1: int, block: int = 16):
    """The tropical self-product of the computed-distance matrix over
    the columns y0..y1:

        LB[i,j] = max_y |E[i,y] - E[j,y]|   (both entries present)
        UB[i,j] = min_y  E[i,y] + E[j,y]

    E is 0 and Einf +inf wherever V is False.  On a card, K4
    (``ops/tropical_cuda.py``); on the CPU, ``tropical_product_plain``.
    Both give the same bits.  Returns (LB, UB), (nx, nx) float32."""
    if E.is_cuda:
        return tropical_cuda.tropical_product_cuda(E, V, y0, y1)
    return tropical_product_plain(E, V, Einf, y0, y1, block)


def tropical_product_plain(E, V, Einf, y0: int, y1: int, block: int = 16):
    """K4's plain PyTorch version: ``tropical_product`` in blocks of
    ``block`` columns, so each (nx, nx, block) temporary stays bounded.
    Max and min are order-free, so any split of the columns gives the
    same bits."""
    nx = E.shape[0]
    lbM = torch.zeros((nx, nx), dtype=torch.float32, device=E.device)
    ubM = torch.full((nx, nx), F32_INF, dtype=torch.float32, device=E.device)
    for c0 in range(y0, y1, block):
        c1 = min(c0 + block, y1)
        a = E[:, c0:c1]
        v = V[:, c0:c1]
        e = Einf[:, c0:c1]
        diff = (a[:, None, :] - a[None, :, :]).abs_()
        diff.masked_fill_(~(v[:, None, :] & v[None, :, :]), 0.0)
        torch.maximum(lbM, diff.amax(dim=2), out=lbM)
        del diff
        torch.minimum(ubM, (e[:, None, :] + e[None, :, :]).amin(dim=2), out=ubM)
    return lbM, ubM


def rebound_pairs(ij_i, ij_j, ncm, lb, ub, lbM, ubM):
    """Pending pairs take the tightened interval [lbM, ubM] at their
    endpoints."""
    ii = ij_i.long()
    jj = ij_j.long()
    lb2 = torch.where(ncm, torch.maximum(lb, lbM[ii, jj]), lb)
    ub2 = torch.where(ncm, torch.minimum(ub, ubM[ii, jj]), ub)
    return lb2, ub2


def tighten_full(ij_i, ij_j, RA, ncm, lb, ub, nx: int, block: int = 16):
    """Bound tightening by the tropical self-product of the computed
    distances (``tropical_product`` over every column): with E the
    (nx, nx) matrix of computed pairs, pending pairs take the tightened
    interval."""
    E, V = _build_E(torch.stack([ij_i.long(), ij_j.long()], dim=1), RA, ~ncm, nx)
    # E is 0 wherever V is False
    Einf = torch.where(V, E, torch.full_like(E, F32_INF))
    lbM, ubM = tropical_product(E, V, Einf, 0, nx, block)
    return rebound_pairs(ij_i, ij_j, ncm, lb, ub, lbM, ubM)


def tighten_columns(deg, ncol: int, ncol_pad: int):
    """The column tighten's pseudo-anchors: the ``ncol`` points of
    highest computed degree (ties to the lower index, as ``lax.top_k``:
    a stable descending sort), padded to ``ncol_pad`` with repeats of the
    first.  Returns int64 (ncol_pad,)."""
    cols = top_ids(deg, ncol)
    if ncol_pad > ncol:
        cols = torch.cat([cols, cols[:1].expand(ncol_pad - ncol)])
    return cols


def tighten_contenders(ij_i, ij_j, ncm, lb, thresh):
    """Ids (int64, ascending) of the contender pairs: uncomputed, with a
    lower bound under the larger endpoint threshold."""
    cap = torch.maximum(thresh[ij_i], thresh[ij_j])
    return torch.nonzero(ncm & (lb < cap))[:, 0]


def tighten_cols_prep(ij_i, ij_j, ncm, lb, thresh, ncol: int, ncol_pad: int,
                      cmax: int):
    """The column passes' inputs: the pseudo-anchor columns
    (``tighten_columns``) and the first ``cmax`` contender pairs in id
    order.  Returns (cols int64 (ncol_pad,), contender ids int64
    (<= cmax,))."""
    nx = thresh.shape[0]
    done = ~ncm
    deg = torch.bincount(ij_i[done], minlength=nx) + torch.bincount(
        ij_j[done], minlength=nx
    )
    cols = tighten_columns(deg, ncol, ncol_pad)
    return cols, tighten_contenders(ij_i, ij_j, ncm, lb, thresh)[:cmax]


def column_panel(ij_i, ij_j, RA, ncm, cols, n_real: int, nx: int, P_idx=None,
                 out=None):
    """E (nx, len(cols)) float32: E[p, c] is the computed distance of the
    pair (p, cols[c]), +inf where that pair is untracked or uncomputed.

    Without ``P_idx`` the panel is a scatter of the computed pairs that
    touch one of the first ``n_real`` columns (the padding columns stay
    +inf), into ``out`` when given (a panel of other pairs' entries: the
    target slots of distinct pairs differ).  With an uncapped incidence
    matrix it is built from the column points' incidence rows instead,
    which enumerate exactly those pairs (padding columns repeat their
    column's entries).  Either way the target slots are unique, so the
    panel is the same."""
    m = RA.shape[0]
    ncol = cols.shape[0]
    if out is None:
        out = torch.full((nx, ncol), F32_INF, dtype=torch.float32, device=RA.device)
    E = out
    if P_idx is None:
        col_of = torch.full((nx,), -1, dtype=torch.int64, device=RA.device)
        col_of[cols[:n_real]] = torch.arange(n_real, device=RA.device)
        done = torch.nonzero(~ncm)[:, 0]
        i, j, d = ij_i[done], ij_j[done], RA[done]
        for p, q in ((j, i), (i, j)):
            c = col_of[q]
            hit = c >= 0
            E[p[hit].long(), c[hit]] = d[hit]
        return E
    rows = P_idx[cols].long()  # (ncol, max_deg), pad = m
    tracked = rows < m
    r = rows.clamp(max=m - 1)
    good = tracked & ~ncm[r]
    partner = (ij_i[r].long() + ij_j[r].long()) - cols[:, None]
    c_idx = torch.arange(ncol, device=RA.device)[:, None].expand_as(rows)
    E[partner[good], c_idx[good]] = RA[r][good]
    return E


def column_pass(E, ij_i, ij_j, lb, ub, ids, chunk: int):
    """Tighten the pairs ``ids`` against the panel E, ``chunk`` at a
    time, in place:

        lb' = max(lb, max_c |E[i,c] - E[j,c]|)   (both entries present)
        ub' = min(ub, min_c  E[i,c] + E[j,c])"""
    for s in range(0, ids.shape[0], chunk):
        sel = ids[s : s + chunk]
        Ei = E[ij_i[sel].long()]
        Ej = E[ij_j[sel].long()]
        both = (Ei < F32_INF) & (Ej < F32_INF)
        lb_new = torch.where(both, (Ei - Ej).abs(), 0.0).amax(dim=1)
        ub_new = (Ei + Ej).amin(dim=1)
        lb[sel] = torch.maximum(lb[sel], lb_new)
        ub[sel] = torch.minimum(ub[sel], ub_new)


def column_chunks(ncol: int, nx: int, col_chunk: int | None = None):
    """(col_chunk, ncol_pad): the panel is built ``col_chunk`` columns at
    a time (~2^28 elements), the columns padded to a multiple of it."""
    if col_chunk is None:
        col_chunk = max(256, (1 << 28) // max(nx, 1))
    col_chunk = min(ncol, col_chunk)
    return col_chunk, ((ncol + col_chunk - 1) // col_chunk) * col_chunk


def tighten_cols(ij_i, ij_j, RA, ncm, lb, ub, thresh, ncol: int, cmax: int,
                 chunk: int = 65536, P_idx=None, col_chunk: int | None = None):
    """Column-subsampled bound tightening for nx > 4096.

    The full tropical self-product needs an (nx, nx) matrix; here the
    pseudo-anchors are the ``ncol`` highest-computed-degree points (any
    column subset gives valid bounds), and only the contender pairs (at
    most ``cmax``) are updated, ``chunk`` at a time (``column_pass``).
    The (nx, ncol) panel is built ``col_chunk`` columns at a time and
    lb/ub thread through the passes; max and min are order-free, so any
    split gives the same bits.  ``P_idx`` must be an uncapped incidence
    matrix or None (``column_panel``)."""
    nx = thresh.shape[0]
    col_chunk, ncol_pad = column_chunks(ncol, nx, col_chunk)
    cols, ids = tighten_cols_prep(ij_i, ij_j, ncm, lb, thresh, ncol, ncol_pad, cmax)
    trace.count(pairs=int(ids.shape[0]))
    lb = lb.clone()
    ub = ub.clone()
    for c0 in range(0, ncol_pad, col_chunk):
        E = column_panel(
            ij_i, ij_j, RA, ncm, cols[c0 : c0 + col_chunk],
            min(col_chunk, ncol - c0), nx, P_idx,
        )
        column_pass(E, ij_i, ij_j, lb, ub, ids, chunk)
        del E
    return lb, ub


def clip_ra(RA, ncm, lb, ub):
    """Re-clip the never-computed estimates into the tightened interval."""
    return torch.where(ncm, torch.minimum(torch.maximum(RA, lb), ub), RA)


def _ext(t, fill):
    """t with one sentinel entry ``fill`` appended (read at pad id m)."""
    return torch.cat([t, torch.full((1,), fill, dtype=t.dtype, device=t.device)])


def _pair_sums(ij_i, ij_j):
    """i + j per pair, with a 0 sentinel at id m: a row's partner is the
    pair sum minus the row."""
    return _ext(ij_i.long() + ij_j.long(), 0)


# The per-point passes below read a block of incidence rows, P_idx =
# rows row0.. of the (nx, max_deg) matrix, against the whole pair state
# extended by one sentinel (RA_pad, ncm_ext, pair_sum; pad ids >= m, the
# number of real pairs).  The single-device functions pass every row;
# the sharded fit (``ops/sharded_fit.py``) passes each shard's rows.


def knn_rows(RA_pad, ncm_ext, pair_sum, P_idx, nn: int, m: int, row0: int = 0):
    """``knn`` over a block of incidence rows."""
    dev = RA_pad.device
    nrows, max_deg = P_idx.shape
    ids = torch.zeros((nrows, nn), dtype=torch.int64, device=dev)
    part = torch.zeros((nrows, nn), dtype=torch.int64, device=dev)
    ra = torch.zeros((nrows, nn), dtype=torch.float32, device=dev)
    cm = torch.zeros((nrows, nn), dtype=torch.bool, device=dev)
    blk = _row_block(nrows, max_deg)
    for start in _row_blocks(nrows, blk):
        rows = P_idx[start : start + blk].long()
        vals = RA_pad[rows]
        ncm_rows = ncm_ext[rows]
        cols = penalised_knn_cols(vals, ncm_rows, rows < m, nn)
        pair_ids = torch.gather(rows, 1, cols)
        row_ids = torch.arange(row0 + start, row0 + start + blk, device=dev)[:, None]
        partners = pair_sum[pair_ids] - row_ids
        ids[start : start + blk] = pair_ids
        part[start : start + blk] = torch.where(pair_ids < m, partners, -1)
        ra[start : start + blk] = torch.gather(vals, 1, cols)
        cm[start : start + blk] = ~torch.gather(ncm_rows, 1, cols)
    return ids, part, ra, cm


def knn(RA, ncm, P_idx, ij_i, ij_j, nn: int):
    """Graph assembly (reference get_nn, utils.py:383-429): per point,
    the nn smallest of its incidence row, where uncomputed pairs carry a
    +rowmax penalty so computed pairs win (ties to the lower column).

    Returns (pair ids (nx, nn), partners, RA values, computed flags)."""
    return knn_rows(_ext(RA, F32_INF), _ext(ncm, True), _pair_sums(ij_i, ij_j), P_idx,
                    nn, RA.shape[0])


# ---------------------------------------------------------------------------
# nearest-enemy and selective-subset passes (reference annchor.py:685-940):
# the per-point passes of ``select``/``knn`` restricted to differently
# labelled partners, so the extras run on the live fit state


def _row_view(P_idx, pair_sum, start: int, blk: int, m: int, row0: int, nx: int):
    """(rows, valid, row ids, partners clamped into [0, nx), partners)
    of the incidence rows start..start+blk of a block whose first row is
    point row0.  Row ids past nx (a sharded matrix's padding rows, whose
    entries are all pads) are clamped to nx - 1 for label lookups."""
    rows = P_idx[start : start + blk].long()
    row_ids = torch.arange(row0 + start, row0 + start + blk, device=P_idx.device)
    others = pair_sum[rows] - row_ids[:, None]
    return rows, rows < m, row_ids.clamp(max=nx - 1), others.clamp(0, nx - 1), others


def enemy_refine_rows(RA_pad, ncm_ext, pair_sum, P_idx, y, kk: int, m: int,
                      row0: int = 0):
    """``enemy_refine_select`` over a block of incidence rows (kk <=
    max_deg)."""
    nrows, max_deg = P_idx.shape
    nx = y.shape[0]
    out = torch.full((nrows, kk), m, dtype=torch.int64, device=RA_pad.device)
    blk = _row_block(nrows, max_deg)
    for start in _row_blocks(nrows, blk):
        rows, valid, row_ids, oc, _ = _row_view(P_idx, pair_sum, start, blk, m, row0, nx)
        emask = valid & (y[oc] != y[row_ids][:, None])
        dmat = torch.where(emask, RA_pad[rows], F32_INF)
        cols = torch.sort(dmat, dim=1, stable=True).indices[:, :kk]
        ids_sel = torch.gather(rows, 1, cols)
        sel_ok = torch.gather(emask, 1, cols) & ncm_ext[ids_sel]
        out[start : start + blk] = torch.where(sel_ok, ids_sel, m)
    return out


def enemy_refine_select(RA, ncm, P_idx, ij_i, ij_j, y, k: int):
    """Per point, its k closest predicted differently-labelled partners
    among its tracked pairs, ties to the lower column, where still
    uncomputed (reference annchor.py:753-769).  y: int64 label codes.
    Returns int64 (nx, min(k, max_deg)) pair ids, m where none."""
    return enemy_refine_rows(_ext(RA, F32_INF), _ext(ncm, False), _pair_sums(ij_i, ij_j),
                             P_idx, y, min(int(k), P_idx.shape[1]), RA.shape[0])


def enemy_knn_rows(RA_pad, ncm_ext, pair_sum, P_idx, y, nn: int, m: int, row0: int = 0):
    """``enemy_knn`` over a block of incidence rows."""
    dev = RA_pad.device
    nrows, max_deg = P_idx.shape
    nx = y.shape[0]
    ids = torch.zeros((nrows, nn), dtype=torch.int64, device=dev)
    part = torch.zeros((nrows, nn), dtype=torch.int64, device=dev)
    ra = torch.zeros((nrows, nn), dtype=torch.float32, device=dev)
    blk = _row_block(nrows, max_deg)
    for start in _row_blocks(nrows, blk):
        rows, valid, row_ids, oc, others = _row_view(P_idx, pair_sum, start, blk, m, row0,
                                                     nx)
        vals = RA_pad[rows]
        same = y[oc] == y[row_ids][:, None]
        mx = torch.where(valid, vals, -F32_INF).amax(dim=1, keepdim=True)
        mx = torch.where(torch.isfinite(mx), mx, 0.0)
        dpen = torch.where(
            valid,
            vals + torch.where(valid & ncm_ext[rows], mx, 0.0)
            + torch.where(valid & same, mx, 0.0),
            F32_INF,
        )
        cols = torch.sort(dpen, dim=1, stable=True).indices[:, :nn]
        pair_ids = torch.gather(rows, 1, cols)
        ids[start : start + blk] = pair_ids
        # the host assembly leaves a missing partner at 0
        part[start : start + blk] = torch.where(
            pair_ids < m, torch.gather(others, 1, cols), 0
        )
        ra[start : start + blk] = torch.gather(
            torch.where(valid, vals, F32_INF), 1, cols
        )
    return ids, part, ra


def enemy_knn(RA, ncm, P_idx, ij_i, ij_j, y, nn: int):
    """Nearest-enemy graph assembly (reference annchor.py:771-787): per
    point the nn smallest of its incidence row, where uncomputed and
    same-label partners each carry a +rowmax penalty (ties to the lower
    column).  Returns (pair ids, partners (0 where none), RA values),
    each (nx, nn)."""
    return enemy_knn_rows(_ext(RA, F32_INF), _ext(ncm, True), _pair_sums(ij_i, ij_j),
                          P_idx, y, nn, RA.shape[0])


def cover_incidence_rows(dists_pad, pair_sum, P_idx, slot, radii, S: int, m: int,
                         row0: int = 0):
    """``cover_incidence`` over a block of incidence rows: (rows, S)."""
    nrows, max_deg = P_idx.shape
    nx = slot.shape[0]
    inc = torch.zeros((nrows, S), dtype=torch.int32, device=dists_pad.device)
    blk = _row_block(nrows, max_deg)
    for start in _row_blocks(nrows, blk):
        rows, valid, row_ids, oc, _ = _row_view(P_idx, pair_sum, start, blk, m, row0, nx)
        sl = slot[oc]
        live = valid & (sl >= 0) & (dists_pad[rows] < radii[row_ids][:, None] - 1e-6)
        r = torch.arange(start, start + blk, device=inc.device)[:, None].expand_as(rows)
        inc[r[live], sl[live]] = 1
    return inc


def cover_incidence(RA, ncm, ub, P_idx, ij_i, ij_j, slot, radii, S: int):
    """Selective-subset cover incidence: inc[p, s] = 1 iff subset member
    s (``slot`` maps a point to its member index, -1 for non-members) is
    a tracked partner of p strictly inside p's enemy radius, by the
    pair's exact value or, where uncomputed, its upper bound.
    Returns int32 (nx, S)."""
    return cover_incidence_rows(_ext(torch.where(ncm, ub, RA), F32_INF),
                                _pair_sums(ij_i, ij_j), P_idx, slot, radii, S, RA.shape[0])


# ---------------------------------------------------------------------------
# the fit state


class ExactStore:
    """Float64 store of computed pair distances, keyed by pair id and
    kept id-sorted for batched binary-search lookup.  Every fit keeps its
    exact values here: only the anchor pairs and the evaluated pairs (the
    eval budget) ever exist on the host."""

    def __init__(self):
        self.ids = np.empty(0, np.int64)
        self.vals = np.empty(0, np.float64)

    def add(self, ids, vals):
        """Insert values; an id repeated in the batch keeps its first
        value, and an id already stored has its value refreshed.  Returns
        the number of ids not stored before (the sampling budget drops
        by this, so repeats cannot drift it)."""
        ids = np.asarray(ids, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        uids, first = np.unique(ids, return_index=True)
        uvals = vals[first]
        pos = np.searchsorted(self.ids, uids)
        if self.ids.shape[0]:
            pos_c = np.clip(pos, 0, self.ids.shape[0] - 1)
            exists = self.ids[pos_c] == uids
            if exists.any():
                self.vals[pos_c[exists]] = uvals[exists]
                uids, uvals, pos = uids[~exists], uvals[~exists], pos[~exists]
        self.ids = np.insert(self.ids, pos, uids)
        self.vals = np.insert(self.vals, pos, uvals)
        return int(uids.shape[0])

    def lookup(self, q):
        """Values for the pair ids ``q`` (any shape), NaN where none is
        stored."""
        q = np.asarray(q, dtype=np.int64)
        out = np.full(q.shape, np.nan)
        if self.ids.shape[0] == 0:
            return out
        pos = np.clip(np.searchsorted(self.ids, q), 0, self.ids.shape[0] - 1)
        hit = self.ids[pos] == q
        out[hit] = self.vals[pos[hit]]
        return out


def host_pairs(ij_i, ij_j, m: int):
    """The (m, 2) host array of a device pair list."""
    return torch.stack([ij_i[:m], ij_j[:m]], dim=1).cpu().numpy()


class DeviceFitState:
    """Device-resident pair state of a fit plus its host bookkeeping.

    The state takes its inputs as arguments and, from then on, owns the
    fit's pair list and the per-point counts ``P_cnt``.  A dense fit
    (nx <= 4096) hands it the host (m, 2) pair array; a scale-path fit
    hands it the device pair list (ij_i, ij_j, m) of its build, which
    never reaches the host unless read (``sparse``).  Either way the
    not-computed mask lives on the device and the exact float64 values
    in an ``ExactStore``.

    On a device mesh (``parallel.auto_mesh``) the per-pair arrays and the
    incidence matrix are lists of per-shard tensors and every stage runs
    through ``self.shard`` (``ops/sharded_fit.ShardedFit``); the host
    bookkeeping is the same."""

    CDF_GRID = 4096
    TIGHTEN_NCOL = 2048  # pseudo-anchor columns above MAX_FULL_MATRIX_NX
    TIGHTEN_CMAX = 1 << 23  # contender pairs per column tighten
    shard = None  # the ShardedFit of a state on a device mesh

    def __init__(self, device, nx, D, A, P_cnt, pairs, is_metric, n_neighbors):
        self.device = dev = device
        self.nx = nx
        self.D = np.asarray(D)
        self.A = np.asarray(A, dtype=np.int64)
        self.P_cnt = P_cnt
        self.is_metric = bool(is_metric)
        self.n_neighbors = int(n_neighbors)
        self.sparse = isinstance(pairs, tuple)
        if self.sparse:
            self.ij_i, self.ij_j, self.m = pairs
            self.ij_host = None  # assembled on the first host read
        else:
            self.ij_host = pairs
            self.m = pairs.shape[0]
            self.ij_i = torch.as_tensor(pairs[:, 0].astype(np.int32), device=dev)
            self.ij_j = torch.as_tensor(pairs[:, 1].astype(np.int32), device=dev)

        # a device mesh shards the whole pair state; sentinel pairs (0, 0)
        # pad it to a multiple of the mesh size
        mesh = parallel.auto_mesh(dev)
        self.shard = None
        if mesh is not None:
            from annchor_tpu_torch.ops.sharded_fit import ShardedFit

            s = mesh.size
            self.shard = ShardedFit(mesh, self.m, -(-self.m // s) * s, nx, -(-nx // s) * s)
            self.device = dev = mesh.devices[0]
            self.ij_i = self.shard.put_pairs(self.ij_i, fill=0)
            self.ij_j = self.shard.put_pairs(self.ij_j, fill=0)
        self.m_pad = self.m if self.shard is None else self.shard.m_pad

        self._D32 = torch.as_tensor(self.D.astype(np.float32), device=dev)
        # keep the (chunk, na) gathers near 0.5 GB
        self._fchunk = max(1 << 18, (1 << 27) // max(self._D32.shape[1], 1))
        if self.shard is not None:
            self.lb, self.ub, self.dad = self.shard.features(self._D32, self.ij_i, self.ij_j,
                                                             self._fchunk)
        else:
            self.lb, self.ub, self.dad = features(self._D32, self.ij_i, self.ij_j, self._fchunk)

        if not self.sparse and self.m == nx * (nx - 1) // 2:
            self.P_idx_d = pidx_full(nx, dev)
            if self.shard is not None:
                self.P_idx_d = self.shard.put_rows(self.P_idx_d)
            self._pidx_capped = True
        else:
            self._rebuild_pidx()

        self._is_anchor = np.zeros(nx, dtype=bool)
        self._is_anchor[self.A] = True
        is_anchor = torch.as_tensor(self._is_anchor, device=dev)
        if self.shard is not None:
            # sentinel pairs are neither anchor pairs nor samplable
            flags, self.ncm = [], []
            for c, isa in enumerate(parallel.broadcast(is_anchor, self.shard.devices)):
                af = isa[self.ij_i[c]] | isa[self.ij_j[c]]
                real = self.shard._real_mask(c)
                if real is not None:
                    af = af & real
                flags.append(af)
                self.ncm.append(~af if real is None else ~af & real)
            ids = np.concatenate([
                torch.nonzero(af)[:, 0].cpu().numpy() + c * self.shard.shard_m
                for c, af in enumerate(flags)
            ])
        else:
            af = is_anchor[self.ij_i] | is_anchor[self.ij_j]
            self.ncm = ~af
            ids = torch.nonzero(af)[:, 0].cpu().numpy()
        self.exact = ExactStore()
        self.pool = self.m - ids.shape[0]
        self._anchor_ids = ids.astype(np.int64)
        self._fill_anchor_exacts(self._anchor_ids)

        self.RA = torch.zeros(self.m, dtype=torch.float32, device=dev)
        if self.shard is not None:
            # sentinel RA stays +inf: incidence pads read "worse than all"
            self.RA = self.shard.put_pairs(self.RA, fill=F32_INF)
        self.thresh = None
        self._started = False
        self._pending_exact = []
        self._tracked_keys = None  # sorted packed pair keys (tracked_mask)

        # non-metric fits: anchor pairs keep their exact column values
        # once predictions stop being clipped to the bounds
        self._override = None
        if not self.is_metric and len(self._anchor_ids):
            ids = self._anchor_ids
            vals = self.exact.lookup(ids).astype(np.float32)
            if self.shard is not None:
                self._override = self.shard.localize(ids, vals)
            else:
                self._override = (
                    torch.as_tensor(ids, device=dev), torch.as_tensor(vals, device=dev)
                )

    @property
    def _pidx_width(self) -> int:
        P = self.P_idx_d[0] if self.shard is not None else self.P_idx_d
        return int(P.shape[1])

    def _rebuild_pidx(self):
        """Incidence matrix on the device.  Rows are capped at
        max(2 nn, PIDX budget / nx) entries (``ANNCHOR_TPU_PIDX_BUDGET``
        overrides the 2^29-element budget); a capped matrix keeps each
        row's smallest-lower-bound pairs and cannot feed the column
        tighten's panel build."""
        nx = self.nx
        max_deg = int(np.asarray(self.P_cnt).max())
        budget = int(os.environ.get("ANNCHOR_TPU_PIDX_BUDGET", PIDX_BUDGET_ELEMS))
        cap = max(2 * self.n_neighbors, budget // max(nx, 1))
        self._pidx_capped = max_deg > cap
        if self.shard is not None:
            self.P_idx_d = self.shard.build_pidx(
                self.ij_i, self.ij_j, self.lb, nx, min(cap, max_deg), self._pidx_capped
            )
        elif self._pidx_capped:
            self.P_idx_d = pidx_from_pairs(self.ij_i, self.ij_j, nx, cap, lb=self.lb)
        else:
            self.P_idx_d = pidx_from_pairs(self.ij_i, self.ij_j, nx, max_deg)

    def _gather_rows(self, arrs, ids):
        """Values of per-pair arrays at the pair ids ``ids`` (a tensor)."""
        if self.shard is not None:
            return self.shard.gather_pairs(arrs, ids)
        return tuple(a[ids] for a in arrs)

    def _flat(self, t):
        """A per-pair array's real entries as one tensor (on the mesh's
        first device)."""
        return t if self.shard is None else self.shard.real(t)

    def _host(self, t):
        """A per-pair array's real entries on the host."""
        return self._flat(t).cpu().numpy()

    def device_pairs(self):
        """The device pair list (ij_i, ij_j, m) of a sparse state, None
        for a dense one."""
        if not self.sparse:
            return None
        return self._flat(self.ij_i), self._flat(self.ij_j), self.m

    @property
    def IJs(self):
        """The (m, 2) host pair list: a dense fit's own; a sparse fit's
        is downloaded on the first read."""
        if self.ij_host is None:
            self.ij_host = host_pairs(*self.device_pairs())
        return self.ij_host

    def _pairs_at(self, ids):
        """(len, 2) int64 host pair coordinates for pair ids."""
        if self.ij_host is not None:
            return self.ij_host[ids].astype(np.int64)
        idd = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        ii, jj = self._gather_rows((self.ij_i, self.ij_j), idd)
        return torch.stack([ii, jj], dim=1).cpu().numpy().astype(np.int64)

    def _store_exact(self, ids, vals):
        # pool decrements by the count of genuinely new ids, so repeats
        # cannot drift the sampling budget
        self.pool -= self.exact.add(ids, vals)

    def _fill_anchor_exacts(self, ids):
        """Anchor-pair rows are exact from the D columns."""
        if not len(ids):
            return
        col_of = np.full(self.nx, -1, dtype=np.int64)
        col_of[self.A] = np.arange(len(self.A))
        IJ = self._pairs_at(ids)
        ii, jj = IJ[:, 0], IJ[:, 1]
        i_is_anchor = col_of[ii] >= 0
        other = np.where(i_is_anchor, jj, ii)
        col = np.where(i_is_anchor, col_of[ii], col_of[jj])
        self.exact.add(ids, self.D[other, col])

    # -- stage methods ------------------------------------------------------

    def draw_sample(self, sampler, n_samples, random_seed, batch_dev=None,
                    uniforms=None):
        """Stratified sample drawn on the device, mirroring
        SimpleStratifiedSampler (same budget warnings, same per-loop
        seed advance).  ``uniforms(random_seed, loop_num, m, device)``
        supplies the draw's random numbers (``default_uniforms`` when
        None).  With ``batch_dev`` the sample distances are evaluated on
        the device before anything comes down.

        Returns (ids, bins, features (n, 4), pair coords (n, 2),
        sample distances (n,) or None)."""
        from annchor_tpu_torch.samplers import NothingToSample

        pool = self.pool
        if pool <= 0:
            raise NothingToSample()
        ilo, ihi, adjusted = sampler.plan(pool, n_samples)
        if adjusted != n_samples:
            print(
                "Warning: n_samples has changed from %d to %d."
                % (n_samples, adjusted)
            )
        if adjusted == 0:
            raise NothingToSample()
        P = sampler.n_partitions
        quotas = [adjusted // P] * P
        for b in range(adjusted % P):
            quotas[b] += 1

        r = (uniforms or default_uniforms)(
            random_seed, sampler.loop_num, self.m, self.device
        )
        sampler.loop_num += 1
        if self.shard is not None:
            # the padding's draws are never read: its pairs are not in the pool
            r = torch.cat([r, r.new_zeros(self.m_pad - self.m)])
            draw = self.shard.sample_draw
            dad, ncm = self.dad, self.ncm
        else:
            draw, dad, ncm = sample_draw, self.dad, self.ncm

        def run(quotas_t, equal_mass=False):
            ids, got, inner = draw(
                dad, ncm, r, min(ilo, pool - 1), min(ihi, pool - 1),
                pool, quotas_t, equal_mass=equal_mass,
            )
            c = ids.clamp(0, self.m - 1)
            rows = self._gather_rows((self.lb, self.ub, self.dad, self.ij_i, self.ij_j), c)
            y = None if batch_dev is None else batch_dev(rows[3], rows[4])
            return ids.cpu().numpy(), got.cpu().numpy(), inner, rows, y

        ids, got, inner, rows, y = run(tuple(quotas))
        if got.min(initial=2) < 2:
            # linspace edges in density gaps (multimodal distances):
            # retry with equal-mass edges, then degrade to uniform
            print(
                "Warning: stratification bins degenerate; "
                "switching to equal-mass bins."
            )
            ids, got, inner, rows, y = run(tuple(quotas), equal_mass=True)
            if got.min(initial=2) < 2:
                print(
                    "Warning: stratification bins degenerate; "
                    "sampling uniformly."
                )
                ids, got, _, rows, y = run((adjusted,))
        ids = ids.astype(np.int64)
        keep = ids >= 0
        ids = ids[keep]
        if ids.shape[0] != adjusted:
            print("Warning: Some bins contained fewer samples than requested")
        bins = np.concatenate(
            ([-np.inf], inner.cpu().numpy().astype(np.float64), [np.inf])
        )
        lb, ub, dad, ii, jj = (t.cpu().numpy()[keep] for t in rows)
        feats = np.empty((ids.shape[0], 4), dtype=np.float64)
        feats[:, 0] = lb
        feats[:, 1] = ub
        feats[:, 2] = dad
        # samples come from the not-computed pool, which holds no anchor pair
        feats[:, 3] = 0.0
        IJ = np.stack([ii, jj], axis=1).astype(np.int64)
        if y is not None:
            y = y.cpu().numpy().astype(np.float64)[keep]
        return ids, bins, feats, IJ, y

    def regress_update(self, regression, sample_ids, sample_y,
                       sample_features):
        """Predict and clip every pair on the device and land the sample
        exacts.  Returns the unclipped sample predictions, computed on
        the host from the sample feature rows."""
        dev = self.device
        inner = torch.as_tensor(
            np.asarray(regression.sample_bins[1:-1], dtype=np.float32), device=dev
        )
        coefs = torch.as_tensor(np.asarray(regression.coefs, np.float32), device=dev)
        icepts = torch.as_tensor(
            np.asarray(regression.intercepts, np.float32), device=dev
        )
        init = not self._started
        if self.shard is not None:
            self.RA, self.ncm = self.shard.regress_update(
                self.lb, self.ub, self.dad, self.RA, self.ncm, inner, coefs, icepts,
                sample_ids, sample_y, self.is_metric, init,
            )
            if self._override is not None:
                self.RA = self.shard.override_rows(self.RA, self._override)
        else:
            sids = torch.as_tensor(sample_ids.astype(np.int64), device=dev)
            sy = torch.as_tensor(sample_y.astype(np.float32), device=dev)
            self.RA, self.ncm = regress_update(
                self.lb, self.ub, self.dad, self.RA, self.ncm,
                inner, coefs, icepts, sids, sy, self.is_metric, init,
            )
            if self._override is not None:
                self.RA[self._override[0]] = self._override[1]
        self._started = True
        self._store_exact(sample_ids, sample_y)
        return predict_sample_host(regression, sample_features)

    def _cdf_tables(self, error_predictor):
        """Each bin's empirical residual CDF sampled onto a fixed grid
        (host; the per-bin arrays total a few thousand floats)."""
        K = error_predictor.n_partitions
        G = self.CDF_GRID
        grid = np.zeros((K, G), dtype=np.float32)
        lo = np.full(K, np.inf, dtype=np.float32)
        hi = np.full(K, np.inf, dtype=np.float32)
        inv = np.zeros(K, dtype=np.float32)
        for b in range(K):
            e = np.asarray(error_predictor.errs.get(b, np.zeros(0)))
            if len(e) == 0:
                continue  # lo = +inf: every margin reads probability 0
            lo[b], hi[b] = e[0], e[-1]
            span = float(hi[b] - lo[b])
            if span > 0:
                inv[b] = (G - 1) / span
            xs = lo[b] + np.arange(G) / max(inv[b], 1e-30)
            grid[b] = np.searchsorted(e, xs) / len(e)
        return grid, lo, hi, inv

    def _select(self, error_predictor, n_ref, nn, guarantee, nmin):
        dev = self.device
        bins = error_predictor.partition_bins
        inner = torch.as_tensor(np.asarray(bins[1:-1], dtype=np.float32), device=dev)
        grid, lo, hi, inv = (
            torch.as_tensor(a, device=dev) for a in self._cdf_tables(error_predictor)
        )
        run = select if self.shard is None else self.shard.select
        chosen, self.thresh, sel_i, sel_j = run(
            self.RA, self.ncm, self.ij_i, self.ij_j, self.dad, self.P_idx_d,
            inner, grid, lo, inv, hi,
            int(nn), n_ref, bool(guarantee), int(nmin),
        )
        return chosen, sel_i, sel_j

    def select(self, error_predictor, n_ref, nn, guarantee, nmin):
        """Selection without the fused eval.  Returns (chosen pair ids,
        (n_ref, 2) pair coordinates) on the host."""
        n_ref = int(min(n_ref, self.pool))
        if n_ref <= 0:
            self.thresh = None
            return np.zeros(0, dtype=np.int64), np.zeros((0, 2), dtype=np.int64)
        chosen, sel_i, sel_j = self._select(error_predictor, n_ref, nn, guarantee, nmin)
        IJ = torch.stack([sel_i, sel_j], dim=1).cpu().numpy().astype(np.int64)
        return chosen.cpu().numpy().astype(np.int64), IJ

    def select_refine_fused(self, error_predictor, n_ref, nn, guarantee, nmin,
                            batch_dev):
        """Selection, device eval of the chosen pairs and their scatter,
        with nothing downloaded: the ids and values are kept for one
        flush when the exact store is read.  Returns the eval count."""
        n_ref = int(min(n_ref, self.pool))
        if n_ref <= 0:
            self.thresh = None
            return 0
        chosen, sel_i, sel_j = self._select(error_predictor, n_ref, nn, guarantee, nmin)
        y = batch_dev(sel_i, sel_j).to(torch.float32)
        scatter = scatter_exact if self.shard is None else self.shard.scatter_exact
        self.RA, self.ncm = scatter(self.RA, self.ncm, chosen, y)
        # `chosen` holds n_ref distinct uncomputed ids (computed pairs
        # score -1 and n_ref <= pool), so the budget is settled now
        self._pending_exact.append((chosen, y))
        self.pool -= n_ref
        return n_ref

    def _flush_exacts(self):
        """Land every deferred fused-select batch in the host store
        (the pool was settled when the batch ran)."""
        for ch, yv in self._pending_exact:
            self.exact.add(ch.cpu().numpy().astype(np.int64),
                           yv.cpu().numpy().astype(np.float64))
        self._pending_exact = []

    def seed_ra_from_store(self):
        """Scatter every stored exact value into the device RA (for fits
        that end before the first regression predict ran)."""
        self._flush_exacts()
        if self.exact.ids.shape[0]:
            self.apply_exact(self.exact.ids, self.exact.vals)

    def apply_exact(self, ids, vals):
        if self.shard is not None:
            self.RA, self.ncm = self.shard.scatter_exact_host(self.RA, self.ncm, ids, vals)
        else:
            idd = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
            vd = torch.as_tensor(np.asarray(vals, np.float32), device=self.device)
            self.RA, self.ncm = scatter_exact(self.RA, self.ncm, idd, vd)
        self._store_exact(ids, vals)

    def tighten(self):
        """Tropical tighten of every pending pair up to
        MAX_FULL_MATRIX_NX points; above it the column-subsampled
        tighten of the contender pairs, which needs the thresholds of a
        selection.  The span ``pipeline.tighten`` (a ``device_span``:
        synchronised while a profiler records) counts the ``pairs`` whose
        bounds it recomputes (all m with K4, the contenders with the
        columns, 0 without thresholds) and the ``cols`` (0 with K4)."""
        devices = (self.device,) if self.shard is None else self.shard.devices
        with trace.device_span("pipeline.tighten", devices, pairs=0, cols=0) as sp:
            nx = self.nx
            args = (self.ij_i, self.ij_j, self.RA, self.ncm, self.lb, self.ub)
            if nx <= MAX_FULL_MATRIX_NX:
                sp.count(pairs=self.m)
                run = tighten_full if self.shard is None else self.shard.tighten_full
                self.lb, self.ub = run(*args, nx)
                return
            if self.thresh is None:
                return
            ncol, cmax = min(self.TIGHTEN_NCOL, nx), int(min(self.TIGHTEN_CMAX, self.m))
            sp.count(cols=ncol)  # tighten_cols counts the pairs
            if self.shard is not None:
                self.lb, self.ub = self.shard.tighten_cols(*args, self.thresh, ncol, cmax)
            else:
                self.lb, self.ub = tighten_cols(
                    *args, self.thresh, ncol, cmax,
                    P_idx=None if self._pidx_capped else self.P_idx_d,
                )

    def finalise(self):
        self.tighten()
        run = clip_ra if self.shard is None else self.shard.clip_ra
        self.RA = run(self.RA, self.ncm, self.lb, self.ub)

    def knn_graph(self, nn):
        """Final k-NN graph: exact distances from the float64 exact
        store, predicted ones from the f32 estimates.  A computed edge
        whose value is still pending on the host reads its RA entry,
        which holds the same f32 value the flush would store."""
        nn = min(int(nn), self._pidx_width)
        run = knn if self.shard is None else self.shard.knn
        pair_ids, partners, ra_sel, sel_cm = (
            t.cpu().numpy()
            for t in run(self.RA, self.ncm, self.P_idx_d, self.ij_i, self.ij_j, nn)
        )
        pair_ids = pair_ids.astype(np.int64)
        ngi = partners.astype(np.int64)
        ra_sel = ra_sel.astype(np.float64)
        exact = self.exact.lookup(np.clip(pair_ids, 0, self.m - 1))
        is_exact = (pair_ids < self.m) & sel_cm
        self.ng_exact_mask = is_exact
        ngd = np.where(is_exact & ~np.isnan(exact), exact, ra_sel)
        return ngi, ngd

    # -- nearest enemies and the selective subset ----------------------------

    def tracked_mask(self, IJ):
        """Host bool mask: which pairs (i < j) of the (k, 2) array ``IJ``
        are in the tracked pair list.  The packed keys i*nx + j of the
        list are sorted once (until the list grows) and searched with
        ``torch.searchsorted``; the pair list never reaches the host."""
        IJ = np.asarray(IJ, dtype=np.int64)
        if IJ.shape[0] == 0 or self.m == 0:
            return np.zeros(IJ.shape[0], dtype=bool)
        nx = self.nx
        if self._tracked_keys is None:
            ii, jj = self._flat(self.ij_i), self._flat(self.ij_j)
            self._tracked_keys = torch.sort(ii.long() * nx + jj.long()).values
        keys = self._tracked_keys
        q = torch.as_tensor(IJ[:, 0] * nx + IJ[:, 1], device=self.device)
        pos = torch.searchsorted(keys, q).clamp_(max=self.m - 1)
        return (keys[pos] == q).cpu().numpy()

    def append_pairs(self, IJ_new, regression):
        """Append candidate pairs (the nearest-enemy path's new enemy
        candidates) to the state: features and clipped predictions on
        the device, anchor pairs exact from the D columns, and the pair
        list, ``P_cnt`` and the incidence matrix kept aligned at the new
        m (reference annchor.py:734-742).  A sharded state is split anew
        over the mesh at the new m."""
        self._flush_exacts()
        nx = self.nx
        dev = self.device
        IJ_new = np.asarray(IJ_new)
        k = IJ_new.shape[0]
        if k == 0:
            return
        m_old = self.m
        ii = torch.as_tensor(IJ_new[:, 0].astype(np.int32), device=dev)
        jj = torch.as_tensor(IJ_new[:, 1].astype(np.int32), device=dev)
        lb2, ub2, dad2 = features(self._D32, ii, jj, self._fchunk)

        def f32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

        pred = predict_pairs(
            lb2, ub2, dad2, f32(regression.sample_bins[1:-1]),
            f32(regression.coefs), f32(regression.intercepts),
        )
        is_anchor = self._is_anchor[IJ_new[:, 0]] | self._is_anchor[IJ_new[:, 1]]
        ncm_new = ~is_anchor

        cat = {
            "ij_i": (ii, 0), "ij_j": (jj, 0), "lb": (lb2, 0), "ub": (ub2, F32_INF),
            "dad": (dad2, 0), "RA": (pred, F32_INF),
            "ncm": (torch.as_tensor(ncm_new, device=dev), False),
        }
        cat = {name: (torch.cat([self._flat(getattr(self, name)), t]), fill)
               for name, (t, fill) in cat.items()}
        self.m = m_old + k
        if self.shard is not None:
            from annchor_tpu_torch.ops.sharded_fit import ShardedFit

            mesh, s = self.shard.mesh, self.shard.s
            self.shard = ShardedFit(mesh, self.m, -(-self.m // s) * s, nx, self.shard.nx_pad)
            self.m_pad = self.shard.m_pad
        for name, (t, fill) in cat.items():
            setattr(self, name, t if self.shard is None else self.shard.put_pairs(t, fill))
        self._tracked_keys = None
        if self.ij_host is not None:
            self.ij_host = np.concatenate(
                [self.ij_host, IJ_new.astype(self.ij_host.dtype)], axis=0
            )

        self.pool += int(ncm_new.sum())
        anchor_ids = m_old + np.flatnonzero(is_anchor).astype(np.int64)
        self._anchor_ids = np.concatenate([self._anchor_ids, anchor_ids])
        self._fill_anchor_exacts(anchor_ids)

        self.P_cnt = (
            np.asarray(self.P_cnt, dtype=np.int64)
            + np.bincount(IJ_new[:, 0], minlength=nx)
            + np.bincount(IJ_new[:, 1], minlength=nx)
        ).astype(np.int32)
        self._rebuild_pidx()

    def enemy_refine_ids(self, y_codes, k=50):
        """Pair ids of each point's k closest predicted enemies that are
        still uncomputed, deduplicated and sorted (host int64)."""
        self._flush_exacts()
        y = torch.as_tensor(np.asarray(y_codes, dtype=np.int64), device=self.device)
        run = enemy_refine_select if self.shard is None else self.shard.enemy_refine
        ids = run(self.RA, self.ncm, self.P_idx_d, self.ij_i, self.ij_j, y, k).reshape(-1)
        return torch.unique(ids[ids < self.m]).cpu().numpy()

    def enemy_knn_graph(self, y_codes, nn):
        """The nearest-enemy graph: exact distances from the float64
        exact store, predicted ones from the f32 estimates."""
        self._flush_exacts()
        nn = min(int(nn), self._pidx_width)
        y = torch.as_tensor(np.asarray(y_codes, dtype=np.int64), device=self.device)
        run = enemy_knn if self.shard is None else self.shard.enemy_knn
        pair_ids, partners, ra_sel = (
            t.cpu().numpy()
            for t in run(self.RA, self.ncm, self.P_idx_d, self.ij_i, self.ij_j, y, nn)
        )
        exact = self.exact.lookup(np.clip(pair_ids, 0, self.m - 1))
        is_exact = (pair_ids < self.m) & ~np.isnan(exact)
        return partners, np.where(is_exact, exact, ra_sel.astype(np.float64))

    def cover_incidence(self, slot, radii):
        """(nx, S) int64 0/1 incidence of the subset members strictly
        inside each point's enemy radius among its tracked partners
        (S = subset size): the selective-subset prune's working set."""
        self._flush_exacts()
        slot = np.asarray(slot, dtype=np.int64)
        S = int(slot.max()) + 1
        dev = self.device
        run = cover_incidence if self.shard is None else self.shard.cover_incidence
        inc = run(
            self.RA, self.ncm, self.ub, self.P_idx_d, self.ij_i, self.ij_j,
            torch.as_tensor(slot, device=dev),
            torch.as_tensor(np.asarray(radii, dtype=np.float32), device=dev), S,
        )
        return inc.cpu().numpy().astype(np.int64)

    # -- host materialisation ------------------------------------------------

    def ncm_to_host(self):
        """The host not-computed mask, downloaded from the device."""
        return self._host(self.ncm)

    def materialise(self):
        """Float64 host arrays (features, RA, ncm); exact values keep
        full precision from the exact store."""
        self._flush_exacts()
        af = np.zeros(self.m, dtype=np.float64)
        af[self._anchor_ids] = 1.0
        features = np.stack(
            [
                self._host(self.lb).astype(np.float64),
                self._host(self.ub).astype(np.float64),
                self._host(self.dad).astype(np.float64),
                af,
            ],
            axis=1,
        )
        RA = self._host(self.RA).astype(np.float64)
        RA[self.exact.ids] = self.exact.vals
        return features, RA, self.ncm_to_host()
