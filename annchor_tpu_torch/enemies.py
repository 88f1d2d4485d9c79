"""Nearest-enemy graph and selective-subset instance selection
(reference annchor/annchor.py:685-940).

Port of the JAX package's ``enemies.py``.  The enemy candidate counts
and the new pairs' features run on ``ann.device``; the exact distances
go through the fit's evaluator (the hand-written pair kernel for the
Levenshtein metric on a card).  A fit whose state is still on the device
(``ann._dev``) stays there: the new pairs are appended to it, and the
refine selection, the enemy graph and the cover incidence are row-block
passes over its incidence matrix, so the m-sized state never reaches the
host.  Otherwise the per-point passes are the JAX package's host numpy,
row-blocked over the padded incidence matrix, as are the greedy cover,
its prune and ``alpha_rss`` in both cases.
"""

from __future__ import annotations

import numpy as np

from annchor_tpu_torch.ops import pairs as pair_ops
from annchor_tpu_torch.ops.locality import effective_thresholds, enemy_candidate_pairs

# row block of the host incidence passes: bounds their (block, max_deg)
# float64 temporaries
_ROW_BLOCK = 2048


def _new_enemy_pairs(ann, y, loc_min):
    """Enemy candidate pairs not yet tracked: adaptive thresholds over
    the enemy columns, then the pairs those admit and the main filter
    does not.  A budgeted (device-built) pair list may have dropped
    admitted pairs, so there every enemy candidate is generated and the
    tracked ones removed explicitly."""
    nx = ann.nx
    S = ann._S_raw  # a tensor on the device after a fit, host after a load
    eff_e = effective_thresholds(
        S, ann.loc_thresh, loc_min, label_neq=y, device=ann.device
    )
    dev = ann._dev
    budgeted = dev.sparse if dev is not None else ann._ij_dev is not None
    loc_eff_excl = (
        np.full(nx, np.inf, dtype=np.float32) if budgeted else ann._loc_eff_raw
    )
    IJ_new = enemy_candidate_pairs(S, y, eff_e, loc_eff_excl, device=ann.device)
    if not budgeted or not IJ_new.shape[0]:
        return IJ_new
    if dev is not None:
        return IJ_new[~dev.tracked_mask(IJ_new)]
    old = ann.IJs
    keys_old = old[:, 0].astype(np.int64) * nx + old[:, 1]
    keys_new = IJ_new[:, 0].astype(np.int64) * nx + IJ_new[:, 1]
    return IJ_new[~np.isin(keys_new, keys_old)]


def get_nearest_enemies(ann, y, nn=3, loc_min=100):
    """The nn nearest differently-labelled points of each point, stored
    as ``ann.nearest_enemy_graph`` (reference annchor.py:685-787)."""
    nx = ann.nx
    y = np.asarray(y)
    assert len(y) == nx, "Label dimension mismatch: len(y)=%d, len(X)=%d" % (len(y), nx)
    labels, counts = np.unique(y, return_counts=True)
    assert len(labels) > 1, "Data must have more than one label"
    assert np.all(counts >= nn), (
        "At least one label occurs fewer times than specified nn=%d" % nn
    )

    IJ_new = _new_enemy_pairs(ann, y, loc_min)
    if ann._dev is not None:
        return _nearest_enemies_device(ann, y, nn, IJ_new)

    # features and clipped predictions of the new pairs, appended to the
    # host state (reference annchor.py:734-742)
    fnames, feats_new, ncm_new = ann.get_features_IJ(IJ_new)
    pred = ann.regression.predict(feats_new, fnames)
    pred = np.clip(pred, feats_new[:, 0], feats_new[:, 1])
    ann.IJs = np.concatenate([ann.IJs, IJ_new], axis=0)
    ann.features = np.concatenate([ann.features, feats_new], axis=0)
    ann.not_computed_mask = np.concatenate([ann.not_computed_mask, ncm_new])
    ann.RefineApprox = np.concatenate([ann.RefineApprox, pred])
    ann.P_idx, ann.P_cnt = pair_ops.build_point_index(ann.IJs, nx, ann.device)

    RA = ann.RefineApprox
    ncm = ann.not_computed_mask
    m = ann.IJs.shape[0]
    pair_sum = np.concatenate([ann.IJs.sum(axis=1), [0]]).astype(np.int64)

    def block(s, e):
        rows = ann.P_idx[s:e].astype(np.int64)  # (B, max_deg)
        valid = rows < m
        ids = np.where(valid, rows, 0)
        others = np.where(valid, pair_sum[ids] - np.arange(s, e)[:, None], 0)
        return valid, ids, others

    # refine: the 50 closest predicted enemies of each point
    # (reference annchor.py:753-769)
    refine_parts = []
    for s in range(0, nx, _ROW_BLOCK):
        e = min(s + _ROW_BLOCK, nx)
        valid, ids, others = block(s, e)
        emask = valid & (y[others] != y[s:e, None])
        dmat = np.where(emask, RA[ids], np.inf)
        order = np.argsort(dmat, axis=1, kind="stable")[:, : min(50, dmat.shape[1])]
        sel = np.take_along_axis(ids, order, axis=1)
        sel = sel[np.take_along_axis(emask, order, axis=1) & ncm[sel]]
        if sel.size:
            refine_parts.append(sel)
    if refine_parts:
        to_refine = np.concatenate(refine_parts)
        RA[to_refine] = ann._eval_pairs(ann.IJs[to_refine])
        ncm[to_refine] = False

    # the enemy graph: uncomputed and same-label partners carry a
    # +rowmax penalty (reference annchor.py:771-787)
    ngi = np.zeros((nx, nn), dtype=np.int64)
    ngd = np.zeros((nx, nn))
    for s in range(0, nx, _ROW_BLOCK):
        e = min(s + _ROW_BLOCK, nx)
        valid, ids, others = block(s, e)
        dmat = np.where(valid, RA[ids], np.inf)
        mx = np.max(np.where(valid, dmat, -np.inf), axis=1, keepdims=True)
        mx = np.where(np.isfinite(mx), mx, 0.0)
        pen = (
            dmat
            + mx * (valid & ncm[ids])
            + mx * (valid & (y[others] == y[s:e, None]))
        )
        order = np.argsort(pen, axis=1, kind="stable")[:, :nn]
        ngd[s:e] = np.take_along_axis(np.where(valid, RA[ids], np.inf), order, axis=1)
        ngi[s:e] = np.take_along_axis(others, order, axis=1)

    ann.nearest_enemy_graph = (ngi, ngd)
    return ann.nearest_enemy_graph


def _nearest_enemies_device(ann, y, nn, IJ_new):
    """The same steps on the live device state: append, refine selection
    and assembly as device passes; the host sees the new candidate list,
    the chosen refine ids and the (nx, nn) graph."""
    dev = ann._dev
    dev.append_pairs(IJ_new, ann.regression)
    _, codes = np.unique(y, return_inverse=True)
    ids = dev.enemy_refine_ids(codes, k=50)
    if ids.size:
        dev.apply_exact(ids, ann._eval_pairs(dev._pairs_at(ids)))
    ann.nearest_enemy_graph = dev.enemy_knn_graph(codes, nn)
    return ann.nearest_enemy_graph


def _enemy_dists(ann, y, dne):
    """First-column enemy distances, computing the enemy graph lazily."""
    if dne is not None:
        return np.asarray(dne)
    if not hasattr(ann, "nearest_enemy_graph"):
        get_nearest_enemies(ann, np.asarray(y))
    return ann.nearest_enemy_graph[1][:, 0]


def _guard_zero_enemies(dne):
    bad = np.flatnonzero(dne == 0)
    if bad.size:
        msg = (
            "Error: The following indices are distance zero from a point "
            + " with a different label:\n"
        )
        msg += "".join("\t %d\n" % i for i in bad)
        raise Exception(msg)


def _ranked_neighbour_table(ann):
    """All candidate partners of every point, self-prepended and sorted
    by current best distance (an uncomputed pair's upper bound), as two
    dense (nx, 1 + max_deg) arrays."""
    m = ann.IJs.shape[0]
    dists = np.where(
        ann.not_computed_mask,
        ann.features[:, ann.feature_names.index("upper bound")],
        ann.RefineApprox,
    )
    pad = ann.P_idx >= m
    ids = np.where(pad, 0, ann.P_idx).astype(np.int64)
    dmat = np.where(pad, np.inf, dists[ids])
    partners = np.where(pad, -1, ann.IJs[ids].sum(axis=2) - np.arange(ann.nx)[:, None])
    rank = np.argsort(dmat, axis=1, kind="stable")
    tab_d = np.concatenate(
        [np.zeros((ann.nx, 1)), np.take_along_axis(dmat, rank, 1)], axis=1
    )
    tab_j = np.concatenate(
        [np.arange(ann.nx)[:, None], np.take_along_axis(partners, rank, 1)], axis=1
    )
    return tab_j, tab_d


def _cover_depths(tab_d, radii):
    """How many leading table entries lie strictly inside each point's
    enemy radius (the rows of tab_d ascend)."""
    return (tab_d < (radii - 1e-6)[:, None]).sum(axis=1)


def _greedy_cover(tab_j, depth, nx):
    """Greedy hitting set: every point needs a chosen representative
    among the first depth[i] entries of its row.  Each round picks the
    candidate covering the most uncovered points (the lowest index on
    ties)."""
    width = tab_j.shape[1]
    live_entry = np.arange(width)[None, :] < depth[:, None]
    rows = np.nonzero(live_entry)[0]
    cands = tab_j[live_entry].astype(np.int64)

    chosen = np.flatnonzero(depth == 1)  # only they can represent themselves
    member = np.zeros(nx, dtype=bool)
    member[chosen] = True
    uncovered = np.bincount(rows, weights=member[cands], minlength=nx) == 0

    picks = list(chosen)
    while uncovered.any():
        open_entry = uncovered[rows]
        pick = int(np.bincount(cands[open_entry], minlength=nx).argmax())
        picks.append(pick)
        uncovered[rows[open_entry & (cands == pick)]] = False
    return np.asarray(picks, dtype=np.int64)


def _prune_cover(subset, tab_j, depth, nx):
    """Drop subset members, in order, whose removal leaves every point a
    remaining in-radius representative."""
    slot = np.full(nx, -1, dtype=np.int64)
    slot[subset] = np.arange(subset.shape[0])
    width = tab_j.shape[1]
    live_entry = np.arange(width)[None, :] < depth[:, None]
    rows = np.nonzero(live_entry)[0]
    hits = slot[tab_j[live_entry].astype(np.int64)]
    rows, hits = rows[hits >= 0], hits[hits >= 0]
    incidence = np.zeros((nx, subset.shape[0]), dtype=np.int64)
    incidence[rows, hits] = 1
    return _prune_cover_incidence(subset, incidence)


def _prune_cover_incidence(subset, incidence):
    """In-order redundancy prune over an (nx, |subset|) 0/1 cover
    incidence, with the support counts kept incrementally."""
    support = incidence.sum(axis=1)
    keep = np.ones(subset.shape[0], dtype=bool)
    for c in range(subset.shape[0]):
        residual = support - incidence[:, c]
        if residual.min() >= 1:
            support = residual
            keep[c] = False
    return subset[keep]


def annchor_selective_subset(ann, y, dne=None, alpha=0):
    """Selective subset for 1-NN classification: representatives such
    that every point has one closer than its nearest enemy.  A greedy
    cover over the k-NN graph, then an in-order redundancy prune over
    every tracked partner (reference annchor.py:789-915)."""
    y = np.asarray(y)
    dne = _enemy_dists(ann, y, dne)
    _guard_zero_enemies(dne)
    radii = dne / (1 + alpha)

    ngi, ngd = ann.neighbor_graph
    depth_knn = _cover_depths(np.asarray(ngd), radii)
    subset = _greedy_cover(np.asarray(ngi).astype(np.int64), depth_knn, ann.nx)

    if ann._dev is not None:
        # the prune's incidence from a device pass over the tracked
        # partners; every member covers itself (the host table's
        # self-prepended column)
        slot = np.full(ann.nx, -1, dtype=np.int64)
        slot[subset] = np.arange(subset.shape[0])
        incidence = ann._dev.cover_incidence(slot, radii)
        incidence[subset, np.arange(subset.shape[0])] = 1
        return _prune_cover_incidence(subset, incidence)

    tab_j, tab_d = _ranked_neighbour_table(ann)
    return _prune_cover(subset, tab_j, _cover_depths(tab_d, radii), ann.nx)


def alpha_rss(ann, y, dne=None, alpha=0, block=64):
    """Sequential alpha-RSS subset (reference annchor.py:917-940): visit
    the points by ascending enemy distance; a point joins unless a
    member already lies within its (alpha-shrunk) enemy radius.  The
    metric calls are batched: each block of candidates is evaluated
    against the members admitted before the block in one batch, and
    against the block's own admissions in small follow-up batches."""
    y = np.asarray(y)
    dne = _enemy_dists(ann, y, dne)
    radii = dne / (1 + alpha)

    visit = np.argsort(dne, kind="stable")
    members = [int(visit[0])]
    ann.rssDs = {}
    for s in range(0, len(visit), block):
        blk = visit[s : s + block]
        base = list(members)  # members admitted before this block
        pairs = np.stack(
            [np.repeat(blk, len(base)), np.tile(base, len(blk))], axis=1
        ).astype(np.int64)
        gaps_blk = np.asarray(ann.get_exact_ijs(ann.f, ann.X, pairs)).reshape(
            len(blk), len(base)
        )
        for t, cand in enumerate(blk):
            gaps = gaps_blk[t]
            fresh = members[len(base) :]  # admitted within this block
            if fresh:
                extra = np.column_stack([np.full(len(fresh), cand), fresh]).astype(np.int64)
                gaps = np.concatenate(
                    [gaps, np.asarray(ann.get_exact_ijs(ann.f, ann.X, extra))]
                )
            ann.rssDs[int(cand)] = gaps
            nearest = gaps.min()
            if nearest > radii[cand] or np.isclose(nearest, radii[cand]):
                members.append(int(cand))
    return np.asarray(members)
