"""Out-of-sample query (reference annchor/query_functions.py:10-338).

Port of the JAX package's ``query.py``.  A query re-uses the fitted
regression and error model (no retraining) with the asymmetric
query-side bounds

    lb = max_a |D[i,a] - QD[j,a]|     ub = min_a (D[i,a] + QD[j,a]).

Each candidate pair is (database index, query index), indexed by its
query in the padded incidence layout of the fit path.  The per-pair
passes run on ``ann.device`` through the port's helpers (candidate
counts, features, incidence, thresholds, probabilities, graph
assembly), and so does the budget walk, whose stable device sorts give
the JAX package's lexsort orders; the legacy profile match stays host
numpy, as in the JAX package, so its tie orders are its own.  Every
metric call goes through ``ann._get_exact_query_ijs_for(ann.f)``: for
the Levenshtein metric on a card, the hand-written pair kernel on the
joint encoding of the database and the queries, which one call of
``query_`` or ``legacy_query_`` encodes once (``_held_encoding``).

Against a scout/certify hybrid index, ``query_`` explores through the
metric's scout (the anchor columns included, to stay consistent with the
fitted features) and certifies its reported rows with the exact metric,
over-selecting by ``ann.certify_pad``, as the JAX package does.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from annchor_tpu_torch import trace
from annchor_tpu_torch.ops import pairs as pair_ops
from annchor_tpu_torch.ops.features import bounds_and_dad_tensors
from annchor_tpu_torch.ops.locality import query_candidates


def _anchor_objects(X, A):
    try:
        return np.asarray(X)[np.asarray(A, dtype=int)]
    except Exception:
        return [X[int(a)] for a in A]


def _held_encoding(ann):
    """Keep the metric engine's joint (database + queries) encoding for
    the duration of one query call, where the engine offers it; results
    are the same with or without the hold."""
    hold = getattr(ann.metric.batch, "hold_pair_encoding", None)
    return hold() if hold is not None else contextlib.nullcontext()


def get_query_anchor_dists(ann, Q, geq):
    """nq x na exact anchor distances for the queries
    (reference query_functions.py:10-15)."""
    nq = len(Q)
    na = ann.n_anchors
    XA = _anchor_objects(ann.X, ann.A)
    IJ = np.stack(
        [
            np.tile(np.arange(na, dtype=np.int64), nq),
            np.repeat(np.arange(nq, dtype=np.int64), na),
        ],
        axis=1,
    )
    D = np.asarray(geq(ann.f, XA, Q, IJ), dtype=np.float64)
    return D.reshape(nq, na)


def get_query_features(ann, Q, QD, check):
    """Pairs, padded index and features for the query candidates
    (reference query_functions.py:40-129).  ``check`` is the flat
    (db_ids, q_ids) candidate layout of ``query_candidates``.  The
    features stay on ``ann.device``: Qfeatures a float64 tensor of rows
    (lb, ub, dad, is anchor), the float32 feature pass upcast exactly,
    and Qncm a bool tensor (the pairs that are not anchor columns)."""
    nq = len(Q)
    dev = ann.device
    db_ids, q_ids = check
    IJs = np.stack([db_ids, q_ids], axis=1)
    P_idx, P_cnt = pair_ops.build_point_index_single(IJs[:, 1], nq, dev)
    IJ = torch.as_tensor(IJs, device=dev)
    lb, ub, dad = bounds_and_dad_tensors(ann.D, IJ[:, 0], IJ[:, 1], DJ=QD, device=dev)
    is_anchor = torch.zeros(ann.nx, dtype=torch.float64, device=dev)
    if len(ann.A):
        is_anchor[torch.as_tensor(np.asarray(ann.A, dtype=np.int64), device=dev)] = 1.0
    anchors = is_anchor[IJ[:, 0]]
    Qfeatures = torch.stack([lb.to(torch.float64), ub.to(torch.float64),
                             dad.to(torch.float64), anchors], dim=1)
    Qncm = anchors < 1
    return IJs, P_idx, P_cnt, Qfeatures, Qncm


def _tensor_predict(strategy):
    """The strategy's ``predict_tensor``, where the class that gives it
    its ``predict`` gives that too: a subclass that overrides ``predict``
    alone keeps its host call.  None otherwise."""
    for klass in type(strategy).__mro__:
        if "predict" in vars(klass):
            return strategy.predict_tensor if "predict_tensor" in vars(klass) else None
    return None


def predict_query_pairs(ann, Qfeatures):
    """The fitted regression of the candidate features, clipped to their
    bounds in metric spaces, and the error model's bin tags.  Where both
    strategies offer a tensor predict, float64 and int64 tensors on the
    features' device, bit for bit the numpy path; else their numpy
    ``predict`` on the features brought down.  Returns (Qpred, Qerrors,
    on_card)."""
    reg = _tensor_predict(ann.regression)
    err = _tensor_predict(ann.error_predictor)
    on_card = reg is not None and err is not None
    if on_card:
        F, clip = Qfeatures, torch.clamp
    else:
        F, clip = Qfeatures.cpu().numpy(), np.clip
        reg, err = ann.regression.predict, ann.error_predictor.predict
    names = ann.feature_names
    Qpred = reg(F, names)
    if ann.is_metric:
        Qpred = clip(Qpred, F[:, names.index("lower bound")], F[:, names.index("upper bound")])
    return Qpred, err(F, names), on_card


def _on(a, dev, dtype=None):
    """A numpy array or a tensor as a tensor on ``dev`` (of ``dtype``,
    where one is given)."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return a.to(device=dev, dtype=dtype)


class _Host:
    """The walk's reads from the device.  ``numpy`` fetches tensors in
    one download; ``reads`` counts the downloads (the ``syncs`` count
    of the ``query.walk`` span)."""

    def __init__(self):
        self.reads = 0

    def numpy(self, *tensors):
        """int64, bool and float64 tensors as numpy arrays, carried down
        together as int64 words (a float64 by its bits)."""
        self.reads += 1
        words = [t.view(torch.int64) if t.dtype == torch.float64 else t.to(torch.int64)
                 for t in tensors]
        flat = torch.cat([w.reshape(-1) for w in words]).cpu().numpy()
        out, at = [], 0
        for t in tensors:
            a = flat[at:at + t.numel()].reshape(tuple(t.shape))
            at += t.numel()
            if t.dtype == torch.float64:
                a = a.view(np.float64)
            elif t.dtype == torch.bool:
                a = a.astype(bool)
            out.append(a)
        return out


def _kth_evaluated(aq, ad, nq: int, nn: int):
    """Per query, its nn-th smallest evaluated distance (+inf while it
    has fewer than nn evaluations), with (order, rank): order sorts the
    evaluated pairs by (query, distance) and rank is each sorted entry's
    position within its query, so entries with rank < nn are the query's
    nn best evaluated pairs."""
    dev = aq.device
    o = pair_ops.lexsort_stable((ad, aq))
    eq_s = aq[o]
    bounds = torch.searchsorted(eq_s, torch.arange(nq + 1, device=dev))
    starts, cnt = bounds[:-1], bounds[1:] - bounds[:-1]
    rank = torch.arange(eq_s.shape[0], device=dev) - starts[eq_s]
    ad_s = torch.cat([ad[o], ad.new_full((1,), np.inf)])
    kth_at = ad_s[(starts + nn - 1).clamp(max=eq_s.shape[0])]
    kth = torch.where(cnt >= nn, kth_at, np.inf)
    return o, rank, kth


def select_refine_candidate_query_pairs(
    ann, IJs, Q, P_idx, P_cnt, QRA, Qncm, Qerrors, p_work, nn, geq,
    seed_frac: float = 0.5, expand_rounds: int = 3, span=None,
):
    """Graph-guided refinement with the query work budget: (1) seed with
    the error-model ranking on ``seed_frac`` of the budget (the
    reference's rule, query_functions.py:132-180), (2) walk the fitted
    graph from each query's current best evaluated points, screened by
    the triangle lower bound and spent in per-query fair shares ordered
    by the triangle upper bound, (3) spend the rest on the remaining
    candidates ranked by the error model against the now-exact per-query
    thresholds.

    The walk's state lives on ``ann.device``: its inputs go up once, and
    every sort, set and select step runs there, each ``np.lexsort`` of
    the JAX package as ``pair_ops.lexsort_stable`` with the same order.
    Each metric call downloads its pairs (numpy, in the JAX package's
    order) and uploads its distances; the result comes down in one
    download at the end.  ``span`` (a ``trace.span``) gets the counts
    ``rounds`` (expansion rounds that asked the metric) and ``syncs``
    (the walk's downloads).

    QRA, Qncm and Qerrors may be numpy arrays or tensors on
    ``ann.device`` (the query path's tensor predict); IJs and P_idx are
    numpy.  Returns (IJ_all, RA_all, ncm_all) as numpy: the candidate
    pairs plus the graph-walk pairs outside the locality candidate set."""
    nq = len(Q)
    nx = ann.nx
    dev = ann.device
    nbf = nq * nx
    na = ann.n_anchors * nq
    budget = max(0, int(p_work * nbf - na) + 1)
    host = _Host()
    errs = ann.error_predictor.errs

    def evaluate(IJ):
        """The metric on the (db, query) pairs IJ (one download, one
        upload): float64 distances on the device."""
        (IJ_np,) = host.numpy(IJ)
        d = np.asarray(geq(ann.f, ann.X, Q, IJ_np), dtype=np.float64)
        return torch.as_tensor(d, device=dev)

    def nonzero(mask):
        # one wait for the count, then an index every array can share
        return torch.nonzero(mask).squeeze(1)

    IJ = torch.as_tensor(np.asarray(IJs, dtype=np.int64).reshape(-1, 2), device=dev)
    P = torch.as_tensor(np.asarray(P_idx), device=dev).to(torch.int64)
    RA0 = _on(QRA, dev, torch.float64)
    ncm = _on(Qncm, dev, torch.bool).clone()  # the walk marks it
    Qerr = _on(Qerrors, dev)

    keys_c = IJ[:, 1] * nx + IJ[:, 0]
    keys_sorted, korder = torch.sort(keys_c, stable=True)
    # one slot past the end, which no key (>= 0) matches
    keys_pad = torch.cat([keys_sorted, keys_sorted.new_full((1,), -1)])
    korder_pad = torch.cat([korder, korder.new_full((1,), -1)])

    def cand_lookup(keys):
        """Candidate row ids of pair keys (-1 when absent)."""
        pos = torch.searchsorted(keys_sorted, keys)
        return torch.where(keys_pad[pos] == keys, korder_pad[pos], -1)

    # ---- seed: the error-model ranking ------------------------------
    thresh = pair_ops.kth_smallest_per_point_dev(RA0, P, nn)
    QRA = pair_ops.guarantee_nmin_dev(RA0, ncm, P, 3 * nn // 2)
    rows = nonzero(ncm)
    p = thresh[IJ[rows, 1]] - QRA[rows]
    prob = pair_ops.empirical_cdf_probs_dev(p, Qerr[rows], errs)
    n_seed = min(int(budget * seed_frac), rows.shape[0])
    # the empirical CDF saturates at 0 and 1: the raw margin breaks
    # those ties deterministically
    mapback = rows[pair_ops.lexsort_stable((-p, -prob))[:n_seed]]
    exact = evaluate(IJ[mapback])
    QRA[mapback] = exact
    ncm[mapback] = False
    spent = n_seed

    eq = [IJ[mapback, 1]]
    edb = [IJ[mapback, 0]]
    ed = [exact]
    visited = torch.sort(keys_c[mapback]).values

    # ---- expansion: walk the fitted k-NN graph ----------------------
    # Each round proposes (q, l) for every graph neighbour l of the
    # query's current best evaluated points j, drops those whose
    # triangle lower bound |d(q,j) - d(j,l)| cannot beat the query's kth
    # evaluated distance, and spends the round's share in per-query fair
    # slots ordered by the upper bound d(q,j) + d(j,l).  The walk graph
    # is symmetrised: each point's in-neighbours (up to one row width,
    # nearest first) are appended to its row, so the walk crosses edges
    # in both directions.
    G = torch.as_tensor(np.asarray(ann.neighbor_graph[0]), device=dev).to(torch.int64)
    GD = torch.as_tensor(np.asarray(ann.neighbor_graph[1]), device=dev).to(torch.float64)
    ng, deg0 = G.shape
    src_e = torch.arange(ng, device=dev)[:, None].expand(ng, deg0).reshape(-1)
    dst_e = G.reshape(-1)
    d_e = GD.reshape(-1)
    oke = nonzero((dst_e >= 0) & (dst_e != src_e) & torch.isfinite(d_e))
    src_e, dst_e, d_e = src_e[oke], dst_e[oke], d_e[oke]
    order_e = pair_ops.lexsort_stable((d_e, dst_e))
    src_s, dst_s, d_s = src_e[order_e], dst_e[order_e], d_e[order_e]
    starts_e = torch.searchsorted(dst_s, torch.arange(ng, device=dev))
    rank_e = torch.arange(dst_s.shape[0], device=dev) - starts_e[dst_s]
    keep_e = nonzero(rank_e < deg0)
    Grev = torch.full((ng, deg0), -1, dtype=torch.int64, device=dev)
    GrevD = torch.full((ng, deg0), np.inf, dtype=torch.float64, device=dev)
    Grev[dst_s[keep_e], rank_e[keep_e]] = src_s[keep_e]
    GrevD[dst_s[keep_e], rank_e[keep_e]] = d_s[keep_e]
    G = torch.cat([G, Grev], dim=1)
    GD = torch.cat([GD, GrevD], dim=1)
    deg = G.shape[1]
    rounds = 0
    for r in range(expand_rounds):
        left = budget - spent
        if left <= 0:
            break
        share = left if r == expand_rounds - 1 else max(1, left // (expand_rounds - r))
        aq = torch.cat(eq)
        adb = torch.cat(edb)
        ad = torch.cat(ed)
        o, rank, kth = _kth_evaluated(aq, ad, nq, nn)
        head = o[rank < nn]
        src_q = aq[head]
        src_db = adb[head]
        src_d = ad[head]
        cand_q = src_q[:, None].expand(-1, deg).reshape(-1)
        cand_db = G[src_db].reshape(-1)
        d_jl = GD[src_db].reshape(-1)
        d_qj = src_d[:, None].expand(-1, deg).reshape(-1)
        ok = (cand_db >= 0) & torch.isfinite(d_jl)
        lb = torch.abs(d_qj - d_jl)
        ub = d_qj + d_jl
        adm = nonzero(ok & (lb < kth[cand_q]))
        keys = cand_q[adm] * nx + cand_db[adm]
        ubk = ub[adm]
        # best-ub-wins dedupe, then drop already-evaluated pairs
        ordk = pair_ops.lexsort_stable((ubk, keys))
        keys, ubk = keys[ordk], ubk[ordk]
        fresh = torch.ones_like(keys, dtype=torch.bool)
        fresh[1:] = keys[1:] != keys[:-1]
        if visited.numel():
            pos = torch.searchsorted(visited, keys).clamp_(0, visited.shape[0] - 1)
            fresh &= visited[pos] != keys
        fresh = nonzero(fresh)
        keys, ubk = keys[fresh], ubk[fresh]
        if keys.numel() == 0:
            break
        if keys.numel() > share:
            # per-query fair share: priority (rank within the query's
            # ub-ordered slate, then ub)
            qb = keys // nx
            oq = pair_ops.lexsort_stable((ubk, qb))
            qb_s = qb[oq]
            qstarts = torch.searchsorted(qb_s, torch.arange(nq, device=dev))
            wrank = torch.arange(qb_s.shape[0], device=dev) - qstarts[qb_s]
            pick = oq[pair_ops.lexsort_stable((ubk[oq], wrank))[:share]]
            keys = keys[pick]
        new = torch.sort(keys).values
        cq = new // nx
        cdb = new % nx
        d = evaluate(torch.stack([cdb, cq], dim=1))
        rounds += 1
        eq.append(cq)
        edb.append(cdb)
        ed.append(d)
        visited = torch.sort(torch.cat([visited, new])).values
        spent += new.shape[0]
        # walk pairs already in the candidate set become computed
        crow = cand_lookup(new)
        hit = nonzero(crow >= 0)
        QRA[crow[hit]] = d[hit]
        ncm[crow[hit]] = False

    # ---- fill: the leftover budget back on the error model ----------
    left = budget - spent
    rem = nonzero(ncm)
    if left > 0 and rem.numel():
        _, _, kth = _kth_evaluated(torch.cat(eq), torch.cat(ed), nq, nn)
        pm = kth[IJ[rem, 1]] - QRA[rem]
        pr = pair_ops.empirical_cdf_probs_dev(pm, Qerr[rem], errs)
        sel = rem[pair_ops.lexsort_stable((-pm, -pr))[:left]]
        d = evaluate(IJ[sel])
        QRA[sel] = d
        ncm[sel] = False
        eq.append(IJ[sel, 1])
        edb.append(IJ[sel, 0])
        ed.append(d)

    # ---- union: candidates + walk pairs outside the filter ----------
    aq = torch.cat(eq)
    adb = torch.cat(edb)
    ad = torch.cat(ed)
    akeys = aq * nx + adb
    extra = nonzero(cand_lookup(akeys) < 0)
    # the extras once each, in key order (np.unique's first occurrences)
    ek = torch.sort(akeys[extra], stable=True)
    first = torch.ones_like(ek.values, dtype=torch.bool)
    first[1:] = ek.values[1:] != ek.values[:-1]
    ex = extra[ek.indices[first]]
    RA, ncm_h, ex_db, ex_q, ex_d = host.numpy(QRA, ncm, adb[ex], aq[ex], ad[ex])
    if span is not None:
        span.count(rounds=rounds, syncs=host.reads)
    IJ_all = np.concatenate([IJs, np.stack([ex_db, ex_q], axis=1)], axis=0)
    RA_all = np.concatenate([RA, ex_d])
    ncm_all = np.concatenate([ncm_h, np.zeros(ex_q.shape[0], dtype=bool)])
    return IJ_all, RA_all, ncm_all


def query_dm(Q, P, DP, f, geq, k=0, alpha=1.2, init=0):
    """Landmark-descent query against an anchor set (the reference's
    legacy path, query_functions.py:262-338, as a masked batched
    descent: one metric batch per step).

    Each query walks the anchor graph: evaluate the current anchor,
    extend the query's anchor profile lM[a] = sqrt(sum_t (d_t -
    DP[a_t, a])^2) over the visited anchors a_t, and descend to the
    profile-minimising anchor until it revisits one.  Then every anchor
    whose profile norm is under ``alpha`` times the (k+1)-smallest is
    evaluated exactly.

    Q: queries; P: anchor objects; DP: (na, na) anchor distances; geq:
    evaluator geq(f, Q, P, IJ) over (query, anchor) pairs.  Returns
    (As, Ds, lMs, nevals): per query the anchor ids and exact distances
    in ascending order, the final profile norms, and the metric calls."""
    nq, mp = len(Q), len(P)
    DP = np.asarray(DP, dtype=np.float64)

    visited = [[] for _ in range(nq)]
    dvis = [[] for _ in range(nq)]
    sq = np.zeros((nq, mp))  # running sum of squared profile deviations
    cur = np.full(nq, int(init))
    active = np.ones(nq, dtype=bool)
    nevals = 0

    for _ in range(mp):
        ids = np.nonzero(active)[0]
        if ids.size == 0:
            break
        IJ = np.stack([ids, cur[ids]], axis=1)
        d = np.asarray(geq(f, Q, P, IJ), dtype=np.float64)
        nevals += ids.size
        for i, di in zip(ids, d):
            visited[i].append(int(cur[i]))
            dvis[i].append(float(di))
        sq[ids] += (d[:, None] - DP[cur[ids], :]) ** 2
        nxt = np.argmin(np.sqrt(sq[ids]), axis=1)
        for row, i in enumerate(ids):
            if int(nxt[row]) in visited[i]:
                active[i] = False
            else:
                cur[i] = int(nxt[row])

    lMs = {i: np.sqrt(sq[i]) for i in range(nq)}

    # expansion: every anchor within alpha of the (k+1)-smallest profile
    todo_per_q = []
    for i in range(nq):
        lm = lMs[i]
        radius = np.sort(lm)[min(k, mp - 1)] * alpha
        cand = np.nonzero(lm < radius)[0]
        todo_per_q.append(cand[~np.isin(cand, visited[i], assume_unique=True)])
    flat = np.array(
        [[i, j] for i in range(nq) for j in todo_per_q[i]], dtype=np.int64
    ).reshape(-1, 2)
    if flat.shape[0]:
        dflat = np.asarray(geq(f, Q, P, flat), dtype=np.float64)
        nevals += flat.shape[0]
    else:
        dflat = np.zeros(0)
    offs = np.cumsum([0] + [len(t) for t in todo_per_q])

    As, Ds = {}, {}
    for i in range(nq):
        a = np.concatenate([visited[i], todo_per_q[i]]).astype(int)
        d = np.concatenate([dvis[i], dflat[offs[i] : offs[i + 1]]])
        order = np.argsort(d, kind="stable")
        As[i], Ds[i] = a[order], d[order]
    return As, Ds, lMs, nevals


def legacy_query_(ann, Z, get_exact_query_ijs=None, k=5, alpha=1.4, beta=1.4):
    """Legacy anchor-profile query (reference query_functions.py:218-259):
    rank the database points by how well their anchor-distance profile
    matches the query's measured anchor distances, then evaluate the
    beta-expanded head exactly.  The profile match is the JAX package's
    float64 numpy code, so its stable sort sees the same bits.

    Returns (indices (nz, k), distances (nz, k))."""
    if get_exact_query_ijs is not None:
        ann.get_exact_query_ijs = get_exact_query_ijs
    geq = ann._get_exact_query_ijs_for(ann.f)
    with _held_encoding(ann):
        return _legacy_query(ann, Z, geq, k, alpha, beta)


def _legacy_query(ann, Z, geq, k, alpha, beta):
    XA = _anchor_objects(ann.X, ann.A)
    DP = ann.D[np.asarray(ann.A, dtype=int)]  # (na, na)
    As, Ds, _, _ = query_dm(Z, XA, DP, ann.f, geq, k=k, alpha=alpha, init=0)

    nz = len(Z)
    nx = ann.nx

    # pad the ragged per-query profiles (visited anchors + distances)
    # to a rectangle so the profile match vectorises across queries
    lens = np.array([len(As[i]) for i in range(nz)], dtype=np.int64)
    L = int(lens.max())
    rows = np.repeat(np.arange(nz, dtype=np.int64), lens)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    pos = np.arange(rows.shape[0]) - starts[rows]
    A_pad = np.zeros((nz, L), dtype=np.int64)
    D_pad = np.zeros((nz, L))
    A_pad[rows, pos] = np.concatenate([As[i] for i in range(nz)])
    D_pad[rows, pos] = np.concatenate([Ds[i] for i in range(nz)])
    pmask = np.arange(L)[None, :] < lens[:, None]

    # chunked profile match: one (nx, chunk, L) gather per chunk keeps
    # the temporary near 128 MB however many queries arrive
    qblk = max(1, (1 << 24) // max(nx * L, 1))
    head_q_parts, head_db_parts = [], []
    for s in range(0, nz, qblk):
        e = min(s + qblk, nz)
        cols = ann.D[:, A_pad[s:e].reshape(-1)].reshape(nx, e - s, L)
        diff = (cols - D_pad[None, s:e]) * pmask[None, s:e]
        DD = np.sqrt(np.einsum("xql,xql->xq", diff, diff))
        isort = np.argsort(DD, axis=0, kind="stable")  # (nx, q)
        dds = np.take_along_axis(DD, isort, axis=0)
        # beta-expanded head: every database point within ratio beta of
        # the (k+1)-smallest profile distance
        selq = dds < beta * dds[k][None, :]
        # degenerate profiles: >= k+1 points match the query's profile
        # exactly (dds[k] == 0) and the ratio cut selects nothing; keep
        # the zero-distance matches (a prefix of the sort) instead
        zerok = dds[k] == 0
        if zerok.any():
            selq |= (dds == 0) & zerok[None, :]
        cut = selq.sum(axis=0)
        qq, rank = np.nonzero(np.arange(nx)[None, :] < cut[:, None])
        head_db_parts.append(isort[rank, qq].astype(np.int64))
        head_q_parts.append((qq + s).astype(np.int64))
    head_q = np.concatenate(head_q_parts)
    head_db = np.concatenate(head_db_parts)

    # one exact batch for every query's head
    IJ = np.stack([head_db, head_q], axis=1)
    nd = np.asarray(geq(ann.f, ann.X, Z, IJ), dtype=np.float64)

    # per-query top-k of the evaluated heads
    order = np.lexsort((nd, head_q))
    hq_s = head_q[order]
    qstarts = np.searchsorted(hq_s, np.arange(nz))
    rank = np.arange(hq_s.shape[0]) - qstarts[hq_s]
    sel = rank < k
    out_i = np.zeros((nz, k), dtype=np.int64)
    out_d = np.zeros((nz, k))
    out_i[hq_s[sel], rank[sel]] = head_db[order][sel]
    out_d[hq_s[sel], rank[sel]] = nd[order][sel]
    return out_i, out_d


def query_(ann, Q, nn=15, p_work=0.3, get_exact_query_ijs=None,
           loc_thresh=None, locality=None, seed_frac=0.5, expand_rounds=3):
    """Full query pipeline (reference query_functions.py:183-212).

    Returns (ngi, ngd): the nn + 1 nearest database indices and
    distances per query row.  ``loc_thresh``/``locality`` override the
    fitted filter knobs for the query-side candidates only (the eval
    budget stays p_work)."""
    with trace.span("query", queries=len(Q)):
        if get_exact_query_ijs is not None:
            ann.get_exact_query_ijs = get_exact_query_ijs
        geq = ann._get_exact_query_ijs_for(ann.f)

        # scout/certify hybrid: exploration through the scout, exact
        # certification of the reported rows
        scouting = getattr(ann, "_scouting", False) and get_exact_query_ijs is None
        if scouting:
            scout_eng = ann.metric.scout

            def eval_geq(f, Xa, Z, IJ):
                return scout_eng(Xa, Z, np.asarray(IJ))

        else:
            eval_geq = geq
        asked = 0  # pairs the walk asks of the evaluator

        def walk_geq(f, Xa, Z, IJ):
            nonlocal asked
            asked += len(IJ)
            return eval_geq(f, Xa, Z, IJ)

        with _held_encoding(ann):
            # the anchor columns use the fit's engine: the fitted D and
            # regression carry the scout's bias, and consistent features beat
            # exact but inconsistent ones
            with trace.span("query.anchors"):
                QD = get_query_anchor_dists(ann, Q, eval_geq)
            with trace.span("query.candidates"):
                check = query_candidates(
                    ann._S_raw, QD,
                    ann.locality if locality is None else locality,
                    ann.loc_thresh if loc_thresh is None else loc_thresh,
                    device=ann.device,
                )
            with trace.span("query.features"):
                IJs, P_idx, P_cnt, Qfeatures, Qncm = get_query_features(ann, Q, QD, check)

            with trace.device_span("query.predict", (ann.device,)) as predict:
                Qpred, Qerrors, on_card = predict_query_pairs(ann, Qfeatures)
                predict.count(on_card=int(on_card))

            with trace.span("query.walk") as walk:
                IJ_all, RA_all, ncm_all = select_refine_candidate_query_pairs(
                    ann, IJs, Q, P_idx, P_cnt, Qpred, Qncm, Qerrors, p_work, nn,
                    walk_geq, seed_frac=seed_frac, expand_rounds=expand_rounds, span=walk,
                )
                walk.count(pairs=asked)
        with trace.span("query.graph"):
            if IJ_all.shape[0] != IJs.shape[0]:
                # the graph walk found pairs outside the locality candidates
                P_idx, _ = pair_ops.build_point_index_single(IJ_all[:, 1], len(Q), ann.device)

            # reference quirk: the query graph carries nn + 1 columns
            # (reference query_functions.py:210 calls get_nn with nn + 1)
            nout = nn + 1
            nsel = nout + (ann.certify_pad if scouting else 0)
            ngi, ngd, _ = pair_ops.knn_from_pairs(RA_all, IJ_all, P_idx, ncm_all, nsel,
                                                  ann.device)
        if not scouting:
            return ngi, ngd
        with trace.span("query.certify") as certify:
            nq = len(Q)
            rows = np.repeat(np.arange(nq, dtype=np.int64), nsel)
            dbs = ngi.reshape(-1)
            valid = dbs >= 0
            IJq = np.stack([dbs[valid], rows[valid]], axis=1)
            certify.count(pairs=IJq.shape[0])
            dists = np.full(nq * nsel, np.inf)
            dists[valid] = np.asarray(geq(ann.f, ann.X, Q, IJq), dtype=np.float64)
            dists = dists.reshape(nq, nsel)
            order = np.argsort(dists, axis=1, kind="stable")[:, :nout]
            return np.take_along_axis(ngi, order, axis=1), np.take_along_axis(dists, order, axis=1)
