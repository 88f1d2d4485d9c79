"""Device-resident fit pipeline, dense single-device mode.

Port of the JAX package's ``ops/device_pipeline.py`` for nx <= 4096.
The whole per-pair state of a fit lives on one device as

    lb, ub, dad, RA : (m,) f32      ij_i, ij_j : (m,) i32
    ncm             : (m,) bool     P_idx      : (nx, max_deg) i32

and the orchestrator (``annchor.Annchor``) only moves the sample rows,
the regression coefficients and the chosen pair ids across the host
link.  The stage programs are plain functions on tensors, so a test can
start any of them from the JAX package's own state (``convert.py``).

Parity with the JAX programs:

* every top-k of the reference (``lax.top_k`` breaks ties by the lower
  index) is a stable sort here, ascending or descending, then a slice;
* every argsort is stable, as ``jnp.argsort`` is;
* the sample draw takes its uniforms from the caller (see
  ``default_uniforms``), so a test can hand it JAX's stream.

The edit distances themselves come from the caller's ``batch_dev``
(the metric engine), which on a CUDA device is the hand-written pair
kernel.
"""

from __future__ import annotations

import numpy as np
import torch

F32_INF = float("inf")


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
    """LB/UB/dad for every pair, in chunks of ``chunk`` pairs so the
    (chunk, na) gathers stay bounded.

    lb = max_a |D[i,a] - D[j,a]|, ub = min_a D[i,a] + D[j,a], and the
    double anchor distance dad = (D[i, c(j)] + D[j, c(i)]) / 2 with c(p)
    the nearest anchor of p (first index on ties, as ``jnp.argmin``)."""
    m = ij_i.shape[0]
    cA = torch.argmin(D32, dim=1)
    lb = torch.empty(m, dtype=torch.float32, device=D32.device)
    ub = torch.empty_like(lb)
    dad = torch.empty_like(lb)
    for s in range(0, m, chunk):
        gi = ij_i[s : s + chunk].long()
        gj = ij_j[s : s + chunk].long()
        Di = D32[gi]
        Dj = D32[gj]
        lb[s : s + chunk] = (Di - Dj).abs().amax(dim=1)
        ub[s : s + chunk] = (Di + Dj).amin(dim=1)
        dad[s : s + chunk] = (D32[gi, cA[gj]] + D32[gj, cA[gi]]) * 0.5
    return lb, ub, dad


def regress_update(lb, ub, dad, RA, ncm, inner_edges, coefs, icepts,
                   sample_ids, sample_y, is_metric: bool, init: bool):
    """Predict every pair from the per-bin linear model, clip to the
    bounds (metric spaces), land the sample exacts.  Returns (RA', ncm').

    Bins are (lo, hi] (``searchsorted`` left on the interior edges).
    The prediction is lb*c0 + ub*c1 + dad*c2 + ic, rounded after every
    operation; XLA may contract it into fused multiply-adds, so RA can
    differ from the JAX program's in the last few ulps."""
    labels = torch.searchsorted(inner_edges, dad, right=False)
    c = coefs[labels]
    pred = lb * c[:, 0] + ub * c[:, 1] + dad * c[:, 2] + icepts[labels]
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


def pidx_from_pairs(ij_i, ij_j, nx: int, max_deg: int):
    """Padded (nx, max_deg) incidence matrix by a counting sort over the
    endpoint list (pad = m).  Row p lists p's pairs in the order of the
    stable sort: first those with p = ij_i, then those with p = ij_j,
    each in pair-id order."""
    dev = ij_i.device
    m = ij_i.shape[0]
    endpoints = torch.cat([ij_i, ij_j]).long()
    pair_ids = torch.arange(m, dtype=torch.int32, device=dev).repeat(2)
    order = torch.argsort(endpoints, stable=True)
    se = endpoints[order]
    counts = torch.bincount(endpoints, minlength=nx)
    starts = torch.cumsum(counts, 0) - counts
    cols = torch.arange(2 * m, device=dev) - starts[se]
    P = torch.full((nx, max_deg), m, dtype=torch.int32, device=dev)
    P[se, cols] = pair_ids[order]
    return P


def _row_block(nx: int, max_deg: int, budget: int = 1 << 27) -> int:
    """Row-block size keeping the (block, max_deg) f32 temporaries of
    the per-point passes under ~budget bytes."""
    return int(min(nx, max(256, budget // (4 * max(max_deg, 1)))))


def _row_blocks(nx: int, blk: int):
    """Block starts; the tail block is clamped to end at nx and may
    overlap its predecessor (rewriting identical values)."""
    return [min(t * blk, nx - blk) for t in range((nx + blk - 1) // blk)]


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
    dev = RA.device
    m = RA.shape[0]
    nx, max_deg = P_idx.shape
    inf = torch.tensor([F32_INF], dtype=torch.float32, device=dev)
    RA_pad = torch.cat([RA, inf])
    ncm_ext = torch.cat([ncm, torch.zeros(1, dtype=torch.bool, device=dev)])
    kk = min(nn, max_deg - 1)
    blk = _row_block(nx, max_deg)

    thresh = torch.zeros(nx, dtype=torch.float32, device=dev)
    marks = torch.zeros(m + 1, dtype=torch.bool, device=dev)
    for start in _row_blocks(nx, blk):
        rows = P_idx[start : start + blk].long()
        vals = RA_pad[rows]
        thresh[start : start + blk] = torch.sort(vals, dim=1).values[:, kk]
        if guarantee:
            ncm_rows = ncm_ext[rows]
            todo_vals = torch.where(ncm_rows, vals, inf)
            n_computed = ((~ncm_rows) & (rows < m)).sum(dim=1)
            n_todo = torch.clamp(nmin - n_computed, 0, max_deg - 1)
            svals = torch.sort(todo_vals, dim=1).values
            kth = torch.gather(svals, 1, n_todo[:, None])
            mark_rows = (todo_vals < kth) & ncm_rows & (n_todo[:, None] > 0)
            marks[rows[mark_rows]] = True
    RAg = torch.where(marks[:m], torch.full_like(RA, -1.0), RA) if guarantee else RA

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
    prob = torch.where(ncm, prob, torch.full_like(prob, -1.0))
    chosen = torch.sort(prob, descending=True, stable=True).indices[:n_ref]
    return chosen, thresh, ij_i[chosen], ij_j[chosen]


def scatter_exact(RA, ncm, ids, vals):
    """Land a batch of exact distances (in place)."""
    RA[ids] = vals
    ncm[ids] = False
    return RA, ncm


def tighten_full(ij_i, ij_j, RA, ncm, lb, ub, nx: int, block: int = 16):
    """Bound tightening by the tropical self-product of the computed
    distances: with E the (nx, nx) matrix of computed pairs,

        LB'[i,j] = max_y |E[i,y] - E[j,y]|   (both entries present)
        UB'[i,j] = min_y  E[i,y] + E[j,y]

    in blocks of ``block`` columns y, so each (nx, nx, block) temporary
    stays bounded.  Pending pairs take the tightened interval."""
    dev = RA.device
    ii = ij_i.long()
    jj = ij_j.long()
    ok = ~ncm
    d = torch.where(ncm, torch.zeros_like(RA), RA)
    E = torch.zeros((nx, nx), dtype=torch.float32, device=dev)
    E[ii, jj] = d
    E[jj, ii] = d
    V = torch.zeros((nx, nx), dtype=torch.bool, device=dev)
    V[ii, jj] = ok
    V[jj, ii] = ok
    Einf = torch.where(V, E, torch.full_like(E, F32_INF))
    Ezero = torch.where(V, E, torch.zeros_like(E))

    lbM = torch.zeros((nx, nx), dtype=torch.float32, device=dev)
    ubM = torch.full((nx, nx), F32_INF, dtype=torch.float32, device=dev)
    for y0 in range(0, nx, block):
        a = Ezero[:, y0 : y0 + block]
        v = V[:, y0 : y0 + block]
        e = Einf[:, y0 : y0 + block]
        diff = (a[:, None, :] - a[None, :, :]).abs_()
        diff.masked_fill_(~(v[:, None, :] & v[None, :, :]), 0.0)
        torch.maximum(lbM, diff.amax(dim=2), out=lbM)
        del diff
        torch.minimum(ubM, (e[:, None, :] + e[None, :, :]).amin(dim=2), out=ubM)
    lb2 = torch.where(ncm, torch.maximum(lb, lbM[ii, jj]), lb)
    ub2 = torch.where(ncm, torch.minimum(ub, ubM[ii, jj]), ub)
    return lb2, ub2


def clip_ra(RA, ncm, lb, ub):
    """Re-clip the never-computed estimates into the tightened interval."""
    return torch.where(ncm, torch.minimum(torch.maximum(RA, lb), ub), RA)


def knn(RA, ncm, P_idx, ij_i, ij_j, nn: int):
    """Graph assembly (reference get_nn, utils.py:383-429): per point,
    the nn smallest of its incidence row, where uncomputed pairs carry a
    +rowmax penalty so computed pairs win (ties to the lower column).

    Returns (pair ids (nx, nn), partners, RA values, computed flags)."""
    dev = RA.device
    m = RA.shape[0]
    nx, max_deg = P_idx.shape
    RA_pad = torch.cat([RA, torch.tensor([F32_INF], device=dev)])
    ncm_ext = torch.cat([ncm, torch.ones(1, dtype=torch.bool, device=dev)])
    pair_sum = torch.cat(
        [ij_i.long() + ij_j.long(), torch.zeros(1, dtype=torch.int64, device=dev)]
    )
    ids = torch.zeros((nx, nn), dtype=torch.int64, device=dev)
    part = torch.zeros((nx, nn), dtype=torch.int64, device=dev)
    ra = torch.zeros((nx, nn), dtype=torch.float32, device=dev)
    cm = torch.zeros((nx, nn), dtype=torch.bool, device=dev)
    blk = _row_block(nx, max_deg)
    for start in _row_blocks(nx, blk):
        rows = P_idx[start : start + blk].long()
        vals = RA_pad[rows]
        ncm_rows = ncm_ext[rows]
        valid = rows < m
        mx = torch.where(valid, vals, -F32_INF).amax(dim=1, keepdim=True)
        dpen = torch.where(
            valid, vals + torch.where(ncm_rows, mx, 0.0), F32_INF
        )
        # the nn smallest, ties to the lower column (lax.top_k's order)
        cols = torch.sort(dpen, dim=1, stable=True).indices[:, :nn]
        pair_ids = torch.gather(rows, 1, cols)
        row_ids = torch.arange(start, start + blk, device=dev)[:, None]
        partners = pair_sum[pair_ids] - row_ids
        ids[start : start + blk] = pair_ids
        part[start : start + blk] = torch.where(pair_ids < m, partners, -1)
        ra[start : start + blk] = torch.gather(vals, 1, cols)
        cm[start : start + blk] = ~torch.gather(ncm_rows, 1, cols)
    return ids, part, ra, cm


# ---------------------------------------------------------------------------
# the fit state


class DeviceFitState:
    """Device-resident pair state of a dense fit plus the host mirrors
    (the not-computed mask and the exact float64 values) that keep the
    orchestrator's plug-in surface intact."""

    CDF_GRID = 4096

    def __init__(self, ann):
        self.ann = ann
        self.device = dev = ann.device
        nx = ann.nx
        IJs = ann.IJs
        self.m = IJs.shape[0]
        self.ij_i = torch.as_tensor(IJs[:, 0].astype(np.int32), device=dev)
        self.ij_j = torch.as_tensor(IJs[:, 1].astype(np.int32), device=dev)

        D32 = torch.as_tensor(np.asarray(ann.D, dtype=np.float32), device=dev)
        self.lb, self.ub, self.dad = features(D32, self.ij_i, self.ij_j)

        if self.m == nx * (nx - 1) // 2:
            self.P_idx_d = pidx_full(nx, dev)
        else:
            # dense fits never reach the reference's degree cap
            # (2^29 // nx entries per row > nx), so the matrix is exact
            max_deg = int(np.asarray(ann.P_cnt).max())
            self.P_idx_d = pidx_from_pairs(self.ij_i, self.ij_j, nx, max_deg)

        anchor_np = np.zeros(nx, dtype=bool)
        if len(ann.A):
            anchor_np[np.asarray(ann.A, dtype=int)] = True
        self.anchor_flag = anchor_np[IJs[:, 0]] | anchor_np[IJs[:, 1]]
        self.ncm_host = ~self.anchor_flag
        self.ncm = torch.as_tensor(self.ncm_host, device=dev)
        self.pool = int(self.ncm_host.sum())
        self.exact64 = np.full(self.m, np.nan)
        ids = np.flatnonzero(self.anchor_flag)
        self._anchor_ids = ids if ids.shape[0] else None
        self._fill_anchor_exacts(ids)

        self.RA = torch.zeros(self.m, dtype=torch.float32, device=dev)
        self.thresh = None
        self._started = False
        self._pending_exact = []

        # non-metric fits: anchor pairs keep their exact column values
        # once predictions stop being clipped to the bounds
        self._override = None
        if not ann.is_metric and self._anchor_ids is not None:
            ids = self._anchor_ids
            self._override = (
                torch.as_tensor(ids, device=dev),
                torch.as_tensor(self.exact64[ids].astype(np.float32), device=dev),
            )

    def _pairs_at(self, ids):
        """(len, 2) int64 host pair coordinates for pair ids."""
        return self.ann.IJs[ids].astype(np.int64)

    def _store_exact(self, ids, vals):
        # pool decrements by the count of genuinely new ids, so repeats
        # cannot drift the sampling budget
        ids = np.asarray(ids, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        uids, first = np.unique(ids, return_index=True)
        n_new = int(np.count_nonzero(self.ncm_host[uids]))
        self.ncm_host[uids] = False
        self.exact64[uids] = vals[first]
        self.pool -= n_new

    def _fill_anchor_exacts(self, ids):
        """Anchor-pair rows are exact from the D columns."""
        ann = self.ann
        if not len(ann.A) or ids is None or not len(ids):
            return
        A = np.asarray(ann.A, dtype=int)
        col_of = np.full(ann.nx, -1, dtype=np.int64)
        col_of[A] = np.arange(len(A))
        IJ = self._pairs_at(ids)
        ii, jj = IJ[:, 0], IJ[:, 1]
        i_is_anchor = col_of[ii] >= 0
        other = np.where(i_is_anchor, jj, ii)
        col = np.where(i_is_anchor, col_of[ii], col_of[jj])
        self.exact64[ids] = np.asarray(ann.D)[other, col]

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

        def run(quotas_t, equal_mass=False):
            ids, got, inner = sample_draw(
                self.dad, self.ncm, r, min(ilo, pool - 1), min(ihi, pool - 1),
                pool, quotas_t, equal_mass=equal_mass,
            )
            c = ids.clamp(0, self.m - 1)
            rows = (self.lb[c], self.ub[c], self.dad[c], self.ij_i[c], self.ij_j[c])
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
        feats[:, 3] = self.anchor_flag[ids]
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
        sids = torch.as_tensor(sample_ids.astype(np.int64), device=dev)
        sy = torch.as_tensor(sample_y.astype(np.float32), device=dev)
        self.RA, self.ncm = regress_update(
            self.lb, self.ub, self.dad, self.RA, self.ncm,
            inner, coefs, icepts, sids, sy,
            self.ann.is_metric, not self._started,
        )
        self._started = True
        if self._override is not None:
            self.RA[self._override[0]] = self._override[1]
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
        chosen, self.thresh, sel_i, sel_j = select(
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
        flush when the host mirrors need them.  Returns the eval count."""
        n_ref = int(min(n_ref, self.pool))
        if n_ref <= 0:
            self.thresh = None
            return 0
        chosen, sel_i, sel_j = self._select(error_predictor, n_ref, nn, guarantee, nmin)
        y = batch_dev(sel_i, sel_j).to(torch.float32)
        self.RA, self.ncm = scatter_exact(self.RA, self.ncm, chosen, y)
        # `chosen` holds n_ref distinct uncomputed ids (computed pairs
        # score -1 and n_ref <= pool), so the budget is settled now
        self._pending_exact.append((chosen, y))
        self.pool -= n_ref
        return n_ref

    def _flush_exacts(self):
        """Land every deferred fused-select batch in the host mirrors."""
        for ch, yv in self._pending_exact:
            ids = ch.cpu().numpy().astype(np.int64)
            self.ncm_host[ids] = False
            self.exact64[ids] = yv.cpu().numpy().astype(np.float64)
        self._pending_exact = []

    def seed_ra_from_store(self):
        """Scatter every stored exact value into the device RA (for fits
        that end before the first regression predict ran)."""
        self._flush_exacts()
        ids = np.flatnonzero(~self.ncm_host).astype(np.int64)
        if ids.shape[0]:
            self.apply_exact(ids, self.exact64[ids])

    def apply_exact(self, ids, vals):
        idd = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        vd = torch.as_tensor(np.asarray(vals, np.float32), device=self.device)
        self.RA, self.ncm = scatter_exact(self.RA, self.ncm, idd, vd)
        self._store_exact(ids, vals)

    def tighten(self):
        self.lb, self.ub = tighten_full(
            self.ij_i, self.ij_j, self.RA, self.ncm, self.lb, self.ub, self.ann.nx
        )

    def finalise(self):
        self.tighten()
        self.RA = clip_ra(self.RA, self.ncm, self.lb, self.ub)

    def knn_graph(self, nn):
        """Final k-NN graph: exact distances from the host float64
        mirror, predicted ones from the f32 estimates.  A computed edge
        whose value is still pending on the host reads its RA entry,
        which holds the same f32 value the flush would store."""
        nn = min(int(nn), int(self.P_idx_d.shape[1]))
        pair_ids, partners, ra_sel, sel_cm = (
            t.cpu().numpy()
            for t in knn(self.RA, self.ncm, self.P_idx_d, self.ij_i, self.ij_j, nn)
        )
        pair_ids = pair_ids.astype(np.int64)
        ngi = partners.astype(np.int64)
        ra_sel = ra_sel.astype(np.float64)
        exact = self.exact64[np.clip(pair_ids, 0, self.m - 1)]
        is_exact = (pair_ids < self.m) & sel_cm
        self.ng_exact_mask = is_exact
        ngd = np.where(is_exact & ~np.isnan(exact), exact, ra_sel)
        return ngi, ngd

    # -- host materialisation ------------------------------------------------

    def ncm_to_host(self):
        self._flush_exacts()
        return self.ncm_host

    def materialise(self):
        """Float64 host arrays (features, RA, ncm); exact values keep
        full precision from the host mirror."""
        self._flush_exacts()
        features = np.stack(
            [
                self.lb.cpu().numpy().astype(np.float64),
                self.ub.cpu().numpy().astype(np.float64),
                self.dad.cpu().numpy().astype(np.float64),
                self.anchor_flag.astype(np.float64),
            ],
            axis=1,
        )
        RA = self.RA.cpu().numpy().astype(np.float64)
        have = ~np.isnan(self.exact64)
        RA[have] = self.exact64[have]
        return features, RA, self.ncm_host.copy()
