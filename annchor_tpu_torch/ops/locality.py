"""Candidate-pair generation from anchor localities.

For every point, its `locality` nearest anchors; pair (i, j) is a
k-NN candidate iff the two sets share enough anchors, with a per-row
adaptive threshold that guarantees at least `loc_min` candidates per
point, then symmetrised (reference annchor/annchor.py:208-256,
annchor/utils.py:437-491).  The shared-anchor counts are the binary
product S @ S.T, and the symmetrised test is

    counts[i, j] >= min(eff[i], eff[j])          (i < j)

Three builds:

* ``candidate_pairs``, the host pipeline's: the whole locality stage in
  one block up to 4,096 points, in row blocks of 4,096 above, each
  block's keep mask on the device and its pairs extracted there; the
  pair list comes back to the host;
* the scale path's admit-everything build (``candidate_pairs_device``),
  which keeps every filter-admitted pair as int32 tensors on the device,
  and hands over to the budgeted build when the admitted set would not
  fit (non-metric fits, ``ANNCHOR_TPU_NO_PAIR_BUDGET``);
* the scale path's budgeted two-pass band build
  (``candidate_pairs_device_budgeted``), which keeps each point's
  ``per_point_cap`` candidates of smallest score (the triangle lower
  bound, or with ``ANNCHOR_TPU_BUILD_SCORE=rms`` the anchor profiles'
  RMS difference) and returns the pair list on the device; on a device
  mesh its bands are dealt out over the shards
  (``_budgeted_bands_sharded``).  On a card each band pass under the
  triangle lower bound is one launch of the hand-written K9a
  (``ops/band_linf_cuda.py``), score, filter and epilogue fused.

and the same counts serve the post-fit surface: the query candidates
(``query_candidates``) and the nearest-enemy candidates
(``enemy_candidate_pairs``, with the label-masked thresholds of
``effective_thresholds``).

The shared-anchor counts are float32 products of 0/1 matrices whose
sums are at most ``locality``: exact whether or not the caller lets
matmuls run in TF32, whose 10-bit mantissa holds 0 and 1 exactly.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from annchor_tpu_torch import parallel, trace
from annchor_tpu_torch.ops import band_linf_cuda
from annchor_tpu_torch.ops.features import _f32, anchor_membership, shared_anchor_counts
from annchor_tpu_torch.progress import progress

DENSE_MAX_NX = 4096

# max elements of the dense (rows, nxp) keep panel one extraction
# handles; module-level so tests can shrink it to exercise the row slices
_EXTRACT_ELEMS = 1 << 28

# max elements of one (rows, cols, na) linf broadcast temporary
_LINF_ELEMS = 1 << 26


def _fused_locality(D32, locality: int, loc_min: int, loc_thresh: int):
    """Membership, histogram-trick adaptive thresholds and the
    symmetrised keep mask of the whole locality stage.

    D32: (nx, na) float32.  Returns (S (nx, na) f32, sid (nx, locality)
    int64, eff (nx,) f32, keep (nx, nx) bool)."""
    nx = D32.shape[0]
    S, sid = anchor_membership(D32, locality, D32.device)
    counts = shared_anchor_counts(S)
    kth = torch.zeros(nx, dtype=torch.float32, device=D32.device)
    for c in range(1, locality + 1):
        kth += ((counts >= c).sum(dim=1) > loc_min).to(torch.float32)
    eff = torch.clamp(kth, max=float(loc_thresh))

    thr = torch.minimum(eff[:, None], eff[None, :])
    keep = (counts >= thr).triu_(diagonal=1)
    return S, sid, eff, keep


def candidate_pairs(D, locality: int, loc_thresh: int, loc_min: int, device,
                    block: int = DENSE_MAX_NX):
    """Symmetrised candidate pair list from anchor distances.

    D: (nx, na) anchor distances (numpy).  Up to ``block`` points the
    stage runs as one block; above, the thresholds and the keep mask run
    in row blocks of ``block`` (the JAX package's blocked branch, whose
    bit-packed mask and host decoder become one ``torch.nonzero`` per
    block on the device: the same row-major pairs).  Returns (IJs int32
    (m, 2) numpy with IJs[:,0] < IJs[:,1] in row-major order, sid, S,
    eff), the last three as tensors on the device.
    """
    D = np.asarray(D)
    nx = D.shape[0]
    if nx <= block:
        D32 = torch.as_tensor(D.astype(np.float32), device=device)
        S, sid, eff, keep = _fused_locality(
            D32, min(int(locality), int(D32.shape[1])), int(loc_min),
            int(loc_thresh),
        )
        IJs = torch.nonzero(keep).to(torch.int32).cpu().numpy()
        return IJs, sid, S, eff
    S, sid = anchor_membership(D, locality, torch.device(device))
    eff = effective_thresholds(S, loc_thresh, loc_min, block=block, locality=locality)
    parts = []
    for s in range(0, nx, block):
        keep = _block_keep(S, S[s : s + block], eff[s : s + block], eff, s)
        nz = torch.nonzero(keep)
        nz[:, 0] += s
        parts.append(nz.to(torch.int32).cpu().numpy())
    return np.concatenate(parts), sid, S, eff


# ---------------------------------------------------------------------------
# scale path: blocked thresholds and the budgeted band build


def _block_kth(S, Sb, loc_min: int, locality: int, mask_cols=None):
    """Per row of the block Sb, the number of c in 1..locality whose
    count of columns sharing >= c anchors exceeds loc_min: the
    (loc_min+1)-th largest shared-anchor count, by the integer-histogram
    trick.  ``mask_cols`` (rows, nx) bool: only these columns count.
    Returns float32 (rows,)."""
    counts = shared_anchor_counts(Sb, S)
    if mask_cols is not None:
        counts = torch.where(mask_cols, counts, -1.0)
    kth = torch.zeros(Sb.shape[0], dtype=torch.float32, device=S.device)
    for c in range(1, locality + 1):
        kth += ((counts >= c).sum(dim=1) > loc_min).to(torch.float32)
    return kth


def label_codes(y, device):
    """Dense int64 codes of the labels ``y`` (``np.unique``'s inverse) as
    a tensor on ``device``."""
    _, codes = np.unique(np.asarray(y), return_inverse=True)
    return torch.as_tensor(codes.reshape(-1).astype(np.int64), device=device)


def effective_thresholds(S, loc_thresh: float, loc_min: int, block: int = 4096,
                         locality: int | None = None, label_neq=None,
                         label_mask=None, device=None):
    """Per-row effective threshold eff[i] = min(loc_thresh,
    kth_largest_i), in row blocks of ``block`` so no (nx, nx) count
    matrix exists.  S: (nx, na) 0/1, a tensor or a host array (then
    moved to ``device``).

    label_neq: a label vector y; only the columns j with y[j] != y[i]
    count toward row i's loc_min guarantee (the nearest-enemy path,
    reference annchor.py:713-717), the mask built per row block on the
    device.  label_mask: the same restriction as an (nx, nx)-broadcastable
    host bool array.  Returns float32 (nx,) on the device."""
    S = _f32(S, device)
    nx = S.shape[0]
    if locality is None:
        locality = int(S.sum(dim=1).max())
    codes = None if label_neq is None else label_codes(label_neq, S.device)
    eff = torch.empty(nx, dtype=torch.float32, device=S.device)
    for s in range(0, nx, block):
        mask = None
        if codes is not None:
            mask = codes[s : s + block, None] != codes[None, :]
        elif label_mask is not None:
            mb = np.broadcast_to(np.asarray(label_mask), (nx, nx))[s : s + block]
            mask = torch.tensor(mb, device=S.device)
        eff[s : s + block] = _block_kth(S, S[s : s + block], loc_min, locality, mask)
    return torch.clamp(eff, max=float(np.float32(loc_thresh)))


def enemy_candidate_pairs(S, y, eff_e, loc_eff, block: int = 4096, device=None):
    """New enemy candidate pairs (i < j), in row blocks on the device:
    differently labelled, admitted by the enemy thresholds ``eff_e``,
    and not admitted by the main thresholds ``loc_eff`` (an infinite
    ``loc_eff`` excludes nothing), with the same symmetrised test
    counts >= min(eff[i], eff[j]) as the main filter (reference
    annchor.py:713-733).  Returns host int32 (m_new, 2) in row-major
    order."""
    S = _f32(S, device)
    dev = S.device
    nx = S.shape[0]
    codes = label_codes(y, dev)
    effE = _f32(eff_e, dev)
    effO = _f32(loc_eff, dev)
    # (block, nx) bool panels stay near 2^28 elements
    block = max(1, min(block, (1 << 28) // max(nx, 1)))
    cols = torch.arange(nx, device=dev)
    parts = []
    for s in range(0, nx, block):
        rows = cols[s : s + block]
        counts = shared_anchor_counts(S[s : s + block], S)
        keep = (
            (codes[s : s + block, None] != codes[None, :])
            & (counts >= torch.minimum(effE[s : s + block, None], effE[None, :]))
            & ~(counts >= torch.minimum(effO[s : s + block, None], effO[None, :]))
            & (cols[None, :] > rows[:, None])
        )
        nz = torch.nonzero(keep)
        if nz.shape[0]:
            nz[:, 0] += s
            parts.append(nz.to(torch.int32))
    if not parts:
        return np.zeros((0, 2), dtype=np.int32)
    return torch.cat(parts).cpu().numpy()


def query_candidates(S_X, QD, locality: int, loc_thresh: int, block: int = 4096,
                     device="cpu"):
    """Candidate database points for each query (reference
    get_query_locality, query_functions.py:18-37): the shared-anchor
    count between query q's ``locality`` nearest anchors and each
    database point's, admitted at ``>= loc_thresh``; no adaptive
    threshold and no symmetrisation.  The count is a 0/1 product on the
    device, and the admitted pairs come out of ``torch.nonzero`` in
    (query, database) row-major order.

    S_X: (nx, na) database membership; QD: (nq, na) query anchor
    distances.  Returns host int64 (db_ids, q_ids)."""
    SX = _f32(S_X, device)
    Sq, _ = anchor_membership(QD, locality, SX.device)
    nx = SX.shape[0]
    nq = Sq.shape[0]
    block = max(1, min(block, (1 << 28) // max(nx, 1)))
    thr = float(np.float32(loc_thresh))
    parts = []
    for s in range(0, nq, block):
        nz = torch.nonzero(shared_anchor_counts(Sq[s : s + block], SX) >= thr)
        nz[:, 0] += s
        parts.append(nz)
    if not parts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    qd = torch.cat(parts).cpu().numpy()
    return qd[:, 1].copy(), qd[:, 0].copy()


def _block_keep(S, Sb, eb, eff, row_off: int):
    """Symmetrised keep mask of a row block: keep[i, j] = counts[i, j] >=
    min(eff[i], eff[j]) and j > i, with counts the block's shared-anchor
    counts against every point.  (rows, nx) bool."""
    counts = shared_anchor_counts(Sb, S)
    thr = torch.minimum(eb[:, None], eff[None, :])
    cols = torch.arange(S.shape[0], device=S.device)
    rows = row_off + torch.arange(Sb.shape[0], device=S.device)
    return (counts >= thr) & (cols[None, :] > rows[:, None])


def _block_keep_total(S, Sb, eb, eff, row_off: int):
    """First pass of the admit-everything build for a row block: the
    keep mask's total, column sums and row sums (int64 tensors)."""
    keep = _block_keep(S, Sb, eb, eff, row_off)
    return keep.sum(), keep.sum(dim=0), keep.sum(dim=1)


def _block_keep_extract(S, Sb, eb, eff, row_off: int):
    """Second pass for a row block: the kept pairs as int32 (i, j) in
    row-major order, ``jnp.flatnonzero``'s order.  ``torch.nonzero``
    returns exactly the kept pairs, so the JAX package's capacity buckets
    (``_cap_bucket``, one compiled shape per bucket) have no counterpart."""
    nz = torch.nonzero(_block_keep(S, Sb, eb, eff, row_off))
    return (nz[:, 0] + row_off).to(torch.int32), nz[:, 1].to(torch.int32)


def candidate_pairs_device(D, locality: int, loc_thresh: int, loc_min: int,
                           block: int = 4096, verbose: bool = False,
                           max_resident: int | None = None,
                           budget_cap: int | None = None, device="cpu", info=None):
    """The admit-everything scale build: every pair the filter admits,
    built and kept on the device (nothing O(m) touches the host).

    A counting pass over row blocks comes first.  With ``max_resident``
    and ``budget_cap`` set, an admitted set of more than ``max_resident``
    pairs (which would not fit the fit's O(m) device state) hands the
    membership and thresholds over to the budgeted build, keeping each
    point's ``budget_cap`` candidates; else a second pass extracts the
    pairs.  Blocks are halved until block * nx < 2^31, as the JAX package
    keeps its flat block indices in int32.  ``info``, a dict, receives
    the build taken ("admit" or "budgeted") and the admitted total.

    D: (nx, na) anchor distances (numpy).  Returns (ij_i, ij_j int32
    tensors, m, sid, S, eff tensors, P_cnt int32 numpy (nx,)); the pair
    list is row-major, the JAX package's."""
    D = np.asarray(D)
    nx = D.shape[0]
    dev = torch.device(device)
    S, sid = anchor_membership(D, locality, dev)
    eff = effective_thresholds(S, loc_thresh, loc_min, block=block, locality=locality)
    nblk = min(block, nx)
    while nblk * nx > (1 << 31) - 1 and nblk > 256:
        nblk //= 2
    starts = range(0, nx, nblk)
    totals = []
    P_cnt = torch.zeros(nx, dtype=torch.int64, device=dev)
    for s in progress(starts, "pair-count blocks", verbose):
        t, colcnt, rowcnt = _block_keep_total(S, S[s : s + nblk], eff[s : s + nblk], eff, s)
        totals.append(t)
        P_cnt += colcnt
        P_cnt[s : s + nblk] += rowcnt
    totals = torch.stack(totals).cpu().tolist()
    admitted = int(sum(totals))
    trace.count(blocks=len(starts))
    if info is not None:
        info.update(admitted=admitted, build="admit")
    if max_resident is not None and budget_cap is not None and admitted > max_resident:
        # the admitted set would not fit the fit's O(m) device state
        if verbose:
            print("locality: %d admitted pairs > %d resident budget; switching to "
                  "the budgeted build (cap %d per point)" % (admitted, max_resident,
                                                            budget_cap))
        if info is not None:
            info["build"] = "budgeted"
        with trace.device_span("locality.budgeted", (dev,)) as sp:
            built = candidate_pairs_device_budgeted(
                D, locality, loc_thresh, loc_min, budget_cap, block=block, verbose=verbose,
                device=dev, _pre=(S, sid, eff))
            sp.count(m=built[2])
        return built
    parts_i, parts_j = [], []
    for s, t in progress(list(zip(starts, totals)), "pair-extract blocks", verbose):
        if t:
            bi, bj = _block_keep_extract(S, S[s : s + nblk], eff[s : s + nblk], eff, s)
            parts_i.append(bi)
            parts_j.append(bj)
    if parts_i:
        ij_i, ij_j = torch.cat(parts_i), torch.cat(parts_j)
    else:
        ij_i = torch.zeros(0, dtype=torch.int32, device=dev)
        ij_j = torch.zeros(0, dtype=torch.int32, device=dev)
    return ij_i, ij_j, admitted, sid, S, eff, P_cnt.cpu().numpy().astype(np.int32)


def _band_linf(Db, Dc):
    """(B, C) triangle lower bounds max_k |Db[i,k] - Dc[j,k]| in float32.
    The (B, cols, na) broadcast runs over column slices of at most
    ``_LINF_ELEMS`` elements; max is order-free, so the slicing changes
    no bit."""
    B, na = Db.shape
    C = Dc.shape[0]
    step = max(1, _LINF_ELEMS // max(B * na, 1))
    if step >= C:
        return (Db[:, None, :] - Dc[None, :, :]).abs_().amax(dim=2)
    out = torch.empty((B, C), dtype=torch.float32, device=Db.device)
    for c0 in range(0, C, step):
        out[:, c0 : c0 + step] = (
            (Db[:, None, :] - Dc[None, c0 : c0 + step, :]).abs_().amax(dim=2)
        )
    return out


def _band_score(Db, Dc, score: str):
    """(B, C) ranking score of a band-vs-chunk block: "linf", the triangle
    lower bound max_k |Db[i,k] - Dc[j,k]|, or "rms", the anchor profiles'
    RMS difference sqrt(max(|a|^2 + |b|^2 - 2ab, 0) / na), in the same
    [0, 2 Dmax] range but in matmul form (the JAX package's ``_band_score``).

    The rms products and squared norms are float64 products of the
    float32 values, each rounded once to float32, as the Sinkhorn scout's
    are: no TF32 setting reaches a float64 product, and its value does
    not depend on the order of the sum, so the card and the CPU agree bit
    for bit.  The JAX package sums in float32, so its panel differs from
    this one in the last bits, and after the cancellation in l2sq by up to
    about sqrt(eps * (|a|^2 + |b|^2) / na)."""
    if score == "linf":
        return _band_linf(Db, Dc)
    na = Db.shape[1]
    D64, C64 = Db.double(), Dc.double()
    cross = (D64 @ C64.T).float()
    sq_r = (D64 * D64).sum(dim=1).float()
    sq_c = (C64 * C64).sum(dim=1).float()
    l2sq = sq_r[:, None] + sq_c[None, :] - 2.0 * cross
    return torch.sqrt(torch.clamp(l2sq, min=0.0) / float(np.float32(na)))


def _band_admitted(Sb, Sc, eb, ec, rows, c0: int, nx: int, upper: bool):
    """Filter-admitted mask of a band-vs-chunk block: shared-anchor
    count >= min(eff_row, eff_col), off the diagonal (``upper``: strictly
    above it), real columns only.  A row whose effective threshold is 0
    admits every column, the padding past nx included, so the padding is
    masked here (ROADMAP F6)."""
    counts = shared_anchor_counts(Sb, Sc)
    thr = torch.minimum(eb[:, None], ec[None, :])
    cols = c0 + torch.arange(Sc.shape[0], device=Sb.device)
    off = cols[None, :] > rows[:, None] if upper else cols[None, :] != rows[:, None]
    return (counts >= thr) & off & (cols < nx)[None, :]


def _band_hist_sym(D32p, Sp, Sb, Db, eb, effp, row_off: int, nx: int, inv_bin,
                   nbins: int, cchunk: int, score: str = "linf", cols=None):
    """int32 (B, nbins): each band row's count of admitted partners in
    each bin of the ranking score (``_band_score``), symmetric admitted
    view.  Under "linf" on a card this is one launch of K9a in hist mode
    (``ops/band_linf_cuda.py``) over every column, whose operands
    ``cols`` (``band_linf_cuda.operands(D32p, Sp)``) the build makes once
    and must pass; otherwise ``_band_hist_sym_plain``, with the same
    counts (``cols`` unused)."""
    if score == "linf" and Db.is_cuda:
        return band_linf_cuda.band_hist(band_linf_cuda.operands(Db, Sb), eb, cols, effp,
                                        row_off, nx, inv_bin, nbins)
    return _band_hist_sym_plain(D32p, Sp, Sb, Db, eb, effp, row_off, nx, inv_bin, nbins,
                                cchunk, score)


def _band_hist_sym_plain(D32p, Sp, Sb, Db, eb, effp, row_off: int, nx: int, inv_bin,
                         nbins: int, cchunk: int, score: str = "linf"):
    """K9a's plain PyTorch version in hist mode: the plain bins
    (``_band_bins_sym_plain``) counted per row, the sentinel dropped."""
    BINs = _band_bins_sym_plain(D32p, Sp, Sb, Db, eb, effp, row_off, nx, inv_bin, nbins,
                                cchunk, score)
    H = torch.zeros((BINs.shape[0], nbins + 1), dtype=torch.int32, device=BINs.device)
    H.scatter_add_(1, BINs.long(), torch.ones_like(BINs, dtype=torch.int32))
    return H[:, :nbins].contiguous()


def _band_bins_sym_plain(D32p, Sp, Sb, Db, eb, effp, row_off: int, nx: int, inv_bin,
                         nbins: int, cchunk: int, score: str = "linf"):
    """int16 (B, nxp) binned ranking scores (``_band_score``) of a row
    band against every column, symmetric admitted view, in column chunks
    of ``cchunk``; the sentinel ``nbins`` marks non-candidates.
    ``inv_bin`` is a float32 0-d tensor: the product lb * inv_bin is
    rounded to float32, then truncated to int32.  The JAX package's
    ``_band_bins_sym``; pass 1 off the card (the rms score everywhere)."""
    B = Sb.shape[0]
    nxp = Sp.shape[0]
    rows = row_off + torch.arange(B, device=Sb.device)
    out = torch.full((B, nxp), nbins, dtype=torch.int16, device=Sb.device)
    for c0 in range(0, nxp, cchunk):
        c1 = c0 + cchunk
        adm = _band_admitted(Sb, Sp[c0:c1], eb, effp[c0:c1], rows, c0, nx, upper=False)
        lb = _band_score(Db, D32p[c0:c1], score)
        b = (lb * inv_bin).to(torch.int32).clamp_(0, nbins - 1)
        out[:, c0:c1] = torch.where(adm, b, nbins).to(torch.int16)
    return out


def _band_thr_from_bins(BINs, cap: int, bin_w, nbins: int):
    """Per-row lower-bound threshold from the binned band: (first bin
    whose cumulative count reaches ``cap`` + 1) * bin_w, found by
    log2(nbins) bisection steps; +inf for rows with fewer than ``cap``
    candidates.  ``bin_w`` is a float32 0-d tensor."""
    kept = (BINs < nbins).sum(dim=1)
    B = BINs.shape[0]
    lo = torch.zeros(B, dtype=torch.int32, device=BINs.device)
    hi = torch.full((B,), nbins - 1, dtype=torch.int32, device=BINs.device)
    for _ in range(int(nbins - 1).bit_length()):
        mid = (lo + hi) // 2
        hit = (BINs <= mid[:, None].to(torch.int16)).sum(dim=1) >= cap
        hi = torch.where(hit, mid, hi)
        lo = torch.where(hit, lo, mid + 1)
    thr = (lo.to(torch.float32) + 1.0) * bin_w
    return torch.where(kept >= cap, thr, float("inf"))


def _band_thr_from_hist(H, cap: int, bin_w):
    """``_band_thr_from_bins`` from the per-row histogram of the bins
    (K9a's hist mode), in one pass: the first bin whose cumulative count
    reaches ``cap`` is the number of bins whose cumulative count is below
    it, and the same float32 operations give the same threshold bit for
    bit; +inf for rows with fewer than ``cap`` candidates."""
    kept = H.sum(dim=1)
    first = (H.cumsum(dim=1) < cap).sum(dim=1)
    thr = (first.to(torch.float32) + 1.0) * bin_w
    return torch.where(kept >= cap, thr, float("inf"))


def _band_thresholds(D32p, Sp, Sb, Db, eb, effp, row_off: int, nx: int, inv_bin, bin_w,
                     nbins: int, cap: int, cchunk: int, score: str = "linf", cols=None,
                     admitted=None):
    """Pass 1 of a row band: each row's score threshold.  Under "linf" on
    a card the histogram of K9a's hist mode (``_band_hist_sym``) and
    ``_band_thr_from_hist``, so no (B, nxp) bin matrix is made; otherwise
    the JAX package's way, the plain bins and their bisection
    (``_band_thr_from_bins``).  Both give the same bits.  ``admitted``, a
    0-d int64 tensor on the band's device, gains the admitted partners of
    the band's real rows (each admitted pair counted from both ends)."""
    if score == "linf" and Db.is_cuda:
        H = _band_hist_sym(D32p, Sp, Sb, Db, eb, effp, row_off, nx, inv_bin, nbins, cchunk,
                           score, cols)
        thr, kept = _band_thr_from_hist(H, cap, bin_w), H.sum(dim=1)
    else:
        BINs = _band_bins_sym_plain(D32p, Sp, Sb, Db, eb, effp, row_off, nx, inv_bin, nbins,
                                    cchunk, score)
        thr, kept = _band_thr_from_bins(BINs, cap, bin_w, nbins), (BINs < nbins).sum(dim=1)
    if admitted is not None:
        admitted += kept[: max(0, nx - row_off)].sum()
    return thr


def _band_keep2_dense(D32p, Sp, Sb, Db, eb, effp, thr_all, row_off: int, nx: int,
                      cchunk: int, score: str = "linf", cols=None):
    """Pass-2 keep mask of a row band: upper-triangular admitted pairs
    whose score is under either endpoint's threshold.  Under "linf" on a
    card one launch of K9a (``cols`` as in ``_band_hist_sym``); otherwise
    ``_band_keep2_plain``.  Returns (keep (B, nxp) bool, rowcnt (B,),
    colcnt (nxp,))."""
    B = Sb.shape[0]
    if score == "linf" and Db.is_cuda:
        keep = band_linf_cuda.band_keep(band_linf_cuda.operands(Db, Sb), eb,
                                        thr_all[row_off : row_off + B], cols, effp,
                                        thr_all[: Sp.shape[0]], row_off, nx)
    else:
        keep = _band_keep2_plain(D32p, Sp, Sb, Db, eb, effp, thr_all, row_off, nx, cchunk,
                                 score)
    return keep, keep.sum(dim=1), keep.sum(dim=0)


def _band_keep2_plain(D32p, Sp, Sb, Db, eb, effp, thr_all, row_off: int, nx: int,
                      cchunk: int, score: str = "linf"):
    """K9a's plain PyTorch version in keep mode (and the rms score's only
    one): the keep mask of ``_band_keep2_dense`` in column chunks of
    ``cchunk``."""
    B = Sb.shape[0]
    nxp = Sp.shape[0]
    rows = row_off + torch.arange(B, device=Sb.device)
    thr_rows = thr_all[row_off : row_off + B]
    keep = torch.empty((B, nxp), dtype=torch.bool, device=Sb.device)
    for c0 in range(0, nxp, cchunk):
        c1 = c0 + cchunk
        adm = _band_admitted(Sb, Sp[c0:c1], eb, effp[c0:c1], rows, c0, nx, upper=True)
        lb = _band_score(Db, D32p[c0:c1], score)
        keep[:, c0:c1] = adm & (
            lb <= torch.maximum(thr_rows[:, None], thr_all[None, c0:c1])
        )
    return keep


def _extract_rows(keep, row_off: int, rows_per: int):
    """The set entries of a band keep mask as int32 (i, j) in row-major
    order, one ``torch.nonzero`` per slice of ``rows_per`` rows (slices
    concatenate in row-major order, so the split changes nothing)."""
    parts_i, parts_j = [], []
    for r0 in range(0, keep.shape[0], rows_per):
        nz = torch.nonzero(keep[r0 : r0 + rows_per])
        if nz.shape[0]:
            parts_i.append((nz[:, 0] + (row_off + r0)).to(torch.int32))
            parts_j.append(nz[:, 1].to(torch.int32))
    return parts_i, parts_j


def _budgeted_bands_sharded(mesh, D32p, Sp, effp, nx: int, nblk: int, cchunk: int,
                            inv_bin, bin_w, nbins: int, per_point_cap: int,
                            rows_per: int, verbose: bool):
    """Both passes of the budgeted band build dealt out over a device
    mesh: shard c of group g takes band g*s + c, on its own device
    against its device's copy of the padded membership, anchor distances
    and thresholds.  Pass 1's per-band thresholds cover disjoint rows and
    are gathered in band order; pass 2's P_cnt partials are integer adds
    summed once, and the kept pairs concatenate in band order (group
    ascending, shard ascending).  Every band runs the single-device
    loop's functions, so the result is that loop's, bit for bit.  (The
    JAX package's ``_ShardedBudgetedBuild`` also caches the compiled
    ``shard_map`` programs; there is nothing to cache here.)

    Returns (ij_i, ij_j int32, P_cnt int64 (nxp,), the admitted pairs
    counted from both ends, a 0-d int64 tensor) on the mesh's first
    device."""
    devs = mesh.devices
    s = mesh.size
    first = devs[0]
    nbands = Sp.shape[0] // nblk
    groups = range(-(-nbands // s))
    Ss, Ds, es, invs, bws = (parallel.broadcast(t, devs) for t in (Sp, D32p, effp, inv_bin,
                                                                  bin_w))
    # K9a's column operands, one copy per distinct device
    cols = [None] * s
    if first.type == "cuda":
        cols = list(zip(*(parallel.broadcast(t, devs)
                          for t in band_linf_cuda.operands(D32p, Sp))))

    def bands(g):
        """(shard, first row) of group g's bands."""
        return [(c, (g * s + c) * nblk) for c in range(s) if g * s + c < nbands]

    thr_parts = []
    adm = [torch.zeros((), dtype=torch.int64, device=d) for d in devs]
    for g in progress(groups, "pair-budget pass 1 (sharded)", verbose):
        for c, r0 in bands(g):
            r1 = r0 + nblk
            with parallel.shard_scope(c):
                thr_parts.append(_band_thresholds(
                    Ds[c], Ss[c], Ss[c][r0:r1], Ds[c][r0:r1], es[c][r0:r1], es[c], r0, nx,
                    invs[c], bws[c], nbins, per_point_cap, cchunk, "linf", cols[c], adm[c]))
    thr = parallel.all_gather(thr_parts, devs)

    parts_i, parts_j = [], []
    pcnt = [torch.zeros(Sp.shape[0], dtype=torch.int64, device=d) for d in devs]
    for g in progress(groups, "pair-budget pass 2 (sharded)", verbose):
        for c, r0 in bands(g):
            r1 = r0 + nblk
            with parallel.shard_scope(c):
                keep, rowcnt, colcnt = _band_keep2_dense(
                    Ds[c], Ss[c], Ss[c][r0:r1], Ds[c][r0:r1], es[c][r0:r1], es[c], thr[c],
                    r0, nx, cchunk, "linf", cols[c])
            pcnt[c] += colcnt
            pcnt[c][r0:r1] += rowcnt
            pi, pj = _extract_rows(keep, r0, rows_per)
            parts_i += [parallel.to_device(t, first) for t in pi]
            parts_j += [parallel.to_device(t, first) for t in pj]
            del keep
    P_cnt = parallel.psum(pcnt, [first])[0]
    admitted = parallel.psum(adm, [first])[0]
    if not parts_i:
        empty = torch.zeros(0, dtype=torch.int32, device=first)
        return empty, empty.clone(), P_cnt, admitted
    return torch.cat(parts_i), torch.cat(parts_j), P_cnt, admitted


def candidate_pairs_device_budgeted(
    D,
    locality: int,
    loc_thresh: int,
    loc_min: int,
    per_point_cap: int,
    block: int = 4096,
    nbins: int = 256,
    verbose: bool = False,
    device="cpu",
    _pre=None,
):
    """Two-pass band build of the budgeted candidate set: every point
    keeps its ``per_point_cap`` admitted candidates of smallest score
    (bin-conservative), and a pair is tracked if it is under either
    endpoint's threshold.  The score is ``ANNCHOR_TPU_BUILD_SCORE``:
    "linf" (the default, the triangle lower bound) or "rms" (on 8,192
    bins: the RMS statistic concentrates with the anchor count, and 256
    bins admitted far past the cap in the JAX package's measurements).
    ``_pre`` = (S, sid, eff) from the admit-everything build's counting
    pass skips the membership and thresholds.

    On a device mesh (``parallel.auto_mesh``; ``ANNCHOR_TPU_NO_SHARDED_BUILD``
    opts out) the bands are dealt out over the shards
    (``_budgeted_bands_sharded``), with the same result.  The sharded
    build ranks by "linf" only, as the JAX package's does; where that
    package then drops "rms" for "linf" unannounced, this one raises.

    Pass 1 bins each row band's triangle lower bounds (symmetric view,
    so a row sees every admitted partner) and derives each point's
    threshold; pass 2 re-streams the bands, keeps the pairs i < j under
    either threshold and extracts them.  Only one band's (block, nxp)
    state is live at a time; the result stays on the device.

    The build adds the counts ``admitted`` (the pairs the filter admits
    before the cap) and ``bands`` to the innermost open span
    (``trace.count``), from the read-back of ``P_cnt`` it makes anyway.

    D: (nx, na) anchor distances (numpy).  Returns (ij_i, ij_j int32
    tensors, m, sid, S, eff tensors, P_cnt int32 numpy (nx,)); the pair
    list is row-major, as the JAX package's."""
    score = os.environ.get("ANNCHOR_TPU_BUILD_SCORE", "linf")
    if score not in ("linf", "rms"):
        # the JAX package takes linf for any other value, unannounced
        raise ValueError("ANNCHOR_TPU_BUILD_SCORE must be 'linf' or 'rms', got %r" % score)
    D = np.asarray(D)
    nx = D.shape[0]
    dev = torch.device(device)
    mesh = None
    if not os.environ.get("ANNCHOR_TPU_NO_SHARDED_BUILD"):
        mesh = parallel.auto_mesh(dev)
    if mesh is not None and score != "linf":
        raise ValueError(
            "ANNCHOR_TPU_BUILD_SCORE=%r: the budgeted build on a mesh of %d shards ranks "
            "by 'linf' only; unset the score, or build on one device "
            "(ANNCHOR_TPU_NO_SHARDED_BUILD=1)" % (score, mesh.size)
        )
    if score == "rms":
        nbins = max(nbins, 8192)
    if _pre is not None:
        S, sid, eff = _pre
    else:
        S, sid = anchor_membership(D, locality, dev)
        eff = effective_thresholds(S, loc_thresh, loc_min, block=block, locality=locality)
    D32 = torch.as_tensor(D.astype(np.float32), device=dev)
    lb_max = float(2.0 * D.max()) + 1e-6
    inv_bin = torch.tensor(np.float32(nbins / lb_max), device=dev)
    bin_w = torch.tensor(np.float32(lb_max / nbins), device=dev)

    # band and column-chunk sizes as the JAX package picks them
    nblk = min(block, nx)
    while nblk * nx > (1 << 31) - 1 and nblk > 256:
        nblk //= 2
    nxp = ((nx + nblk - 1) // nblk) * nblk
    while nblk * nxp > (1 << 31) - 1 and nblk > 256:
        nblk //= 2
        nxp = ((nx + nblk - 1) // nblk) * nblk
    cchunk = 2048 if nblk % 2048 == 0 else nblk
    # padded points: no anchors, an infinite threshold, masked columns
    pad = nxp - nx
    Sp = torch.nn.functional.pad(S, (0, 0, 0, pad))
    D32p = torch.nn.functional.pad(D32, (0, 0, 0, pad))
    effp = torch.nn.functional.pad(eff, (0, pad), value=float("inf"))

    rows_per = max(1, min(nblk, _EXTRACT_ELEMS // max(nxp, 1)))
    nbands = nxp // nblk

    def counts_back(P_cnt, admitted):
        """P_cnt on the host, with the admitted total in the same read-back."""
        back = torch.cat([P_cnt[:nx], admitted.view(1)]).cpu().numpy()
        trace.count(admitted=int(back[nx]) // 2, bands=nbands)
        return back[:nx].astype(np.int32)

    if mesh is not None:
        ij_i, ij_j, P_cnt, admitted = _budgeted_bands_sharded(
            mesh, D32p, Sp, effp, nx, nblk, cchunk, inv_bin, bin_w, nbins,
            int(per_point_cap), rows_per, verbose)
        return ij_i, ij_j, int(ij_i.shape[0]), sid, S, eff, counts_back(P_cnt, admitted)

    def band(s):
        return Sp[s : s + nblk], D32p[s : s + nblk], effp[s : s + nblk]

    # K9a's column operands, made once for both passes (the plain
    # versions take none)
    cols = band_linf_cuda.operands(D32p, Sp) if score == "linf" and dev.type == "cuda" else None

    thr = torch.empty(nxp, dtype=torch.float32, device=dev)
    admitted = torch.zeros((), dtype=torch.int64, device=dev)
    for s in progress(range(0, nxp, nblk), "pair-budget pass 1", verbose):
        Sb, Db, eb = band(s)
        thr[s : s + nblk] = _band_thresholds(D32p, Sp, Sb, Db, eb, effp, s, nx, inv_bin,
                                             bin_w, nbins, int(per_point_cap), cchunk, score,
                                             cols, admitted)

    parts_i, parts_j = [], []
    P_cnt = torch.zeros(nxp, dtype=torch.int64, device=dev)
    for s in progress(range(0, nxp, nblk), "pair-budget pass 2", verbose):
        Sb, Db, eb = band(s)
        keep, rowcnt, colcnt = _band_keep2_dense(
            D32p, Sp, Sb, Db, eb, effp, thr, s, nx, cchunk, score, cols
        )
        P_cnt += colcnt
        P_cnt[s : s + nblk] += rowcnt
        pi, pj = _extract_rows(keep, s, rows_per)
        parts_i += pi
        parts_j += pj
        del keep
    if parts_i:
        ij_i = torch.cat(parts_i)
        ij_j = torch.cat(parts_j)
    else:
        ij_i = torch.zeros(0, dtype=torch.int32, device=dev)
        ij_j = torch.zeros(0, dtype=torch.int32, device=dev)
    return ij_i, ij_j, int(ij_i.shape[0]), sid, S, eff, counts_back(P_cnt, admitted)
