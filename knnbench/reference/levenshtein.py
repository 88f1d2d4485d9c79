"""Levenshtein distance by the textbook dynamic program, in plain
PyTorch.

The DP runs one row of the table at a time for many pairs at once.  A
row's insertion chain, cur[j] = min(t[j], cur[j-1] + 1), is solved with
a running minimum: cur[j] - j = cummin(t[j] - j).  Whole rows of the
index are computed, so a row's k nearest come from every point.

The control computes the same DP in saturating int8 lanes, as an 8-bit
striped aligner does before it re-runs the pairs that overflowed: every
cell is capped at 127, so each distance reads min(d, 127).  The
configuration's neighbours lie at 130-165, so the control breaks the
guarantee that a reported distance is the exact edit distance.
"""

from __future__ import annotations

import numpy as np
import torch

INT8_MAX = 127
# pairs of one DP launch: bounds the (pairs, longest + 1) int32 rows
_BLOCK = 1 << 16


def _codes(strings):
    """(int32 codes padded with -1, lengths) of a list of strings."""
    lens = np.array([len(s) for s in strings], dtype=np.int64)
    out = np.full((len(strings), max(int(lens.max()), 1)), -1, dtype=np.int32)
    for r, s in enumerate(strings):
        out[r, : len(s)] = np.frombuffer(s.encode("utf-32-le"), dtype=np.uint32)
    return out, lens


def pair_distances(A, B, device="cpu", cap=None):
    """Edit distances between A[k] and B[k] (int64 numpy).  ``cap``
    saturates every DP cell at that value (the control)."""
    out = np.empty(len(A), dtype=np.int64)
    for s in range(0, len(A), _BLOCK):
        out[s : s + _BLOCK] = _dp(A[s : s + _BLOCK], B[s : s + _BLOCK], device, cap)
    return out


def _dp(A, B, device, cap):
    a, la = _codes(A)
    b, lb = _codes(B)
    a = torch.from_numpy(a).to(device)
    b = torch.from_numpy(b).to(device)
    la_t = torch.from_numpy(la).to(device)
    lb_t = torch.from_numpy(lb).to(device)
    P, Lb = b.shape
    j = torch.arange(Lb + 1, dtype=torch.int32, device=device)
    prev = j.expand(P, Lb + 1).clone()
    if cap is not None:
        prev.clamp_(max=cap)
    out = torch.where(la_t == 0, lb_t, 0)
    if cap is not None:
        out.clamp_(max=cap)
    rows = torch.arange(P, device=device)
    for i in range(1, a.shape[1] + 1):
        cost = (a[:, i - 1 : i] != b).to(torch.int32)
        t = torch.empty_like(prev)
        t[:, 0] = i
        t[:, 1:] = torch.minimum(prev[:, 1:] + 1, prev[:, :-1] + cost)
        if cap is not None:
            t.clamp_(max=cap)
        cur = torch.cummin(t - j, dim=1).values + j
        if cap is not None:
            cur.clamp_(max=cap)
        done = la_t == i
        out = torch.where(done, cur[rows, lb_t], out)
        prev = cur
    return out.cpu().numpy()


def full_rows(index, queries, device="cpu", cap=None):
    """(rows, len(index)) distances from each query to every index item."""
    nq, nx = len(queries), len(index)
    A = [q for q in queries for _ in range(nx)]
    B = list(index) * nq
    return pair_distances(A, B, device, cap).reshape(nq, nx).astype(np.float64)


def judge(index, queries, reported_ids, k, params, device="cpu"):
    R = full_rows(index, queries, device)
    reps = []
    for ids in reported_ids:
        ids = np.asarray(ids)
        reps.append(np.where(ids >= 0, np.take_along_axis(R, np.clip(ids, 0, None), axis=1),
                             np.nan))
    return reps, np.sort(R, axis=1)[:, :k]


def control(index, queries, k, params, device="cpu"):
    R = full_rows(index, queries, device, cap=INT8_MAX)
    ids = np.argsort(R, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(R, ids, axis=1)
