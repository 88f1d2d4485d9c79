"""Anchor-geometry features.

Port of the JAX package's ``ops/features.py``, which replaces the
reference's numba kernels ``get_bounds_njit_ijs`` (annchor/utils.py:
274-301), ``get_dad_ijs`` (utils.py:355-380) and their query-side
variants (query_functions.py:70-129).  Per pair the work is a gather of
two anchor rows and a reduction over the anchors, so these are plain
torch ops on the fit's device, in float32 as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "bounds_and_dad",
    "bounds_and_dad_tensors",
    "bounds_dad_dev",
    "anchor_membership",
    "shared_anchor_counts",
]


def _f32(D, device):
    if isinstance(D, torch.Tensor):
        return D.to(device=device, dtype=torch.float32)
    return torch.as_tensor(
        np.asarray(D, dtype=np.float32), device=device
    )


def bounds_dad_dev(D32, DJ32, I, J, chunk: int):
    """The feature pass on device tensors: D32 (nx, na) and DJ32
    (ny, na) float32, I and J int64 (m,).  For each pair, with c(p) the
    nearest anchor of p (first index on ties, as ``jnp.argmin``):

        lb  = max_a |D[i,a] - DJ[j,a]|
        ub  = min_a  D[i,a] + DJ[j,a]
        dad = (D[i, c(j)] + DJ[j, c(i)]) / 2

    in chunks of ``chunk`` pairs, so the (chunk, na) gathers stay
    bounded.  Returns float32 (lb, ub, dad) on the device."""
    cA_rows = torch.argmin(D32, dim=1)
    cA_cols = cA_rows if DJ32 is D32 else torch.argmin(DJ32, dim=1)
    m = I.shape[0]
    lb = torch.empty(m, dtype=torch.float32, device=D32.device)
    ub = torch.empty_like(lb)
    dad = torch.empty_like(lb)
    for s in range(0, m, chunk):
        gi, gj = I[s : s + chunk], J[s : s + chunk]
        Di = D32.index_select(0, gi)  # (b, na)
        Dj = DJ32.index_select(0, gj)
        lb[s : s + chunk] = (Di - Dj).abs().amax(dim=1)
        ub[s : s + chunk] = (Di + Dj).amin(dim=1)
        dad[s : s + chunk] = (
            Di.gather(1, cA_cols[gj][:, None])[:, 0]
            + Dj.gather(1, cA_rows[gi][:, None])[:, 0]
        ) * 0.5
    return lb, ub, dad


def bounds_and_dad_tensors(D, I, J, DJ=None, device="cpu", chunk: int = 1 << 20):
    """Triangle-inequality bounds and the double-anchor-distance feature
    (``bounds_dad_dev``) of pairs, left on ``device``.

    D: (nx, na) anchor distances; I, J: int arrays or int64 tensors
    (m,).  DJ: optional right-side anchor-distance matrix for query
    pairs (reference query_functions.py:102-129); defaults to D
    (in-sample).  Returns float32 tensors (lb, ub, dad) of shape (m,)."""
    D32 = _f32(D, device)
    DJ32 = D32 if DJ is None else _f32(DJ, device)
    I, J = (torch.as_tensor(a if isinstance(a, torch.Tensor) else np.asarray(a, dtype=np.int64),
                            device=D32.device) for a in (I, J))
    m = I.shape[0]
    if m == 0:
        z = torch.zeros(0, dtype=torch.float32, device=D32.device)
        return z, z.clone(), z.clone()
    # power-of-two chunk buckets, as the JAX package's compiled shapes
    nchunk = 4096
    while nchunk < m and nchunk < chunk:
        nchunk <<= 1
    return bounds_dad_dev(D32, DJ32, I, J, nchunk)


def bounds_and_dad(D, I, J, DJ=None, device="cpu", chunk: int = 1 << 20):
    """``bounds_and_dad_tensors`` of host pairs, computed in float32 on
    ``device`` and returned as np.float64 arrays (lb, ub, dad)."""
    out = bounds_and_dad_tensors(D, I, J, DJ=DJ, device=device, chunk=chunk)
    return tuple(t.cpu().numpy().astype(np.float64) for t in out)


def anchor_membership(D, locality: int, device="cpu"):
    """Binary membership S[i, a] = 1 iff anchor a is among point i's
    ``locality`` nearest anchors, ties to the lower anchor index as
    ``lax.top_k`` breaks them (a stable ascending sort).  Tiny data sets
    can have fewer anchors than ``locality``: then every anchor is near.
    Returns (S float32 (nx, na), sid int64 (nx, locality)) on the
    device (reference annchor.py:235-241)."""
    D32 = _f32(D, device)
    nx, na = D32.shape
    locality = min(int(locality), int(na))
    sid = torch.sort(D32, dim=1, stable=True).indices[:, :locality]
    S = torch.zeros((nx, na), dtype=torch.float32, device=D32.device)
    S.scatter_(1, sid, 1.0)
    return S, sid


def shared_anchor_counts(S, S_other=None):
    """counts[i, j] = number of near-anchors points i and j share: a
    binary float32 product, exact for these small integers (replaces
    the masked-sum loop of reference utils.py:469-471)."""
    St = S if S_other is None else S_other
    return S @ St.T
