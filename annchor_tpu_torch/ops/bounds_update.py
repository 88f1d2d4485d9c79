"""Bound tightening from computed distances ("pseudo-anchors").

Port of the JAX package's ``ops/bounds_update.py`` for the host
pipeline.  Between refinement iterations, every computed exact distance
can tighten the triangle-inequality bounds of the pending pairs: for
pair (i, j) and any point y with both d(i,y) and d(j,y) known,

    LB >= |d(i,y) - d(j,y)|      UB <= d(i,y) + d(j,y).

The reference walks per-point sorted lists with a two-pointer
intersection in numba and a 10 s wall-clock bailout (reference
annchor/annchor.py:475-512, utils.py:304-352).  Here, as in the JAX
package, the computed distances are scattered into an (nx, nc) matrix E
with a validity mask V, and each pending pair reduces its two gathered
rows, in float32 on the caller's device, chunked over pairs.  Above
``max_cols`` points the pseudo-anchor columns are the ``max_cols``
points of highest computed degree (any column subset still gives valid
bounds), which keeps E bounded.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["tighten_bounds"]

F32_INF = float("inf")


class _OneSlotDeviceCache:
    """Keeps the last pair array's device copy, holding the host array
    alive so identity stays valid across the fit's iterations."""

    def __init__(self):
        self._host = None
        self._device = None
        self._dev = None

    def get(self, arr: np.ndarray, device):
        if self._host is not arr or self._device != device:
            self._dev = torch.as_tensor(arr.astype(np.int64), device=device)
            self._host = arr
            self._device = device
        return self._dev


_ij_cache = _OneSlotDeviceCache()


def _build_E(IJ_dev, RA32, computed, nx: int, out=None):
    """Scatter the computed distances into the dense (nx, nx)
    pseudo-anchor matrix E and its mask V (pairs are unique, so each
    entry is written once).  ``out``, an (E, V) pair holding other
    pairs' entries, is written into instead of new zero matrices."""
    ci = IJ_dev[:, 0]
    cj = IJ_dev[:, 1]
    d = torch.where(computed, RA32, 0.0)
    dev = RA32.device
    if out is not None:
        E, V = out
    else:
        E = torch.zeros((nx, nx), dtype=torch.float32, device=dev)
        V = torch.zeros((nx, nx), dtype=torch.bool, device=dev)
    E.index_put_((ci, cj), d)
    E.index_put_((cj, ci), d)
    V.index_put_((ci, cj), computed)
    V.index_put_((cj, ci), computed)
    return E, V


def _tighten_chunk(E, V, I, J, lb_old, ub_old):
    Ei = E.index_select(0, I)  # (b, nc)
    Ej = E.index_select(0, J)
    both = V.index_select(0, I) & V.index_select(0, J)
    lb_new = torch.where(both, (Ei - Ej).abs(), -F32_INF).amax(dim=1)
    ub_new = torch.where(both, Ei + Ej, F32_INF).amin(dim=1)
    return torch.maximum(lb_old, lb_new), torch.minimum(ub_old, ub_new)


def tighten_bounds(
    nx,
    IJs,
    RA,
    ncm,
    IJ_pending,
    lb_old,
    ub_old,
    max_cols: int = 16384,
    chunk: int = 65536,
    device="cpu",
):
    """Tighten (lb, ub) for the pending pairs using computed distances.

    IJs/RA/ncm: the full pair state (host arrays); IJ_pending: (p, 2)
    pairs to update.  Returns the tightened (lb, ub) as float64 arrays of
    shape (p,), each float32-rounded as in the JAX package."""
    IJs = np.asarray(IJs)
    computed_np = ~np.asarray(ncm, dtype=bool)
    RA32 = np.asarray(RA, dtype=np.float32)
    if nx <= max_cols:
        # E and V built on the device from the (cached) pair array:
        # only RA and the computed mask travel per call
        Ed, Vd = _build_E(
            _ij_cache.get(IJs, device),
            torch.as_tensor(RA32, device=device),
            torch.as_tensor(computed_np, device=device),
            int(nx),
        )
    else:
        ci = IJs[computed_np, 0].astype(np.int64)
        cj = IJs[computed_np, 1].astype(np.int64)
        cd = torch.as_tensor(RA32[computed_np], device=device)
        # pseudo-anchor columns: the highest computed-degree points,
        # chosen by the JAX package's own host sort (its order among
        # equal degrees decides the set)
        deg = np.bincount(ci, minlength=nx) + np.bincount(cj, minlength=nx)
        cols = np.argsort(-deg)[:max_cols]
        col_of = np.full(nx, -1, dtype=np.int64)
        col_of[cols] = np.arange(max_cols)
        Ed = torch.zeros((nx, max_cols), dtype=torch.float32, device=device)
        Vd = torch.zeros((nx, max_cols), dtype=torch.bool, device=device)
        for a, b in ((ci, cj), (cj, ci)):
            cb = col_of[b]
            keep = cb >= 0
            rows = torch.as_tensor(a[keep], device=device)
            cols_k = torch.as_tensor(cb[keep], device=device)
            keep_t = torch.as_tensor(keep, device=device)
            Ed.index_put_((rows, cols_k), cd[keep_t])
            Vd.index_put_((rows, cols_k), torch.ones_like(rows, dtype=torch.bool))
    IJ_p = torch.as_tensor(np.asarray(IJ_pending, dtype=np.int64), device=device)
    lb = torch.as_tensor(np.asarray(lb_old, dtype=np.float32), device=device)
    ub = torch.as_tensor(np.asarray(ub_old, dtype=np.float32), device=device)
    p = IJ_p.shape[0]
    # power-of-two chunk buckets, as the JAX package's compiled shapes
    nchunk = 4096
    while nchunk < p and nchunk < chunk:
        nchunk <<= 1
    lb_out = torch.empty_like(lb)
    ub_out = torch.empty_like(ub)
    for s in range(0, p, nchunk):
        e = s + nchunk
        lb_out[s:e], ub_out[s:e] = _tighten_chunk(
            Ed, Vd, IJ_p[s:e, 0], IJ_p[s:e, 1], lb[s:e], ub[s:e]
        )
    return (
        lb_out.cpu().numpy().astype(np.float64),
        ub_out.cpu().numpy().astype(np.float64),
    )
