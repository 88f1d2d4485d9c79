"""Candidate-pair generation from anchor localities, dense branch.

For every point, its `locality` nearest anchors; pair (i, j) is a
k-NN candidate iff the two sets share enough anchors, with a per-row
adaptive threshold that guarantees at least `loc_min` candidates per
point, then symmetrised (reference annchor/annchor.py:208-256,
annchor/utils.py:437-491).  The shared-anchor counts are the binary
product S @ S.T, and the symmetrised test is

    counts[i, j] >= min(eff[i], eff[j])          (i < j)

Only the single-block case (nx <= 4096) is ported; the blocked and
budgeted builds of the scale path are not.
"""

from __future__ import annotations

import numpy as np
import torch

from annchor_tpu_torch.ops.features import anchor_membership, shared_anchor_counts

DENSE_MAX_NX = 4096


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


def candidate_pairs(D, locality: int, loc_thresh: int, loc_min: int, device):
    """Symmetrised candidate pair list from anchor distances.

    D: (nx, na) anchor distances (numpy).  Returns (IJs int32 (m, 2)
    numpy with IJs[:,0] < IJs[:,1] in row-major order, sid, S, eff),
    the last three as tensors on the device.
    """
    D = np.asarray(D)
    nx = D.shape[0]
    if nx > DENSE_MAX_NX:
        raise NotImplementedError(
            "nx = %d > %d needs the blocked scale-path locality build "
            "(ROADMAP Queue 1 item 13), not ported yet" % (nx, DENSE_MAX_NX)
        )
    D32 = torch.as_tensor(D.astype(np.float32), device=device)
    S, sid, eff, keep = _fused_locality(
        D32, min(int(locality), int(D32.shape[1])), int(loc_min),
        int(loc_thresh),
    )
    IJs = torch.nonzero(keep).to(torch.int32).cpu().numpy()
    return IJs, sid, S, eff
