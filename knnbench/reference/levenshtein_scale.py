"""Levenshtein distance for the 100,000-string configuration.

``judge`` is the textbook dynamic program of ``levenshtein.py``, whole
rows of the index in plain PyTorch.

The control is a shortcut a hurried user could ship: the Hamming
distance over the common prefix (the first min(la, lb) characters) plus
the length difference.  It is an upper bound of the edit distance
(substitute within the shared length, delete the rest), exact only where
no insertion or deletion is needed.  The int8 control of ``levenshtein.py``
cannot fail here, since this corpus's 15 nearest neighbours lie far below
its cap of 127.  This corpus's strings descend from one another by
substitutions and deletions, and after a deletion every later character
is shifted, so the shortcut misreads most neighbours and breaks the
guarantee that a distance marked exact is the edit distance.
"""

from __future__ import annotations

import numpy as np
import torch

from knnbench.reference import levenshtein

# index strings of one control launch: bounds the (rows, longest) compare
_BLOCK = 1 << 15


def judge(index, queries, reported_ids, k, params, device="cpu"):
    return levenshtein.judge(index, queries, reported_ids, k, params, device)


def prefix_hamming_rows(index, queries, device="cpu"):
    """(rows, len(index)) control distances from each query to every
    index item (float64)."""
    codes, lens = levenshtein._codes(list(index))
    qcodes, qlens = levenshtein._codes(list(queries))
    L = max(codes.shape[1], qcodes.shape[1])
    x = torch.from_numpy(np.pad(codes, ((0, 0), (0, L - codes.shape[1])), constant_values=-1))
    q = torch.from_numpy(np.pad(qcodes, ((0, 0), (0, L - qcodes.shape[1])), constant_values=-1))
    x, q = x.to(device), q.to(device)
    lx = torch.from_numpy(lens).to(device)
    pos = torch.arange(L, device=device)
    out = np.empty((len(queries), len(index)), dtype=np.float64)
    for r in range(len(queries)):
        for s in range(0, len(index), _BLOCK):
            xb, lb = x[s : s + _BLOCK], lx[s : s + _BLOCK]
            shared = torch.minimum(lb, torch.tensor(int(qlens[r]), device=device))
            diff = ((xb != q[r]) & (pos[None, :] < shared[:, None])).sum(dim=1)
            out[r, s : s + _BLOCK] = (diff + (lb - int(qlens[r])).abs()).cpu().numpy()
    return out


def control(index, queries, k, params, device="cpu"):
    R = prefix_hamming_rows(index, queries, device)
    ids = np.argsort(R, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(R, ids, axis=1)
