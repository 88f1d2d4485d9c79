"""Converters from the JAX package's numpy state to the port's tensors.

The JAX package hands its state out as numpy arrays (``MyersEncoding``'s
tables, the anchors ``A``, the anchor columns ``D`` and the candidate
pairs ``IJs``).  These functions put the same values on a torch device
in the layouts the port's stage functions take, so any stage of the
port can start from the reference's own state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from annchor_tpu_torch.ops.levenshtein_myers import MyersEncoding


class FitInputs(NamedTuple):
    """A (int64 (na,)), D32 (float32 (nx, na)), ij_i/ij_j (int32 (m,))."""

    A: torch.Tensor
    D32: torch.Tensor
    ij_i: torch.Tensor
    ij_j: torch.Tensor


def encoding_from_numpy(ids, lengths, peq, alphabet, device) -> MyersEncoding:
    """A MyersEncoding from the JAX encoding's ``ids`` (n, L) int32,
    ``lengths`` (n,), ``peq`` (n, alphabet, W) uint32 and alphabet size."""
    return MyersEncoding(ids, lengths, peq, alphabet, device)


def fit_inputs_from_numpy(A, D, IJs, device) -> FitInputs:
    """The anchors, the (nx, na) anchor columns (as float32, the device
    pipeline's type) and the (m, 2) candidate pairs on ``device``."""
    dev = torch.device(device)
    IJs = np.asarray(IJs)
    return FitInputs(
        torch.as_tensor(np.asarray(A, dtype=np.int64), device=dev),
        torch.as_tensor(np.asarray(D, dtype=np.float32), device=dev),
        torch.as_tensor(IJs[:, 0].astype(np.int32), device=dev),
        torch.as_tensor(IJs[:, 1].astype(np.int32), device=dev),
    )
