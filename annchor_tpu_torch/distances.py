"""Scalar distance functions (API parity with reference
annchor/distances.py:8-20 and the JAX package's ``distances.py``)."""

from __future__ import annotations

from annchor_tpu_torch.metrics import _cosine_scalar, _euclidean_scalar
from annchor_tpu_torch.ops.levenshtein import levenshtein_scalar as _lev

__all__ = ["euclidean", "levenshtein", "cosine"]


def euclidean(x, y):
    """Euclidean distance."""
    return _euclidean_scalar(x, y)


def levenshtein(x, y):
    """Levenshtein distance."""
    return int(_lev(x, y))


def cosine(x, y):
    """Cosine distance (0 when either vector is zero)."""
    return _cosine_scalar(x, y)
