"""String encoding and the scalar edit-distance oracle.

Copied from the JAX package's ``ops/levenshtein.py`` (backend-neutral
numpy): strings become a padded codepoint matrix that the bit-parallel
kernel's encoder (``ops/levenshtein_myers.py``) maps to dense alphabet
ids.  ``levenshtein_scalar`` is the pure-Python dynamic programme, the
independent oracle the kernels are held against.
"""

from __future__ import annotations

import numpy as np

from annchor_tpu_torch._backend import round_up


def encode_strings(strings, pad_to_multiple: int = 128):
    """Encode a sequence of unicode strings to a padded codepoint matrix.

    Returns
    -------
    codes: np.ndarray int32, shape (n, L)
        Unicode codepoints, padded with -1.  L is the maximum string
        length rounded up to ``pad_to_multiple``.
    lengths: np.ndarray int32, shape (n,)
    """
    n = len(strings)
    lengths = np.array([len(s) for s in strings], dtype=np.int32)
    L = round_up(max(int(lengths.max()), 1), pad_to_multiple)
    codes = np.full((n, L), -1, dtype=np.int32)
    for k, s in enumerate(strings):
        if len(s):
            codes[k, : len(s)] = np.frombuffer(
                s.encode("utf-32-le"), dtype=np.uint32
            ).astype(np.int32)
    return codes, lengths


def encode_sequences(seqs, pad_to_multiple: int = 128):
    """Encode arbitrary integer sequences (lists/arrays) like strings."""
    n = len(seqs)
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    L = round_up(max(int(lengths.max()), 1), pad_to_multiple)
    codes = np.full((n, L), -1, dtype=np.int32)
    for k, s in enumerate(seqs):
        codes[k, : len(s)] = np.asarray(s, dtype=np.int32)
    return codes, lengths


def levenshtein_scalar(x, y) -> int:
    """Edit distance by the textbook row DP in pure Python."""
    la, lb = len(x), len(y)
    if la == 0:
        return lb
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cur[j] = min(
                prev[j] + 1,
                cur[j - 1] + 1,
                prev[j - 1] + (x[i - 1] != y[j - 1]),
            )
        prev = cur
    return prev[lb]
