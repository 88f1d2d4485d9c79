"""Operations the kernels' inputs need, and the least time the card could
take for them (frozen copies of the program's counting rules, so that
the rooflines keep one yardstick).

K1 (Levenshtein, Myers' bit-parallel word step): a pair of lengths
la <= lb needs ceil(la / 32) x lb word steps, none for a string against
itself; a word step is at least 10 INT32 instructions (the add with
carry in and out is one IADD3.X), issued by 64 lanes a clock per SM.
The bytes a pair reads and writes are three orders below its operations'
time, so operations bound it.

K8a (exp-domain Sinkhorn, FP64 tensor cores): a pair of n-bin histograms
at n_iter iterations needs (2 n_iter + 2) n^2 FP64 FMA (two matrix-vector
products an iteration, two for the cost), at 128 FMA a clock per SM.
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
K1_OPS_PER_WORD_STEP = 10


def peaks(path=os.path.join(HERE, "peaks.json")):
    with open(path) as fh:
        return json.load(fh)


def word_steps(len_a, len_b, same=None):
    """Word steps of pairs of lengths (len_a[k], len_b[k]); ``same``
    marks pairs of a string against itself, which need none."""
    la = np.asarray(len_a, dtype=np.int64)
    lb = np.asarray(len_b, dtype=np.int64)
    steps = (np.minimum(la, lb) + 31) // 32 * np.maximum(la, lb)
    if same is not None:
        steps = np.where(np.asarray(same, dtype=bool), 0, steps)
    return int(steps.sum())


def k1_bound_s(steps, pk=None):
    pk = pk or peaks()
    return steps * K1_OPS_PER_WORD_STEP / (pk["sms"] * pk["int32_lanes_per_sm"] * pk["clock_hz"])


def k8a_fma(pairs, bins, n_iter):
    return int(pairs) * (2 * int(n_iter) + 2) * int(bins) ** 2


def k8a_bound_s(pairs, bins, n_iter, pk=None):
    pk = pk or peaks()
    return k8a_fma(pairs, bins, n_iter) / (pk["sms"] * pk["fp64_tensor_fma_per_sm"]
                                           * pk["clock_hz"])


def roofline_percent(bound_s, device_s):
    """The kernel's share of its roofline, or None where the trace holds
    none of its time."""
    if not device_s or device_s <= 0 or bound_s is None:
        return None
    return 100.0 * bound_s / device_s
