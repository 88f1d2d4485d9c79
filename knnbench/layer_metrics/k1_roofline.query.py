"""Kernel K1: its share of its roofline over the query calls of the
traced window.  The bound counts the word steps of the pairs the calls
asked of the exact evaluator (the anchor columns and the walk), recorded
by the benchmark around each call, at 10 INT32 instructions a step."""

import numpy as np

from knnbench import counts, tracing


def read(records):
    prof, log = records.get("profile"), records.get("query_pairs")
    k1 = (records.get("config") or {}).get("kernels", {}).get("k1")
    if not prof or not log or k1 is None:
        return None
    steps = 0
    for kind, X, Z, IJ in log:
        if kind != "exact" or not len(IJ) or not isinstance(X[0], str):
            continue
        la = np.array([len(X[i]) for i in IJ[:, 0]], dtype=np.int64)
        lb = np.array([len(Z[j]) for j in IJ[:, 1]], dtype=np.int64)
        steps += counts.word_steps(la, lb)
    device_s = tracing.kernel_seconds(prof, k1["fragment"])
    return counts.roofline_percent(counts.k1_bound_s(steps), device_s) if steps else None
