"""Kernel K1 (csrc/levenshtein_myers.cu): its share of its roofline over
the fits of the traced window.  The bound counts the word steps of the
pairs a fit evaluated (each anchor column and each computed candidate
pair outside them; counts.word_steps) at 10 INT32 instructions a step,
at the published peak (peaks.json); the time is the device time of the
kernels whose names carry the configuration's K1 fragment."""

import numpy as np

from knnbench import counts, tracing


def read(records):
    prof, pairs, fits = records.get("profile"), records.get("fit_pairs"), records.get("fits")
    k1 = (records.get("config") or {}).get("kernels", {}).get("k1")
    if not prof or pairs is None or not fits or k1 is None:
        return None
    X = records["index"]
    lens = np.array([len(s) for s in X], dtype=np.int64)
    I, J = pairs
    steps = counts.word_steps(lens[I], lens[J], same=I == J)
    # every fit of the window does the same work; scale by the evals if not
    total = steps * sum(f["evals"] for f in fits) / fits[-1]["evals"]
    device_s = tracing.kernel_seconds(prof, k1["fragment"])
    return counts.roofline_percent(counts.k1_bound_s(total), device_s)
