"""Metric engine, host EMD (metrics.py -> native.py): seconds a fit
spends in its exact evaluator, from a span the benchmark records around
each of its calls, averaged over the fits of the traced window."""


def read(records):
    fits = [f for f in records.get("fits") or [] if f.get("exact_eval")]
    if not fits:
        return None
    return sum(f["host_emd_s"] for f in fits) / len(fits)
