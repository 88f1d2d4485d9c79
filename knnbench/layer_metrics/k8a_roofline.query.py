"""Kernel K8a: its share of its roofline over the query calls of the
traced window.  The bound counts (2 n_iter + 2) n^2 FP64 FMA for each
pair the calls asked of the scout (anchor columns and walk), recorded by
the benchmark around each call."""

from knnbench import counts, tracing


def read(records):
    prof, log = records.get("profile"), records.get("query_pairs")
    k8a = (records.get("config") or {}).get("kernels", {}).get("k8a")
    if not prof or not log or k8a is None:
        return None
    pairs = sum(len(IJ) for kind, _, _, IJ in log if kind == "scout")
    device_s = tracing.kernel_seconds(prof, k8a["fragment"])
    return counts.roofline_percent(counts.k8a_bound_s(pairs, k8a["bins"], k8a["n_iter"]),
                                   device_s) if pairs else None
