"""Kernel K8a (csrc/sinkhorn.cu, the exp-domain Sinkhorn scout): its
share of its roofline over the fits of the traced window.  The bound is
(2 n_iter + 2) n^2 FP64 FMA for each scout pair the fits evaluated (the
program's own count, Annchor.scout_evals), with n and n_iter frozen in
the configuration, at the FP64 tensor cores' published peak."""

from knnbench import counts, tracing


def read(records):
    prof, fits = records.get("profile"), records.get("fits")
    k8a = (records.get("config") or {}).get("kernels", {}).get("k8a")
    if not prof or not fits or k8a is None:
        return None
    pairs = sum(f["scout_evals"] for f in fits)
    device_s = tracing.kernel_seconds(prof, k8a["fragment"])
    return counts.roofline_percent(counts.k8a_bound_s(pairs, k8a["bins"], k8a["n_iter"]),
                                   device_s)
