"""Kernel K9a (csrc/band_linf.cu, the budgeted band build's fused
triangle lower bound): its share of its roofline over the fits of the
traced window.  The bound counts what the data needs
(``counts_k9a``): one FMNMX per anchor of each pair the band filter
admits, in each of the build's two passes, with the admitted pairs the
program's own count (the ``admitted`` of its ``locality.budgeted``
spans) and the anchors frozen in the configuration; the time is the
device time of the kernels whose names carry the configuration's K9a
fragment."""

from knnbench import counts, counts_k9a, tracing


def read(records):
    prof = records.get("profile")
    k9a = (records.get("config") or {}).get("kernels", {}).get("k9a")
    if not prof or k9a is None:
        return None
    admitted = counts_k9a.admitted_pairs()
    if admitted is None:
        return None
    device_s = tracing.kernel_seconds(prof, k9a["fragment"])
    return counts.roofline_percent(counts_k9a.k9a_bound_s(admitted, k9a["anchors"]), device_s)
