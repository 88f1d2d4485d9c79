"""Operations K9a's inputs need, and the least time the card could take
for them (a frozen copy of the rule of the repo's kernels table, so
that the roofline keeps one yardstick).

K9a (the budgeted band build's triangle lower bound, fused with the
band filter): a pair the filter admits needs max_k |D[i,k] - D[j,k]|
over the anchors, one FMNMX per anchor, in each of the build's two
passes (pass 1's per-row histogram, pass 2's threshold keep), issued by
64 lanes a clock per SM.  The admitted pairs are counted once each,
though pass 1 scores every pair from both of its rows: the score is
symmetric, so the data needs it once.  The bytes the data needs (the
anchor distances read once, 4 bytes an anchor a point, and 8 bytes per
kept pair written) are three orders below the operations' time, so
operations bound it; the (rows, columns) keep mask the kernel writes
today is its own choice, not the data's, and is not counted.
"""

from __future__ import annotations

from knnbench.counts import peaks

PASSES = 2
FMNMX_LANES_PER_SM = 64
BUILD_SPAN = "locality.budgeted"


def admitted_pairs():
    """The pairs the band filter admitted, summed over the program's
    closed ``locality.budgeted`` spans of the traced window; None where
    the program records no such span or no ``admitted`` count on one."""
    try:
        from annchor_tpu_torch import trace
    except ImportError:  # a program that records no spans
        return None
    got = [r.counts.get("admitted") for r in trace.spans()
           if r.name == BUILD_SPAN and r.end_ns is not None]
    if not got or any(v is None for v in got):
        return None
    return int(sum(got))


def k9a_ops(admitted, anchors):
    return PASSES * int(admitted) * int(anchors)


def k9a_bound_s(admitted, anchors, pk=None):
    pk = pk or peaks()
    return k9a_ops(admitted, anchors) / (pk["sms"] * FMNMX_LANES_PER_SM * pk["clock_hz"])
