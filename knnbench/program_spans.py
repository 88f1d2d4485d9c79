"""The program's own spans (``annchor_tpu_torch.trace``), as the
per-layer metrics of a traced run read them after the window.

The program records a span only while a profiler records, so the list
holds the window's spans and whatever earlier traced work in the same
process left there.  Each metric divides its sum by the root spans of
the window's kind (``fit`` or ``query``) in the list, not by the loop's
counts: earlier traced work of the same kind then averages in, as one
more fit or call, instead of skewing the reading (a run of the benchmark
is one process, so its list holds its window alone).  A program without
the module, or a list without such spans, gives None.
"""

from __future__ import annotations


def per_root(root, name, own=False):
    """Seconds of the closed spans called ``name`` (their self time with
    ``own``: less what their child spans cover) per closed span called
    ``root``; None when either is missing."""
    try:
        from annchor_tpu_torch import trace
    except ImportError:  # a program that records no spans
        return None
    recs = [r for r in trace.spans() if r.end_ns is not None]
    roots = sum(r.name == root for r in recs)
    if own:
        ns = [s for r, s in zip(recs, trace.self_ns(recs)) if r.name == name]
    else:
        ns = [r.end_ns - r.start_ns for r in recs if r.name == name]
    if not roots or not ns:
        return None
    return sum(ns) / roots / 1e9
