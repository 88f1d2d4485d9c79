"""The general generators of traffic: one module per kind of loop,
``loops/<kind>.py``, found by the ``kind`` a mix's data file names.
Each has ``run(ctx)`` -> (window, Answers, index, records): the
window's numbers for the end-to-end metrics, the rows produced for the
comparison with the reference, the index fitted, and a traced run's
records for the per-layer metrics.  What they share is here.
"""

from __future__ import annotations

# the warm-up's data come from the run's seed plus this
WARM_SEED_OFFSET = 0x5EED


class Answers:
    """Rows the window produced, for the comparison with the reference:
    the query items judged (a fit's sampled index rows, or a sample of
    the queries) and, for each fit or for the calls, the rows reported
    for them: (ids, distances, exact flags or None)."""

    def __init__(self, queries, reported):
        self.queries, self.reported = queries, reported


def delta(after, before):
    """Counters' growth between two readings."""
    return {k: v - before.get(k, 0) for k, v in after.items()}
