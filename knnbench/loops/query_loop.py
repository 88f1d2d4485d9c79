"""One caller that waits for each reply, as the Query Example calls.

Set-up fits the index on the seed's index rows and warms up with
``WARM_CALLS`` calls.  Each call of the window is
``ann.query(Q, nn, p_work)`` over the whole held-out pool, in an order
drawn from the seed anew for each call, so every call does the same
work and no answer can stand for the call before; the window runs whole
calls.  A traced run profiles the window, names each call with a range
and records the pairs the calls ask of the metric engines.

Mix keys: ``nn``, ``p_work`` (the call's arguments).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from knnbench import datagen, tracing
from knnbench.loops import WARM_SEED_OFFSET, Answers, delta

WARM_CALLS = 2


def _judged(ctx, pool_size, calls):
    """The (call, position) pairs judged: ``rows`` of the cell's check
    drawn from the seed among every answer of ``calls`` calls."""
    n = min(ctx.check["rows"], pool_size * calls)
    flat = np.sort(datagen.stream(ctx.seed, 6).choice(pool_size * calls, n, replace=False))
    return [divmod(int(f), pool_size) for f in flat]


def control_inputs(ctx):
    """(index, queries, k) that a run at ctx.seed judges, for the control."""
    data = ctx.make_data(ctx.seed, queries=True)
    pick = datagen.stream(ctx.seed, 6).choice(len(data.pool), ctx.check["rows"], replace=False)
    return data.index, datagen.take(data.pool, np.sort(pick)), ctx.traffic["nn"] + 1


def run(ctx):
    mix = ctx.traffic
    data = ctx.make_data(ctx.seed, queries=True)
    ann = ctx.annchor(data.copy_index())
    ann.fit()
    warm = ctx.make_data(ctx.seed + WARM_SEED_OFFSET, queries=True)
    for _ in range(WARM_CALLS):
        ann.query(warm.pool, nn=mix["nn"], p_work=mix["p_work"])
    ctx.synchronize()
    del warm
    order = datagen.stream(ctx.seed, 5)
    npool = len(data.pool)

    trace = ctx.trace
    log = []
    if trace:
        tracing.record_query_pairs(ann, log)
    calls, lat = [], []
    attempted = failed = 0
    prof = tracing.Profile(ctx.device == "cuda") if trace else contextlib.nullcontext()
    ctx.start_window()
    launches = ctx.launch_counts()
    with prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            ids = order.permutation(npool)
            Q = datagen.take(data.pool, ids)
            attempted += npool
            t = time.perf_counter()
            try:
                with tracing.label("query") if trace else contextlib.nullcontext():
                    ngi, ngd = ann.query(Q, nn=mix["nn"], p_work=mix["p_work"])
            except Exception as err:  # a failed call counts; the run goes on
                failed += npool
                ctx.warn("query call %d failed: %r" % (len(lat) + 1, err))
                calls.append(None)
                continue
            finally:
                lat.append(time.perf_counter() - t)
            calls.append((ids, ngi, ngd))
        wall = time.perf_counter() - t0
    window = {"setup_s": ctx.setup_s, "wall_s": wall, "latencies_s": lat,
              "queries": sum(len(c[0]) for c in calls if c is not None),
              "attempted": attempted, "failed": failed}
    records = {}
    if trace:
        records = {"profile": prof.summary(), "query_pairs": log, "index": data.index,
                   "config": ctx.config, "calls": len(lat),
                   "launches": delta(ctx.launch_counts(), launches)}
    sel = [(c, p) for c, p in _judged(ctx, npool, len(calls)) if calls[c] is not None]
    answers = Answers(datagen.take(data.pool, []), [])
    if sel:
        answers = Answers(datagen.take(data.pool, [calls[c][0][p] for c, p in sel]),
                          [(np.stack([calls[c][1][p] for c, p in sel]),
                            np.stack([calls[c][2][p] for c, p in sel]), None)])
    del ann
    return window, answers, data.index, records
