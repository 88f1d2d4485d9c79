"""A closed loop of whole fits.

Every fit builds a new ``Annchor`` over a fresh copy of the set-up's
inputs with the run's random seed, and ends in a synchronise; the
window runs whole fits.  Set-up warms up with one fit on data made from
another seed.  A traced run profiles the window, names the host's work
with ranges around the constructor and the fit's stages, times the
hybrid's exact evaluator, keeps the pairs the last fit evaluated, and
takes the fit's stage table from ``STAGE_FITS`` further fits after the
window.  The mix has no keys of its own.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from knnbench import datagen, tracing
from knnbench.loops import WARM_SEED_OFFSET, Answers, delta

STAGE_FITS = 3


def _rows(ctx, index):
    """The index rows judged: ``rows`` of the cell's check, drawn from the seed."""
    return np.sort(datagen.stream(ctx.seed, 4).choice(len(index), ctx.check["rows"],
                                                      replace=False))


def control_inputs(ctx):
    """(index, queries, k) that a run at ctx.seed judges, for the control."""
    data = ctx.make_data(ctx.seed)
    return data.index, datagen.take(data.index, _rows(ctx, data.index)), \
        ctx.config["annchor"]["n_neighbors"]


def run(ctx):
    data = ctx.make_data(ctx.seed)
    rows = _rows(ctx, data.index)
    ctx.annchor(ctx.make_data(ctx.seed + WARM_SEED_OFFSET).index).fit()
    ctx.synchronize()

    trace = ctx.trace
    per_fit, kept, last = [], [], None
    attempted = failed = 0
    prof = tracing.Profile(ctx.device == "cuda") if trace else contextlib.nullcontext()
    ctx.start_window()
    launches = ctx.launch_counts()
    with prof:
        t0 = time.perf_counter()
        while True:
            attempted += 1
            sink = {"host_emd_s": 0.0, "exact_eval": False}
            try:
                with tracing.label("construct") if trace else contextlib.nullcontext():
                    ann = ctx.annchor(data.copy_index())
                if trace:
                    tracing.wrap_stages(ann)
                    sink["exact_eval"] = tracing.time_exact_eval(ann, sink)
                with tracing.label("fit") if trace else contextlib.nullcontext():
                    ann.fit()
                ctx.synchronize()
            except Exception as err:  # a failed fit counts; the run goes on
                failed += 1
                ctx.warn("fit %d failed: %r" % (attempted, err))
                if time.perf_counter() - t0 >= ctx.seconds:
                    break
                continue
            elapsed = time.perf_counter() - t0
            ngi, ngd = ann.neighbor_graph
            flags = getattr(ann, "_ng_exact", None)
            kept.append((ngi[rows], ngd[rows], None if flags is None else flags[rows]))
            per_fit.append({"evals": int(ann.evals), "scout_evals": int(ann.scout_evals),
                            "host_emd_s": sink["host_emd_s"],
                            "exact_eval": sink["exact_eval"]})
            last = ann
            if elapsed >= ctx.seconds:
                break
    wall = time.perf_counter() - t0 if not kept else elapsed
    window = {"setup_s": ctx.setup_s, "wall_s": wall, "fits": len(kept),
              "attempted": attempted, "failed": failed}
    records = {}
    if trace:
        records = {"profile": prof.summary(), "fits": per_fit, "index": data.index,
                   "fit_pairs": _evaluated_pairs(last) if last is not None else None,
                   "config": ctx.config, "launches": delta(ctx.launch_counts(), launches)}
        records["stage_tables"] = [tracing.stage_table(ctx.annchor(data.copy_index()))
                                   for _ in range(STAGE_FITS)]
        ctx.synchronize()
    del last
    return window, Answers(datagen.take(data.index, rows), kept), data.index, records


def _evaluated_pairs(ann):
    """The pairs the fit evaluated with its metric engine: every anchor
    column (the anchor against each point) and each computed candidate
    pair that no anchor column holds."""
    A = np.asarray(ann.A, dtype=np.int64)
    IJ = np.asarray(ann.IJs, dtype=np.int64)
    done = IJ[~np.asarray(ann.not_computed_mask, dtype=bool)]
    anchor = np.zeros(ann.nx, dtype=bool)
    anchor[A] = True
    done = done[~(anchor[done[:, 0]] | anchor[done[:, 1]])]
    I = np.concatenate([np.repeat(A, ann.nx), done[:, 0]])
    J = np.concatenate([np.tile(np.arange(ann.nx), A.size), done[:, 1]])
    return I, J
