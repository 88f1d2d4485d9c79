"""Time the query walk (``select_refine_candidate_query_pairs``) alone, at
the size a benchmark query cell gives it, for the annchor_tpu_torch
package of one checkout; with ``--lines`` also each of its lines' own
time.

    python3 tools/time_walk.py [--root DIR] [--label NAME] [--seed N]
                               [--reps N] [--lines] [CELL ...]

CELL is a query cell of ``BENCHMARK.json`` (default: every cell whose
traffic is a ``query_loop``).  For each, the cell's configuration fits
its index on the seed's index rows (``knnbench.harness.Context``, as a
run of the cell does), two warm calls over the held-out pool build every
kernel, and one more call records the walk's inputs and each metric call
it makes (pairs asked, distances returned).  The walk then runs again on
copies of those inputs with the recorded answers in place of the metric
(the memoised metric: only the walk's own work is timed), ``--reps``
times; each wall ends in a synchronise.  ``--lines`` runs it once more
under a line tracer: each line of the package's ``query.py`` and
``ops/pairs.py`` is charged the time until the next traced event, so a
line's time includes the numpy, torch and device waits it calls but not
the traced lines it calls.  Prints the card's name and power limit, the
tables, and one JSON line {"label", "card", "cells": {cell: {"walk_s",
"calls", "sizes", "lines"}}}.

``--root`` is the checkout whose package is imported (default: the one
holding this script), so two versions are compared by running the
script once per checkout in one call, in the order A, B, B, A (for
example the parent commit unpacked with ``git archive`` into an ignored
directory, and this tree).
"""

from __future__ import annotations

import argparse
import json
import linecache
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _copied(args):
    """The arguments, each numpy array copied (the walk may write them)."""
    return [a.copy() if isinstance(a, np.ndarray) else a for a in args]


def capture(query_mod, ann, Q, nn, p_work):
    """One ``ann.query`` call, recording the walk's arguments (copied on
    entry) and its metric calls [(IJ, distances)]."""
    real = query_mod.select_refine_candidate_query_pairs
    seen = {}

    def recording(*args, **kw):
        seen["args"] = tuple(_copied(args))
        seen["kw"] = dict(kw)
        calls = seen["calls"] = []
        geq = args[10]

        def logged(f, X, Z, IJ):
            d = geq(f, X, Z, IJ)
            calls.append((IJ.copy(), d.copy()))
            return d

        return real(*args[:10], logged, *args[11:], **kw)

    query_mod.select_refine_candidate_query_pairs = recording
    try:
        ann.query(Q, nn=nn, p_work=p_work)
    finally:
        query_mod.select_refine_candidate_query_pairs = real
    return seen


def replay(query_mod, seen, sync):
    """The walk once on copies of the recorded inputs, the metric
    answered from the record; returns its wall (s)."""
    calls = iter(seen["calls"])

    def memo(f, X, Z, IJ):
        want, d = next(calls)
        if want.shape != IJ.shape or (want != IJ).any():
            raise RuntimeError("the walk asked other pairs than the recorded call")
        return d

    args = _copied(seen["args"])
    args[10] = memo
    sync()
    t0 = time.perf_counter()
    query_mod.select_refine_candidate_query_pairs(*args, **seen["kw"])
    sync()
    return time.perf_counter() - t0


def line_times(query_mod, seen, sync, files):
    """Own seconds of each traced line over one replay: {(file, line): s}."""
    own = {}
    last = [None, 0]

    def charge(key):
        now = time.perf_counter_ns()
        if last[0] is not None:
            own[last[0]] = own.get(last[0], 0) + now - last[1]
        last[0], last[1] = key, now

    def local(frame, event, arg):
        code = frame.f_code
        if event == "line":
            charge((code.co_filename, frame.f_lineno))
        elif event == "return":
            back = frame.f_back
            charge((back.f_code.co_filename, back.f_lineno) if back is not None else None)
        return local

    def glob(frame, event, arg):
        if frame.f_code.co_filename in files:
            charge((frame.f_code.co_filename, frame.f_lineno))
            return local
        return None

    sys.settrace(glob)
    try:
        replay(query_mod, seen, sync)
    finally:
        sys.settrace(None)
        charge(None)
    return {k: v / 1e9 for k, v in own.items() if k[0] in files}


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cells", nargs="*")
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--seed", type=int, default=2**31 + 17)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--lines", action="store_true")
    ap.add_argument("--top", type=int, default=24)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import annchor_tpu_torch.query as query_mod
    from knnbench import harness

    if not torch.cuda.is_available():
        raise SystemExit("time_walk: no CUDA device")
    label = args.label or root
    name = card()
    print("%s: %s, package %s" % (label, name, os.path.dirname(query_mod.__file__)), flush=True)
    bench = harness.Bench()
    cells = args.cells or [c["name"] for c in bench.spec["workloads"]
                           if bench.traffic(c["traffic"])["kind"] == "query_loop"]
    pkg = os.path.dirname(os.path.abspath(query_mod.__file__))
    files = {os.path.join(pkg, "query.py"), os.path.join(pkg, "ops", "pairs.py")}
    out = {}
    for cell in cells:
        ctx = harness.Context(bench, cell, args.seed, 0, False, "cuda", lambda: 0.0)
        mix = ctx.traffic
        data = ctx.make_data(ctx.seed, queries=True)
        ann = ctx.annchor(data.copy_index())
        ann.fit()
        for _ in range(2):
            ann.query(data.pool, nn=mix["nn"], p_work=mix["p_work"])
        torch.cuda.synchronize()
        seen = capture(query_mod, ann, data.pool, mix["nn"], mix["p_work"])
        sync = torch.cuda.synchronize
        replay(query_mod, seen, sync)  # warm
        walls = [replay(query_mod, seen, sync) for _ in range(args.reps)]
        IJs, Qncm = seen["args"][1], seen["args"][6]
        sizes = [int(ij.shape[0]) for ij, _ in seen["calls"]]
        rec = {"walk_s": walls, "calls": len(sizes), "sizes": sizes,
               "candidates": int(IJs.shape[0]), "uncomputed": int(Qncm.sum())}
        print("%s: %d candidate pairs (%d not computed), %d queries; metric calls %s; "
              "walk %.5f s median of %d (%.5f-%.5f), metric memoised" % (
                  cell, rec["candidates"], rec["uncomputed"], len(data.pool), sizes,
                  statistics.median(walls), len(walls), min(walls), max(walls)), flush=True)
        if args.lines:
            own = line_times(query_mod, seen, sync, files)
            total = sum(own.values())
            rec["lines"] = sorted(([os.path.basename(f), ln, s] for (f, ln), s in own.items()),
                                  key=lambda r: -r[2])
            print("  lines, own s of one traced walk (%.5f s in all):" % total)
            for f, ln, s in rec["lines"][:args.top]:
                src = linecache.getline(os.path.join(pkg, "ops" if f == "pairs.py" else "", f),
                                        ln).strip()
                print("  %9.5f %5.1f %%  %s:%d  %s" % (s, 100 * s / total, f, ln, src[:90]))
        sys.stdout.flush()
        out[cell] = rec
        del ann, seen
        torch.cuda.empty_cache()
    print(json.dumps({"label": label, "card": name, "cells": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
