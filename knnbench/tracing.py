"""What a traced run (``--trace 1``) records, from the benchmark's side
of the calls into the program: ``torch.profiler`` over the window (the
card's timeline, read from the profiler's raw kineto events, as the
repo's smoke test reads them: building its event trees takes minutes on
long windows), ranges around the fit's stages and the query calls that
name the host's work in the card's idle gaps, a timer around the
hybrid's exact evaluator, recorders of the pairs the query path asks
the metric engines for, and the fit's own stage table.
"""

from __future__ import annotations

import contextlib
import io
import re
import time

import numpy as np

PREFIX = "knnbench:"
# the fit's stages (``Annchor.fit`` calls each through the instance)
FIT_STAGES = ("get_anchors", "get_locality", "get_features", "get_sample",
              "fit_predict_regression", "fit_predict_errors",
              "select_refine_candidate_pairs", "update_anchor_points",
              "finalise_bounds", "get_ann")
_STAGE_ROW = re.compile(r"^\s*(\w+):\s+([\d.]+) \|")
_SHORT_GAP_NS = 20_000
TOP = 10
NAME_CHARS = 100


def label(name):
    import torch

    return torch.profiler.record_function(PREFIX + name)


def wrap_stages(ann):
    """Run each of ``ann``'s fit stages inside a range named after it."""
    for name in FIT_STAGES:
        fn = getattr(ann, name)

        def staged(*a, _fn=fn, _name=name, **kw):
            with label("stage:" + _name):
                return _fn(*a, **kw)

        setattr(ann, name, staged)


def time_exact_eval(ann, sink):
    """Add the seconds of each call of a hybrid fit's exact evaluator to
    ``sink["host_emd_s"]``; False where the fit has none."""
    exact = getattr(ann, "_exact_eval", None)
    if exact is None:
        return False

    def timed(*a, **kw):
        t = time.perf_counter()
        try:
            return exact(*a, **kw)
        finally:
            sink["host_emd_s"] += time.perf_counter() - t

    ann._exact_eval = timed
    return True


class ScoutRecorder:
    """Stands in for a metric's scout engine and records the pairs each
    call asks for; everything else goes to the engine."""

    def __init__(self, engine, log):
        self._engine = engine
        self._log = log

    def __call__(self, X, Z, IJ):
        self._log.append(("scout", X, Z, np.asarray(IJ)))
        return self._engine(X, Z, IJ)

    def __getattr__(self, name):
        return getattr(self._engine, name)


def record_query_pairs(ann, log):
    """Record the pairs of every call of the query path's exact
    evaluator and of the metric's scout into ``log``."""
    exact = ann._get_exact_query_ijs_for(ann.f)

    def recorded(f, X, Z, IJ):
        log.append(("exact", X, Z, np.asarray(IJ)))
        return exact(f, X, Z, IJ)

    ann.get_exact_query_ijs = recorded
    if getattr(ann.metric, "scout", None) is not None:
        ann.metric.scout = ScoutRecorder(ann.metric.scout, log)


def stage_table(ann):
    """Fit ``ann`` with its stage table on (``verbose``: each stage ends
    in a synchronise) and return [(stage, seconds)]."""
    ann.verbose = True
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ann.fit()
    return [(m.group(1), float(m.group(2)))
            for m in map(_STAGE_ROW.match, out.getvalue().splitlines()) if m]


class Profile:
    """``torch.profiler`` over a block, one per process, with the block
    marked by a range; ``summary()`` reads the card's timeline."""

    def __init__(self, cuda=True):
        from torch.profiler import ProfilerActivity, profile

        self._cuda = cuda
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self._prof = profile(activities=acts)
        self._range = None

    def _sync(self):
        if self._cuda:
            import torch

            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self._prof.__enter__()
        self._range = label("window")
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._sync()
        self._range.__exit__(*exc)
        return self._prof.__exit__(*exc)

    def summary(self):
        """{"window_s", "busy_s", "kernel_s": {name: s}, "kernels": {name: n},
        "device_ops": [[name, s]], "idle_gaps": [[label, s]]}."""
        return summarize(self._prof.profiler.kineto_results.events())


def summarize(events):
    """Reads the card's timeline: its kernels, copies and sets.  A range
    opened on the host (``record_function``, the program's or the
    benchmark's) has a mirror of the same name on the card's timeline
    that spans its kernels and the gaps between them; those mirrors are
    left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, ranges, ops = [], [], []
    host_names = set()
    window = None
    for e in events:
        name = e.name()
        s = e.start_ns()
        d = e.duration_ns()
        if e.device_type() == cuda:
            dev.append((s, s + d, name))
            continue
        host_names.add(name)
        if name == PREFIX + "window":
            window = (s, s + d)
        elif name.startswith(PREFIX):
            ranges.append((s, s + d, name[len(PREFIX):]))
        else:
            ops.append((s, s + d, name))
    if window is None:
        raise RuntimeError("the profile holds no window range")
    by_name, count = {}, {}
    for s, e, name in dev:
        if name not in host_names:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
            count[name] = count.get(name, 0) + 1
    dev = [(s, e) for s, e, name in dev if name not in host_names]
    w0, w1 = window
    iv = np.array(sorted(dev), dtype=np.int64).reshape(-1, 2)
    iv = iv[(iv[:, 1] > w0) & (iv[:, 0] < w1)].clip(w0, w1)
    merged = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) / 1e9
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy, "kernel_s": by_name,
            "kernels": count,
            "device_ops": [[n[:NAME_CHARS], s]
                           for n, s in sorted(by_name.items(), key=lambda r: -r[1])[:TOP]],
            "idle_gaps": _label_gaps(gaps, ranges, ops)}


def _innermost(spans, starts, t):
    """Of the spans that cover time t, the one that starts last: the
    innermost of nested spans (spans sorted by start; the 64 spans that
    start last before t are looked at)."""
    i = int(np.searchsorted(starts, t, side="right")) - 1
    for j in range(i, max(i - 64, -1), -1):
        if spans[j][1] >= t:
            return spans[j][2]
    return None


def _label_gaps(gaps, ranges, ops):
    """Idle time by what the host was doing: the benchmark's range (a fit
    stage or a query call) and the innermost profiled host operation at
    each gap's middle; gaps under 20 us are summed as one."""
    ranges.sort()
    ops.sort()
    rs = np.array([r[0] for r in ranges], dtype=np.int64)
    os_ = np.array([o[0] for o in ops], dtype=np.int64)
    total = {}
    for a, b in gaps:
        if b - a < _SHORT_GAP_NS:
            key = "gaps under 20 us"
        else:
            mid = (a + b) // 2
            where = _innermost(ranges, rs, mid) if ranges else None
            what = _innermost(ops, os_, mid) if ops else None
            key = "%s | %s" % (where or "outside the benchmark's ranges",
                               (what or "host code outside profiled operations")[:NAME_CHARS])
        total[key] = total.get(key, 0.0) + (b - a) / 1e9
    return [[k, v] for k, v in sorted(total.items(), key=lambda r: -r[1])[:TOP]]


def kernel_seconds(profile, fragment):
    """Device seconds of the kernels whose names hold ``fragment``."""
    return sum(v for k, v in profile["kernel_s"].items() if fragment in k)
