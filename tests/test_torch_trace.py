"""The port's span recorder (``annchor_tpu_torch.trace``) on the CPU: off
without a profiler, nesting, request ids, self time and the profiler's
clock under one; the spans of a strings fit, a digits hybrid fit and
their queries (``query.predict``'s ``on_card``, a host strategy's too);
the scale path's build and tighten spans, and the refinement's spans in
a fit of the strings-100k configuration; the verbose stage table beside
the stage spans; and the benchmark's per-layer metrics that read the
spans."""

import collections
import contextlib
import copy
import io
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import annchor_tpu_torch as att
from annchor_tpu_torch import trace
from annchor_tpu_torch.ops import device_pipeline
from annchor_tpu_torch.datasets import digit_images, grid_cost_matrix, make_strings
from annchor_tpu_torch.regressors import SimpleStratifiedLinearRegression

FIT_STAGES = ("get_anchors", "get_locality", "get_features", "get_sample",
              "fit_predict_regression", "fit_predict_errors",
              "select_refine_candidate_pairs", "update_anchor_points",
              "finalise_bounds", "get_ann")
QUERY_CHILDREN = ("query.anchors", "query.candidates", "query.features", "query.predict",
                  "query.walk", "query.graph")
STRINGS_KW = dict(n_anchors=8, n_neighbors=6, n_samples=300, p_work=0.3, device="cpu")
DIGITS_KW = dict(n_anchors=8, n_neighbors=6, n_samples=400, p_work=0.3, device="cpu")


@pytest.fixture(autouse=True)
def _empty_list():
    trace.reset()
    yield
    trace.reset()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _strings():
    X, _ = make_strings(n=150, length=30, seed=4)
    return list(X[:120]), list(X[120:])


def _digits():
    X, _ = digit_images()
    return X[:120], X[120:150], {"cost_matrix": grid_cost_matrix(), "scout": "sinkhorn",
                                 "n_iter": 30}


def _run(make, queries, nn=5):
    """Construct, fit and query under the profiler: (index, spans)."""
    trace.reset()
    with _profiled():
        ann = make()
        ann.fit()
        ann.query(queries, nn=nn, p_work=0.3)
    return ann, trace.spans()


@pytest.fixture(scope="module")
def strings_run():
    X, Q = _strings()
    return _run(lambda: att.Annchor(X, "levenshtein", **STRINGS_KW), Q)


@pytest.fixture(scope="module")
def digits_run():
    X, Q, fk = _digits()
    return _run(lambda: att.Annchor(X, "wasserstein", func_kwargs=fk, **DIGITS_KW), Q)


def _sparse_fit(profiled, **kw):
    """A digits hybrid fit on the scale path (``ANNCHOR_TPU_FORCE_SPARSE``,
    and the column tighten above 64 points): (index, spans)."""
    X, _, fk = _digits()
    mp = pytest.MonkeyPatch()
    mp.setenv("ANNCHOR_TPU_FORCE_SPARSE", "1")
    mp.setenv("ANNCHOR_TPU_DISABLE_SHARDING", "1")
    mp.setattr(device_pipeline, "MAX_FULL_MATRIX_NX", 64)
    trace.reset()
    try:
        with _profiled() if profiled else contextlib.nullcontext():
            ann = att.Annchor(X, "wasserstein", func_kwargs=fk, **DIGITS_KW, **kw)
            ann.fit()
    finally:
        mp.undo()
    return ann, trace.spans()


@pytest.fixture(scope="module")
def sparse_run():
    return _sparse_fit(True)


def _children(recs, parent):
    return [r for r in recs if r.parent == parent.index]


def test_no_profiler_records_nothing_and_enters_no_range(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    X, Q = _strings()
    ann = att.Annchor(X, "levenshtein", **STRINGS_KW)
    ann.fit()
    ann.query(Q, nn=5, p_work=0.3)
    Xd, Qd, fk = _digits()
    ann = att.Annchor(Xd, "wasserstein", func_kwargs=fk, **DIGITS_KW)
    ann.fit()
    ann.query(Qd, nn=5, p_work=0.3)
    assert trace.spans() == []


def test_no_profiler_records_no_scale_path_span(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    ann, recs = _sparse_fit(False)
    assert ann._locality_info["build"] == "admit" and recs == []
    ann, recs = _sparse_fit(False, max_resident_pairs=ann._locality_info["admitted"] - 1)
    assert ann._locality_info["build"] == "budgeted" and recs == []


def test_spans_nest_with_parents_requests_and_counts():
    with _profiled():
        with trace.span("fit") as fit:
            with trace.span("fit.get_ann", it=1) as stage:
                with trace.span("engine.emd", pairs=3):
                    pass
                stage.count(evals=3)
            fit.count(rounds=2)
        with trace.span("query"):
            with trace.span("query.walk"):
                pass
        with trace.span("engine.encode"):
            pass
    recs = trace.spans()
    assert [r.name for r in recs] == ["fit", "fit.get_ann", "engine.emd", "query",
                                      "query.walk", "engine.encode"]
    fit, stage, emd, query, walk, loose = recs
    assert (fit.parent, stage.parent, emd.parent) == (None, fit.index, stage.index)
    assert (query.parent, walk.parent, loose.parent) == (None, query.index, None)
    assert fit.request == stage.request == emd.request
    assert query.request == walk.request != fit.request
    assert loose.request is None
    assert stage.counts == {"it": 1, "evals": 3} and emd.counts == {"pairs": 3}
    assert fit.counts == {"rounds": 2}
    assert all(r.start_ns <= r.end_ns for r in recs)
    assert fit.start_ns <= stage.start_ns <= emd.start_ns <= emd.end_ns <= stage.end_ns


def test_count_adds_to_the_innermost_open_span():
    trace.count(pairs=1)  # no span open: nothing to add to
    with _profiled():
        with trace.span("pipeline.tighten", pairs=0) as outer:
            with trace.span("inner"):
                trace.count(blocks=2)
            trace.count(pairs=5)
    outer, inner = trace.spans()
    assert outer.counts == {"pairs": 5} and inner.counts == {"blocks": 2}
    with trace.span("off"):
        trace.count(pairs=7)
    assert len(trace.spans()) == 2


def test_device_span_waits_for_the_card_only_while_recording(monkeypatch):
    """A device span synchronises its CUDA devices before its start is
    taken and before its end is, and only while a profiler records."""
    waits = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: waits.append((torch.device(d), time.time_ns())))
    card = torch.device("cuda", 0)
    with trace.device_span("pipeline.tighten", (card, torch.device("cpu"))):
        pass
    assert waits == [] and trace.spans() == []
    with _profiled():
        with trace.device_span("pipeline.tighten", (card,), pairs=3) as sp:
            sp.count(cols=4)
    (rec,) = trace.spans()
    assert rec.counts == {"pairs": 3, "cols": 4}
    assert [d for d, _ in waits] == [card, card]
    assert waits[0][1] <= rec.start_ns <= waits[1][1] <= rec.end_ns


def test_self_ns_takes_out_what_children_cover():
    def rec(i, name, a, b, parent):
        r = trace.Span(i, name, a, parent, 1, {})
        r.end_ns = b
        return r

    # children overlap each other and run past the parent's end
    recs = [rec(0, "certify", 0, 100, None), rec(1, "certify.exact", 10, 30, 0),
            rec(2, "certify.exact", 20, 40, 0), rec(3, "certify.scout", 90, 120, 0),
            rec(4, "engine.emd", 12, 18, 1)]
    open_span = trace.Span(5, "certify.scout", 50, 0, 1, {})
    assert trace.self_ns(recs + [open_span]) == [60, 14, 20, 30, 6, None]


def test_span_ends_lie_within_a_millisecond_of_the_profilers_events():
    with _profiled() as prof:
        with trace.span("warm"):
            pass
        with trace.span("query"):
            with trace.span("query.walk"):
                torch.ones(4096).sum()
                time.sleep(0.003)
            with trace.span("query.graph"):
                time.sleep(0.002)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ("query", "query.walk", "query.graph")}
    recs = [r for r in trace.spans() if r.name != "warm"]
    assert len(recs) == 3 and set(events) == {r.name for r in recs}
    for r in recs:
        e = events[r.name]
        assert abs(e.start_ns() - r.start_ns) < 1_000_000, r
        assert abs(e.start_ns() + e.duration_ns() - r.end_ns) < 1_000_000, r


def test_the_list_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(trace, "_records", collections.deque(maxlen=4))
    with _profiled():
        for i in range(6):
            with trace.span("engine.emd", pairs=i):
                pass
    assert [r.counts["pairs"] for r in trace.spans()] == [2, 3, 4, 5]


def test_strings_fit_records_construct_encoding_and_every_stage(strings_run):
    ann, recs = strings_run
    names = [r.name for r in recs]
    construct = recs[names.index("construct")]
    smoke = recs[names.index("construct.smoke")]
    assert smoke.parent == construct.index
    encodes = [r for r in recs if r.name == "engine.encode"]
    assert encodes[0].request == construct.request and encodes[0].counts["strings"] == 120
    fit = recs[names.index("fit")]
    stages = _children(recs, fit)
    assert {r.name for r in stages} == {"fit." + s for s in FIT_STAGES}
    assert all(r.request == fit.request for r in stages)
    assert sum(r.counts["evals"] for r in stages) == ann.evals
    loop = [r for r in stages if "it" in r.counts]
    assert {r.name[4:] for r in loop} == {"get_sample", "fit_predict_regression",
                                          "fit_predict_errors",
                                          "select_refine_candidate_pairs",
                                          "update_anchor_points"}


def test_engine_encode_counts_strings_and_on_card(strings_run):
    """Both sites of ``engine.encode``, the engine's cache miss and the
    query path's joint encoding, count the strings and those encoded on
    the card: none on the CPU."""
    _, recs = strings_run
    query = next(r for r in recs if r.name == "query")
    encodes = [r for r in recs if r.name == "engine.encode"]
    assert [sorted(r.counts) for r in encodes] == [["on_card", "strings"]] * len(encodes)
    assert all(r.counts["on_card"] == 0 for r in encodes)
    assert encodes[0].counts["strings"] == 120
    assert 120 + 30 in [r.counts["strings"] for r in encodes if r.request == query.request]


def test_one_engine_encode_record_per_encoding(monkeypatch):
    from annchor_tpu_torch.ops.levenshtein_myers import MyersEncoding

    real = MyersEncoding.from_codes.__func__
    built = []

    def counting(cls, codes, lengths, device):
        built.append(len(lengths))
        return real(cls, codes, lengths, device)

    monkeypatch.setattr(MyersEncoding, "from_codes", classmethod(counting))
    X, Q = _strings()
    _, recs = _run(lambda: att.Annchor(X, "levenshtein", **STRINGS_KW), Q)
    assert len(built) >= 3
    assert [r.counts["strings"] for r in recs if r.name == "engine.encode"] == built


def test_hybrid_fit_records_certify_and_its_children(digits_run):
    ann, recs = digits_run
    fit = next(r for r in recs if r.name == "fit")
    in_fit = [r for r in recs if r.request == fit.request]
    get_ann = next(r for r in in_fit if r.name == "fit.get_ann")
    certify = next(r for r in in_fit if r.name == "certify")
    assert certify.parent == get_ann.index and certify.counts["rounds"] >= 1
    kids = collections.Counter(r.name for r in _children(recs, certify))
    assert kids["certify.exact"] >= 2 and kids["certify.scout"] >= 1
    assert kids["certify.scout_wait"] == 1  # pass 1 downloads the scout values once
    emd = sum(r.counts["pairs"] for r in in_fit if r.name == "engine.emd")
    exact = sum(r.counts["pairs"] for r in in_fit if r.name == "certify.exact")
    assert emd == exact == get_ann.counts["evals"] > 0
    assert get_ann.counts["scout_evals"] > 0
    assert sum(r.counts["pairs"] for r in in_fit if r.name == "sinkhorn_exp_chunk") > 0


def test_sparse_fit_records_the_admit_build_and_the_column_tighten(sparse_run):
    ann, recs = sparse_run
    fit = next(r for r in recs if r.name == "fit")
    locality = next(r for r in recs if r.name == "fit.get_locality")
    (admit,) = [r for r in recs if r.name == "locality.admit"]
    assert admit.parent == locality.index and admit.request == fit.request
    m = ann._ij_dev[2]
    assert admit.counts == {"blocks": 1, "admitted": m, "m": m, "switched": 0}
    assert not any(r.name == "locality.budgeted" for r in recs)
    tightens = [r for r in recs if r.name == "pipeline.tighten"]
    assert tightens and all(r.request == fit.request for r in tightens)
    # the column tighten runs once a selection has set thresholds
    assert all(r.counts["cols"] in (0, ann.nx) for r in tightens)
    ran = [r.counts["pairs"] for r in tightens if r.counts["cols"]]
    assert ran and 0 < max(ran) <= m
    assert all(r.counts["pairs"] == 0 for r in tightens if not r.counts["cols"])


def test_sparse_fit_over_the_resident_budget_switches_builds(sparse_run):
    first, _ = sparse_run
    admitted = first._locality_info["admitted"]
    ann, recs = _sparse_fit(True, max_resident_pairs=admitted - 1)
    assert ann._locality_info == {"build": "budgeted", "admitted": admitted}
    (admit,) = [r for r in recs if r.name == "locality.admit"]
    (budgeted,) = [r for r in recs if r.name == "locality.budgeted"]
    assert budgeted.parent == admit.index
    m = ann._ij_dev[2]
    assert admit.counts == {"blocks": 1, "admitted": admitted, "m": m, "switched": 1}
    # the budgeted build admits what the admit build counted, before its cap
    assert budgeted.counts == {"m": m, "admitted": admitted, "bands": 1}


@pytest.fixture(scope="module")
def strings_scale_runs():
    """The strings-100k configuration's small fit on the scale path
    (``test_torch_strings_scale_reference.small_fit``: the budgeted
    build, the sparse state, the refinement) with the profiler on, its
    spans, and the same fit with none: (index, spans, index)."""
    from test_torch_strings_scale_reference import small_fit

    trace.reset()
    with _profiled():
        _, on = small_fit()
    recs = trace.spans()
    trace.reset()
    _, off = small_fit()
    return on, recs, off


def test_refine_span_and_its_children_add_up(strings_scale_runs):
    ann, recs, _ = strings_scale_runs
    fit = next(r for r in recs if r.name == "fit")
    stage = next(r for r in recs if r.name == "fit.refine_neighbor_graph")
    (refine,) = [r for r in recs if r.name == "refine"]
    assert refine.parent == stage.index and refine.request == fit.request
    kids = _children(recs, refine)
    assert {r.name for r in kids} == {"refine.exact", "refine.screen"}
    c = refine.counts
    assert set(c) == {"budget", "certified", "proposed", "screened", "evaluated", "rounds"}
    # the exact batches are every evaluation the refinement added to ann.evals
    pairs = sum(r.counts["pairs"] for r in kids if r.name == "refine.exact")
    assert pairs == c["evaluated"] == stage.counts["evals"] > 0
    assert c["evaluated"] <= c["budget"]
    assert c["certified"] == ann._refine_stats[0]["evals"]
    assert sum(r.name == "refine.screen" for r in kids) == c["rounds"] > 0
    assert 0 < c["screened"] <= c["proposed"]


def test_budgeted_build_counts_what_the_band_filter_admits(strings_scale_runs):
    from annchor_tpu_torch.ops.locality import candidate_pairs_device

    ann, recs, _ = strings_scale_runs
    (build,) = [r for r in recs if r.name == "locality.budgeted"]
    info = {}
    candidate_pairs_device(ann.D, ann.locality, ann.loc_thresh, ann.loc_min, device="cpu",
                           info=info)
    m = ann._ij_dev[2]
    assert build.counts == {"m": m, "admitted": info["admitted"], "bands": 1}
    assert info["admitted"] >= m


def test_spans_leave_the_scale_fit_as_it_is(strings_scale_runs):
    on, _, off = strings_scale_runs
    for a, b in zip(on.neighbor_graph, off.neighbor_graph):
        assert np.array_equal(a, b)
    assert np.array_equal(on._ng_exact, off._ng_exact)
    assert on.evals == off.evals


def test_dense_fit_tightens_every_pair_with_k4(digits_run):
    ann, recs = digits_run
    tightens = [r for r in recs if r.name == "pipeline.tighten"]
    assert tightens
    assert all(r.counts == {"pairs": ann._dev.m, "cols": 0} for r in tightens)
    assert not any(r.name.startswith("locality.") for r in recs)


@pytest.mark.parametrize("which", ["strings", "digits"])
def test_query_children_cover_the_call(which, strings_run, digits_run):
    _, recs = strings_run if which == "strings" else digits_run
    query = next(r for r in recs if r.name == "query")
    kids = _children(recs, query)
    want = QUERY_CHILDREN + (("query.certify",) if which == "digits" else ())
    assert [r.name for r in kids] == list(want)
    walk = kids[4]
    assert walk.counts["pairs"] > 0
    engine = "engine.levenshtein" if which == "strings" else "engine.sinkhorn"
    assert sum(r.counts["pairs"] for r in _children(recs, walk) if r.name == engine) \
        == walk.counts["pairs"]
    covered = sum(r.end_ns - r.start_ns for r in kids)
    assert covered >= 0.9 * (query.end_ns - query.start_ns)
    if which == "digits":
        cert = kids[-1]
        assert [r.name for r in _children(recs, cert)] == ["engine.emd"]
        assert _children(recs, cert)[0].counts["pairs"] == cert.counts["pairs"] > 0


@pytest.mark.parametrize("which", ["strings", "digits"])
def test_walk_counts_rounds_and_syncs(which, strings_run, digits_run):
    """``query.walk`` counts its expansion rounds and its downloads: at
    most two a metric call, plus two, so the walk stays on the device."""
    _, recs = strings_run if which == "strings" else digits_run
    engine = "engine.levenshtein" if which == "strings" else "engine.sinkhorn"
    walks = [r for r in recs if r.name == "query.walk"]
    assert walks
    for walk in walks:
        calls = sum(r.name == engine for r in _children(recs, walk))
        assert 0 <= walk.counts["rounds"] <= 3 and calls >= 1 + walk.counts["rounds"]
        assert 1 <= walk.counts["syncs"] <= 2 * calls + 2


class _HostRegression(SimpleStratifiedLinearRegression):
    """A regression with a ``predict`` of its own: the query keeps the
    host predict."""

    def predict(self, features, feature_names):
        return super().predict(features, feature_names)


@pytest.mark.parametrize("which", ["strings", "digits", "host_strategy"])
def test_query_predict_counts_on_card(which, strings_run, digits_run, monkeypatch):
    """``query.predict`` is a device span that counts ``on_card``: 1 with
    the default strategies' tensor predict, 0 when a strategy keeps its
    host ``predict``."""
    ann, recs = strings_run if which != "digits" else digits_run
    if which == "host_strategy":
        reg = copy.copy(ann.regression)
        reg.__class__ = _HostRegression
        monkeypatch.setattr(ann, "regression", reg)
        X, Q = _strings()
        trace.reset()
        with _profiled():
            ann.query(Q, nn=5, p_work=0.3)
        recs = trace.spans()
    predicts = [r for r in recs if r.name == "query.predict"]
    assert len(predicts) == 1
    assert predicts[0].counts == {"on_card": int(which != "host_strategy")}
    # the walk's downloads stay within their bound on either path
    walk = next(r for r in recs if r.name == "query.walk")
    engine = "engine.sinkhorn" if which == "digits" else "engine.levenshtein"
    calls = sum(r.name == engine for r in _children(recs, walk))
    assert 1 <= walk.counts["syncs"] <= 2 * calls + 2


def test_verbose_table_rows_follow_the_stage_spans():
    from knnbench.tracing import _STAGE_ROW

    X, _ = _strings()
    ann = att.Annchor(X, "levenshtein", verbose=True, **STRINGS_KW)
    out = io.StringIO()
    with _profiled(), contextlib.redirect_stdout(out):
        ann.fit()
    rows = [m.group(1) for m in map(_STAGE_ROW.match, out.getvalue().splitlines()) if m]
    stages = [r.name for r in trace.spans() if r.name.startswith("fit.")]
    assert rows == [s[4:] for s in stages] and set(rows) == set(FIT_STAGES)
    for line in out.getvalue().splitlines():
        if _STAGE_ROW.match(line):
            name, rest = line.split(":", 1)
            assert len(name) == 40 and name.strip() in FIT_STAGES
            t, total, evals = rest.split("|")
            assert len(t) == 8 and len(total) == 9 and evals.endswith(" evals")


def _synthetic(kind):
    """Spans of known lengths (ms) of a window of two fits or two query calls."""
    recs = []

    def add(name, a, b, parent=None, **counts):
        r = trace.Span(len(recs), name, a * 1_000_000, parent, 1, counts)
        r.end_ns = b * 1_000_000
        recs.append(r)
        return r.index

    for base in (0, 1000):
        if kind == "fit":
            c = add("construct", base, base + 40)
            add("engine.encode", base + 5, base + 35, c)
            f = add("fit", base + 50, base + 800)
            add("fit.select_refine_candidate_pairs", base + 100, base + 110, f)
            add("fit.select_refine_candidate_pairs", base + 200, base + 230, f)
            g = add("fit.get_ann", base + 300, base + 700, f)
            cert = add("certify", base + 310, base + 690, g)
            x = add("certify.exact", base + 320, base + 420, cert)
            add("engine.emd", base + 322, base + 418, x)
            add("certify.scout_wait", base + 430, base + 450, cert)
            add("certify.scout", base + 500, base + 560, cert)
            adm = add("locality.admit", base + 60, base + 95, f)
            add("locality.budgeted", base + 70, base + 90, adm)
            add("pipeline.tighten", base + 240, base + 250, f)
            add("pipeline.tighten", base + 710, base + 722, f)
            ref = add("refine", base + 730, base + 790, f)
            x = add("refine.exact", base + 735, base + 755, ref)
            add("engine.levenshtein", base + 736, base + 754, x)
            add("refine.screen", base + 760, base + 770, ref)
            add("refine.exact", base + 775, base + 780, ref)
        else:
            q = add("query", base, base + 500)
            a = add("query.anchors", base, base + 50, q)
            add("engine.encode", base + 1, base + 21, a)
            add("query.predict", base + 60, base + 95, q, on_card=1)
            w = add("query.walk", base + 100, base + 400, q)
            add("engine.encode", base + 110, base + 150, w)
            add("engine.levenshtein", base + 200, base + 260, w)
            c = add("query.certify", base + 420, base + 490, q)
            add("engine.emd", base + 425, base + 485, c)
    return recs


@pytest.mark.parametrize("name,want", [
    ("encode_s.fit", 0.030),
    ("select_s.fit", 0.040),
    ("ann_s.fit", 0.400),
    ("certify_self_s.fit", 0.380 - 0.100 - 0.020 - 0.060),
    ("emd_s.fit", 0.096),
    ("admit_build_s.fit", 0.035),
    ("tighten_s.fit", 0.022),
    ("budgeted_build_s.fit", 0.020),
    ("refine_s.fit", 0.060),
    ("refine_self_s.fit", 0.060 - 0.020 - 0.010 - 0.005),
    ("encode_s.query", 0.020 + 0.040),
    ("walk_self_s.query", 0.300 - 0.040 - 0.060),
    ("predict_s.query", 0.035),
    ("emd_s.query", 0.060),
])
def test_layer_metrics_read_the_spans(name, want, monkeypatch):
    from knnbench import harness

    mod = harness.Bench().module("layer_metrics", name)
    assert mod.read({}) is None  # nothing recorded
    kind = name.rsplit(".", 1)[1]
    monkeypatch.setattr(trace, "_records", collections.deque(_synthetic(kind)))
    assert mod.read({}) == pytest.approx(want, rel=1e-12)
    # the other kind's window holds no root of this kind
    other = "query" if kind == "fit" else "fit"
    monkeypatch.setattr(trace, "_records", collections.deque(_synthetic(other)))
    assert mod.read({}) is None
