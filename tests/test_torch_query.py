"""Out-of-sample query of the port (``annchor_tpu_torch/query.py``) on the
CPU, held against the JAX package.

The query-side candidate counts and features are compared bit for bit.
The whole query is held against the JAX package through a checkpoint:
a Levenshtein index fitted by the JAX package and saved (v1) gives both
packages the same fitted state, so their ``query`` and ``legacy_query``
must return the same indices and distances after the same metric calls.
The rest are the port's copies of the JAX package's query examples
(``tests/test_examples.py``).
"""

import numpy as np
import pytest
import torch

import annchor_tpu as at
import annchor_tpu_torch as att
from annchor_tpu import metrics as jmetrics
from annchor_tpu import query as jquery
from annchor_tpu.ops import features as jfeat
from annchor_tpu.ops import locality as jloc
from annchor_tpu_torch import metrics as tmetrics
from annchor_tpu_torch import query as tquery
from annchor_tpu_torch.datasets import make_strings
from annchor_tpu_torch.ops import features as tfeat
from annchor_tpu_torch.ops import locality as tloc

torch.set_num_threads(2)


def _mutate(strings, rate, seed):
    """Substitution copies of ``strings`` (as chip_smoke.py's mutator)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in strings:
        a = np.array(list(s))
        hit = rng.random(a.shape[0]) < rate
        a[hit] = rng.choice(list("ACGT"), size=int(hit.sum()))
        out.append("".join(a))
    return out


@pytest.mark.parametrize("nx,nq,locality,loc_thresh", [
    (61, 9, 5, 2), (200, 33, 3, 1), (96, 5, 5, 5),
])
def test_query_candidates_matches_jax(nx, nq, locality, loc_thresh):
    """Bit-equal (db, query) candidate lists in the JAX package's
    row-major order, and the oracle of tests/test_ops.py."""
    rng = np.random.default_rng(nx)
    D = np.abs(rng.normal(size=(nx, 12)))
    QD = np.abs(rng.normal(size=(nq, 12)))
    S, _ = jfeat.anchor_membership(D, locality)
    S = np.asarray(S)
    want = jloc.query_candidates(S, QD, locality, loc_thresh)
    got = tloc.query_candidates(S, QD, locality, loc_thresh, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    Sq, _ = tfeat.anchor_membership(QD, locality)
    counts = Sq.numpy() @ S.T
    for q in range(nq):
        np.testing.assert_array_equal(
            got[0][got[1] == q], np.nonzero(counts[q] >= loc_thresh)[0]
        )


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """One JAX fit of a small Levenshtein index, saved as v1 and loaded
    by both packages: (X, JAX index, port index)."""
    X, _ = make_strings(n=300, length=60, seed=7)
    X = list(X)
    fit = at.Annchor(X, "levenshtein", n_anchors=12, n_neighbors=10, n_samples=800,
                     p_work=0.3)
    fit.fit()
    path = str(tmp_path_factory.mktemp("query") / "index.npz")
    fit.save(path)
    ref = at.Annchor.load(path, X, "levenshtein")
    port = att.Annchor.load(path, X, "levenshtein", device="cpu")
    return X, ref, port


def _counting(geq, calls):
    """The evaluator ``geq``, recording the size of every call."""

    def run(f, X, Z, IJ):
        calls.append(int(np.asarray(IJ).shape[0]))
        return geq(f, X, Z, IJ)

    return run


def test_query_features_match_jax(indexes):
    """Query anchor distances, candidates and the float64 feature rows
    of the loaded index equal the JAX package's."""
    X, ref, port = indexes
    Q = _mutate(X[:25], 0.1, 3)
    QD_ref = jquery.get_query_anchor_dists(
        ref, Q, jmetrics.make_get_exact_query_ijs(ref.metric))
    QD = tquery.get_query_anchor_dists(
        port, Q, tmetrics.make_get_exact_query_ijs(port.metric))
    np.testing.assert_array_equal(QD, QD_ref)
    check_ref = jloc.query_candidates(ref.S, QD_ref, ref.locality, ref.loc_thresh)
    check = tloc.query_candidates(port.S, QD, port.locality, port.loc_thresh,
                                  device="cpu")
    want = jquery.get_query_features(ref, Q, QD_ref, check_ref)
    # the features and flags stay on the index's device as tensors
    got = [g.cpu().numpy() if isinstance(g, torch.Tensor) else g
           for g in tquery.get_query_features(port, Q, QD, check)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("nn,p_work", [(8, 0.3), (5, 0.05)])
def test_cross_loaded_query_matches_jax(indexes, nn, p_work):
    """Same checkpoint, same queries: bit-equal ``query`` results after
    the same sequence of metric calls."""
    X, ref, port = indexes
    Q = _mutate(X[:40], 0.1, 3) + _mutate(X[200:210], 0.3, 4)
    calls_ref, calls = [], []
    want = ref.query(Q, nn=nn, p_work=p_work, get_exact_query_ijs=_counting(
        jmetrics.make_get_exact_query_ijs(ref.metric), calls_ref))
    got = port.query(Q, nn=nn, p_work=p_work, get_exact_query_ijs=_counting(
        tmetrics.make_get_exact_query_ijs(port.metric), calls))
    assert got[0].shape == (len(Q), nn + 1)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert calls == calls_ref and sum(calls) > 0


class _Counts:
    """Stands in for a ``trace.span``: keeps the counts it is given."""

    def count(self, **kw):
        self.__dict__.update(kw)


def _recording(geq, calls):
    """The evaluator ``geq``, recording the pairs of every call."""

    def run(f, X, Z, IJ):
        calls.append(np.array(IJ))
        return geq(f, X, Z, IJ)

    return run


def _walk_inputs(port, Q, case):
    """The walk's inputs for ``Q`` on the loaded index, as ``query_``
    builds them, bent to the case: (IJs, P_idx, P_cnt, QRA, Qncm,
    Qerrors)."""
    geq = tmetrics.make_get_exact_query_ijs(port.metric)
    QD = tquery.get_query_anchor_dists(port, Q, geq)
    db_ids, q_ids = tloc.query_candidates(port.S, QD, port.locality, port.loc_thresh,
                                          device="cpu")
    if case == "few_candidates":
        # queries 0 and 1 keep 3 candidates each (< nn: +inf thresholds)
        keep = (q_ids > 1) | (np.arange(q_ids.shape[0]) - np.searchsorted(q_ids, q_ids) < 3)
        db_ids, q_ids = db_ids[keep], q_ids[keep]
    IJs, P_idx, P_cnt, F, Qncm = tquery.get_query_features(port, Q, QD, (db_ids, q_ids))
    F, Qncm = F.cpu().numpy(), Qncm.cpu().numpy()
    QRA = port.regression.predict(F, port.feature_names)
    if case == "integer":
        QRA = np.round(QRA)
    elif case == "zero_margins":
        # every estimate a zero of either sign: every seed margin is
        # +0.0 or -0.0, which a sort on the bits would tell apart
        QRA = np.where(np.random.default_rng(5).random(QRA.shape[0]) < 0.5, -0.0, 0.0)
    Qerrors = port.error_predictor.predict(F, port.feature_names)
    return IJs, P_idx, P_cnt, QRA, Qncm, Qerrors


# (nn, p_work, seed_frac, expand_rounds, inputs, branch of the fair share)
WALK_CASES = {
    "integer": (8, 0.3, 0.5, 3, "integer", None),
    "zero_margins": (8, 0.3, 0.5, 3, "zero_margins", None),
    "few_candidates": (8, 0.3, 0.5, 3, "few_candidates", None),
    "seed_spends_budget": (8, 0.3, 1.0, 3, "integer", None),
    "share_cut": (5, 0.05, 0.5, 3, "integer", "cut"),
    "share_all": (8, 0.6, 0.5, 1, "predicted", "all"),
    "one_round_zero_margins": (8, 0.3, 0.5, 1, "zero_margins", None),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_walk_matches_jax_with_ties(indexes, case):
    """The port's walk on the device tensors against the JAX package's
    numpy walk, same inputs and metric: bit-equal pairs, estimates and
    flags, and the same metric calls, pair for pair."""
    X, ref, port = indexes
    nn, p_work, seed_frac, rounds, inputs, branch = WALK_CASES[case]
    Q = _mutate(X[:40], 0.1, 3) + _mutate(X[200:210], 0.3, 4)
    args = _walk_inputs(port, Q, inputs)
    geq = tmetrics.make_get_exact_query_ijs(port.metric)
    outs, calls, counts = [], [], _Counts()
    for mod, ann, span in ((jquery, ref, None), (tquery, port, counts)):
        IJs, P_idx, P_cnt, QRA, Qncm, Qerrors = (a.copy() for a in args)
        calls.append([])
        kw = dict(seed_frac=seed_frac, expand_rounds=rounds)
        if span is not None:
            kw["span"] = span
        outs.append(mod.select_refine_candidate_query_pairs(
            ann, IJs, Q, P_idx, P_cnt, QRA, Qncm, Qerrors, p_work, nn,
            _recording(geq, calls[-1]), **kw))
    for got, want in zip(outs[1], outs[0]):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    assert len(calls[1]) == len(calls[0])
    for got, want in zip(calls[1], calls[0]):
        np.testing.assert_array_equal(got, want)
    # the case reaches what it names
    sizes = [c.shape[0] for c in calls[0]]
    assert counts.rounds <= rounds and counts.syncs <= 2 * len(sizes) + 2
    if case == "seed_spends_budget":
        assert counts.rounds == 0 and len(sizes) == 1
    if case == "few_candidates":
        assert np.bincount(args[0][:, 1], minlength=len(Q))[:2].tolist() == [3, 3]
    if branch is not None:
        budget = int(p_work * len(Q) * port.nx - port.n_anchors * len(Q)) + 1
        spent, hits = sizes[0], []
        for r, size in enumerate(sizes[1:1 + counts.rounds]):
            left = budget - spent
            share = left if r == rounds - 1 else max(1, left // (rounds - r))
            hits.append(size == share)
            spent += size
        assert (any(hits) if branch == "cut" else not all(hits)) and counts.rounds > 0


def test_cross_loaded_legacy_query_matches_jax(indexes):
    X, ref, port = indexes
    Q = _mutate(X[100:130], 0.1, 5)
    calls_ref, calls = [], []
    want = ref.legacy_query(Q, k=5, get_exact_query_ijs=_counting(
        jmetrics.make_get_exact_query_ijs(ref.metric), calls_ref))
    got = port.legacy_query(Q, k=5, get_exact_query_ijs=_counting(
        tmetrics.make_get_exact_query_ijs(port.metric), calls))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert calls == calls_ref


def test_query_encodes_once_per_call(indexes, monkeypatch):
    """One query encodes the database with the queries once (plus the
    anchors' small encoding), and the held encoding is dropped after."""
    X, _, port = indexes
    port.get_exact_query_ijs = None  # the default evaluator
    Q = _mutate(X[:10], 0.1, 6)
    sizes = []
    real = tmetrics.MyersEncoding.from_codes

    def counting(codes, lengths, device):
        sizes.append(codes.shape[0])
        return real(codes, lengths, device)

    monkeypatch.setattr(tmetrics.MyersEncoding, "from_codes", counting)
    port.query(Q, nn=5, p_work=0.3)
    assert sorted(sizes) == [port.n_anchors + len(Q), len(X) + len(Q)]
    assert port.metric.batch._pair_enc is None


# ---------------------------------------------------------------------------
# the port's copies of the JAX package's query examples
# (tests/test_examples.py:32-77 and :266-300)


@pytest.fixture(scope="module")
def fitted_blobs(blobs):
    X, y = blobs
    ann = att.Annchor(X, "euclidean", n_anchors=15, n_neighbors=15, p_work=0.2,
                      random_seed=42, device="cpu")
    ann.fit()
    return ann, X, y


def test_query_recall(fitted_blobs, rng):
    ann, X, y = fitted_blobs
    Q = X[:100] + rng.normal(scale=0.05, size=(100, 2))
    ngi, ngd = ann.query(Q, nn=15, p_work=0.3)
    # nn + 1 columns: the reference's quirk (query_functions.py:210)
    assert ngi.shape == (100, 16)
    errs, total = 0, 0
    for qi in range(0, 100, 4):
        d = np.linalg.norm(X - Q[qi], axis=1)
        exact = np.argsort(d)[:10]
        errs += len(np.setdiff1d(exact, ngi[qi]))
        total += 10
    assert 1 - errs / total >= 0.99


def test_query_label_accuracy(fitted_blobs, rng):
    """1-NN label prediction through query matches the exact 15-NN vote
    within 0.02 (reference test_examples.py:50-58)."""
    from collections import Counter

    ann, X, y = fitted_blobs
    Q = X[200:300] + rng.normal(scale=0.05, size=(100, 2))
    ngi, _ = ann.query(Q, nn=15, p_work=0.3)
    pred = np.array([Counter(y[ngi[i]]).most_common(1)[0][0] for i in range(100)])
    D = np.linalg.norm(Q[:, None] - X[None], axis=2)
    exact_i = np.argsort(D, axis=1)[:, :15]
    exact_pred = np.array(
        [Counter(y[exact_i[i]]).most_common(1)[0][0] for i in range(100)]
    )
    exact_acc = np.mean(exact_pred == y[200:300])
    assert np.mean(pred == y[200:300]) >= exact_acc - 0.02


def test_query_p_work_floor(fitted_blobs, capsys):
    ann, X, _ = fitted_blobs
    ann.query(X[:5], nn=15, p_work=1e-6)
    assert "p_work too low" in capsys.readouterr().out


def test_legacy_query(fitted_blobs, rng):
    """The landmark-descent legacy query: top 5 against the exact oracle
    on well-separated data, with the metric's true distances."""
    ann, X, y = fitted_blobs
    Q = X[50:70] + rng.normal(scale=0.02, size=(20, 2))
    ngi, ngd = ann.legacy_query(Q, k=5)
    assert ngi.shape == (20, 5)
    D = np.linalg.norm(Q[:, None] - X[None], axis=2)
    exact = np.argsort(D, axis=1)[:, :5]
    overlap = np.mean([len(set(ngi[i]) & set(exact[i])) / 5 for i in range(20)])
    assert overlap >= 0.9
    np.testing.assert_allclose(ngd, np.take_along_axis(D, ngi, axis=1), rtol=1e-3,
                               atol=1e-5)


def test_legacy_query_batched_scales(fitted_blobs, rng):
    """nq = 1000 through the chunked profile match and one exact head
    batch, in seconds."""
    import time

    ann, X, y = fitted_blobs
    nq = 1000
    ids = rng.integers(0, len(X), size=nq)
    Q = X[ids] + rng.normal(scale=0.01, size=(nq, 2))
    t0 = time.time()
    ngi, ngd = ann.legacy_query(Q, k=5)
    wall = time.time() - t0
    assert ngi.shape == (nq, 5) and ngd.shape == (nq, 5)
    assert (ngi[:, 0] == ids).mean() > 0.95
    assert (np.diff(ngd, axis=1) >= 0).all()
    assert wall < 60
