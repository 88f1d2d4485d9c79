"""The query path's tensor predict (``query.predict_query_pairs``) on the
CPU: the default strategies' ``predict_tensor`` against their numpy
``predict`` and ``np.clip``, bit for bit, on random feature rows placed
on and beyond the bin edges, on a fit with an empty bin and on the real
candidate features of fitted strings and Wasserstein indexes; and whole
queries through the tensor predict against the same calls through the
host predict of a strategy subclass that overrides ``predict``."""

import copy
import types

import numpy as np
import pytest
import torch

import annchor_tpu_torch as att
from annchor_tpu_torch import query as tquery
from annchor_tpu_torch.annchor import FEATURE_NAMES
from annchor_tpu_torch.datasets import digit_images, grid_cost_matrix, make_strings
from annchor_tpu_torch.error_predictors import SimpleStratifiedErrorRegression
from annchor_tpu_torch.ops.locality import query_candidates
from annchor_tpu_torch.regressors import SimpleStratifiedLinearRegression

torch.set_num_threads(2)


class _HostRegression(SimpleStratifiedLinearRegression):
    """The default regression with a ``predict`` of its own, so the query
    path keeps the host call."""

    def predict(self, features, feature_names):
        return super().predict(features, feature_names)


class _HostErrors(SimpleStratifiedErrorRegression):
    def predict(self, features, feature_names):
        return super().predict(features, feature_names)


def _host_twin(strategy, cls):
    twin = copy.copy(strategy)
    twin.__class__ = cls
    return twin


def _host(ann, F):
    """The host path as the query path ran it before the tensor predict:
    numpy ``predict``, ``np.clip`` to the bounds in metric spaces, the
    error tags."""
    names = ann.feature_names
    pred = ann.regression.predict(F, names)
    if ann.is_metric:
        pred = np.clip(pred, F[:, names.index("lower bound")], F[:, names.index("upper bound")])
    return pred, ann.error_predictor.predict(F, names)


def _on_edges(rng, F, col, edges):
    """Put a third of the rows' column ``col`` exactly on the edges (the
    interior ones and the outer finite ones), a sixth below the first and
    above the last."""
    m = F.shape[0]
    pick = rng.integers(0, edges.shape[0], m)
    where = rng.random(m)
    F[where < 1 / 3, col] = edges[pick[where < 1 / 3]]
    lo, hi = edges.min(), edges.max()
    span = max(hi - lo, 1.0)
    out = (where >= 1 / 3) & (where < 1 / 2)
    F[out, col] = np.where(rng.random(out.sum()) < 0.5, lo - span * rng.random(out.sum()),
                           hi + span * rng.random(out.sum()))


def _random_index(nf, empty_bin, metric, seed=7):
    """A stand-in index: strategies fitted on random rows (``nf``
    regression features; ``empty_bin`` gives the regression a bin no
    sample falls in, which falls back to the global fit) and random
    candidate features with values on and beyond the bins' edges."""
    rng = np.random.default_rng(seed)
    names = list(FEATURE_NAMES)
    n = 3000
    S = np.empty((n, 4))
    S[:, 0] = rng.uniform(0, 50, n)
    S[:, 1] = S[:, 0] + rng.uniform(0, 80, n)
    S[:, 2] = rng.gamma(2.0, 20.0, n)
    S[:, 3] = (rng.random(n) < 0.1).astype(np.float64)
    y = 0.3 * S[:, 0] + 0.6 * S[:, 1] + 0.1 * S[:, 2] + rng.normal(0, 3, n)
    reg = SimpleStratifiedLinearRegression(reg_feature_names=names[:nf])
    bins = None
    if empty_bin:
        q = np.quantile(S[:, 2], [0.2, 0.5, 0.8])
        # no sample lies between q[1] and the next sample above it
        above = S[:, 2][S[:, 2] > q[1]].min()
        bins = np.array([-np.inf, q[0], q[1], (q[1] + above) / 2, q[2], np.inf])
        assert not ((S[:, 2] > bins[2]) & (S[:, 2] <= bins[3])).any()
    reg.fit(S, names, y, sample_bins=bins)
    err = SimpleStratifiedErrorRegression()
    err.fit(S, names, y - reg.predict(S, names))
    m = 20000
    F = np.empty((m, 4))
    F[:, 0] = rng.uniform(0, 50, m) * 10.0 ** rng.integers(-3, 4, m)
    F[:, 1] = F[:, 0] + rng.uniform(0, 80, m) * 10.0 ** rng.integers(-3, 4, m)
    F[:, 2] = rng.gamma(2.0, 20.0, m)
    F[:, 3] = (rng.random(m) < 0.1).astype(np.float64)
    _on_edges(rng, F, 2, np.concatenate([reg.sample_bins[1:-1], err.partition_bins[1:-1]]))
    if empty_bin:
        inside = rng.random(m) < 0.2
        F[inside, 2] = rng.uniform(bins[2], bins[3], inside.sum())
    ann = types.SimpleNamespace(regression=reg, error_predictor=err, feature_names=names,
                                is_metric=metric)
    return ann, F


def _candidate_features(ann, Q):
    """The query path's candidate feature rows of ``Q`` on the index."""
    QD = tquery.get_query_anchor_dists(ann, Q, ann._get_exact_query_ijs_for(ann.f))
    check = query_candidates(ann._S_raw, QD, ann.locality, ann.loc_thresh, device=ann.device)
    return tquery.get_query_features(ann, Q, QD, check)[3].cpu().numpy()


def _strings_index(metric):
    X, _ = make_strings(n=180, length=30, seed=11)
    ann = att.Annchor(list(X[:150]), "levenshtein", n_anchors=8, n_neighbors=6, n_samples=300,
                      p_work=0.3, is_metric=metric, device="cpu")
    ann.fit()
    return ann, _candidate_features(ann, list(X[150:]))


def _digits_index():
    X, _ = digit_images()
    fk = {"cost_matrix": grid_cost_matrix(), "scout": "sinkhorn", "n_iter": 30}
    ann = att.Annchor(X[:120], "wasserstein", func_kwargs=fk, n_anchors=8, n_neighbors=6,
                      n_samples=400, p_work=0.3, device="cpu")
    ann.fit()
    return ann, _candidate_features(ann, X[120:150])


PREDICT_CASES = {
    "random_1_feature": lambda: _random_index(1, False, True),
    "random_2_features": lambda: _random_index(2, False, True),
    "random_3_features": lambda: _random_index(3, False, True),
    "random_4_features": lambda: _random_index(4, False, True),
    "random_3_features_non_metric": lambda: _random_index(3, False, False),
    "empty_bin": lambda: _random_index(3, True, True),
    "strings_index": lambda: _strings_index(True),
    "strings_index_non_metric": lambda: _strings_index(False),
    "wasserstein_index": _digits_index,
}


@pytest.mark.parametrize("case", list(PREDICT_CASES))
def test_tensor_predict_is_the_numpy_predict(case):
    """The tensor predict, clip and error tags equal the numpy path's
    bit for bit (the dot product in ``np.einsum``'s order: a numpy build
    that sums otherwise fails here)."""
    ann, F = PREDICT_CASES[case]()
    assert F.shape[0] > 0 and F.dtype == np.float64
    want_pred, want_err = _host(ann, F)
    pred, err, on_card = tquery.predict_query_pairs(ann, torch.as_tensor(F))
    assert on_card
    assert isinstance(pred, torch.Tensor) and pred.dtype == torch.float64
    assert isinstance(err, torch.Tensor) and err.dtype == torch.int64
    pred, err = pred.numpy(), err.numpy()
    assert pred.tobytes() == want_pred.tobytes()
    assert err.dtype == want_err.dtype and np.array_equal(err, want_err)
    # the case reaches what it names
    edges = ann.regression.sample_bins[1:-1]
    tags = np.searchsorted(edges, F[:, 2])
    assert np.unique(tags).shape[0] > 1
    if case.startswith("random") or case == "empty_bin":
        assert np.unique(tags).shape[0] == ann.regression.n_partitions
        assert np.isin(F[:, 2], edges).sum() > 100
        assert (F[:, 2] < edges[0]).any() and (F[:, 2] > edges[-1]).any()
    if case == "empty_bin":
        assert (tags == 2).sum() > 1000
    if ann.is_metric:
        raw = ann.regression.predict(F, ann.feature_names)
        assert (raw < F[:, 0]).any() or (raw > F[:, 1]).any()


def test_a_subclass_that_overrides_predict_keeps_the_host_call():
    ann, F = _random_index(3, False, True)
    for attr, cls in (("regression", _HostRegression), ("error_predictor", _HostErrors)):
        host = copy.copy(ann)
        setattr(host, attr, _host_twin(getattr(ann, attr), cls))
        pred, err, on_card = tquery.predict_query_pairs(host, torch.as_tensor(F))
        assert not on_card and isinstance(pred, np.ndarray) and isinstance(err, np.ndarray)
        want_pred, want_err = _host(ann, F)
        assert pred.tobytes() == want_pred.tobytes() and np.array_equal(err, want_err)


def _recorded(geq, calls):
    def run(f, X, Z, IJ):
        calls.append(np.array(IJ))
        return geq(f, X, Z, IJ)

    return run


@pytest.mark.parametrize("which", ["strings", "strings_non_metric", "wasserstein"])
def test_query_through_the_tensor_predict_matches_the_host_predict(which, monkeypatch):
    """Same index, same queries: the default strategies' call and the call
    with host-predict subclasses return the same graph after the same
    metric calls, pair for pair."""
    if which == "wasserstein":
        ann, _ = _digits_index()
        Q = digit_images()[0][120:150]
    else:
        ann, _ = _strings_index(which == "strings")
        Q = list(make_strings(n=180, length=30, seed=11)[0][150:])
    outs, calls = [], []
    geq = ann._get_exact_query_ijs_for(ann.f)
    for host in (False, True):
        if host:
            monkeypatch.setattr(ann, "regression", _host_twin(ann.regression, _HostRegression))
            monkeypatch.setattr(ann, "error_predictor",
                                _host_twin(ann.error_predictor, _HostErrors))
        calls.append([])
        if which == "wasserstein":
            # the hybrid's walk asks its scout
            monkeypatch.setattr(ann.metric, "scout", _scout_recorder(ann.metric.scout, calls[-1]))
        outs.append(ann.query(Q, nn=5, p_work=0.3) if which == "wasserstein" else
                    ann.query(Q, nn=5, p_work=0.3, get_exact_query_ijs=_recorded(geq, calls[-1])))
        monkeypatch.undo()
    for got, want in zip(outs[1], outs[0]):
        assert got.tobytes() == want.tobytes()
    assert len(calls[0]) == len(calls[1]) > 0
    for got, want in zip(calls[1], calls[0]):
        np.testing.assert_array_equal(got, want)


def _scout_recorder(scout, calls):
    def run(X, Z, IJ):
        calls.append(np.array(IJ))
        return scout(X, Z, IJ)

    return run
