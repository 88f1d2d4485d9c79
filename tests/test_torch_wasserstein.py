"""The Wasserstein metrics of the port on the CPU, held against the JAX
package: the exact EMD solver, the Sinkhorn engines, the scout/certify
hybrid fit and its query.

Tolerances: the exact EMD solver is the JAX package's C++ built with the
same flags, so its values are bit-equal.  The Sinkhorn engines compute
in float32 in both packages, but XLA:CPU accumulates each 64-term
matrix-vector product in float32 in its own order, while the port rounds
the float64 sum of the exact products once (ops/wasserstein.py): over
the iterations the two drift apart by a few float32 ulps, so values must
agree to rtol 2e-6 (the largest difference seen on the digits is
2.4e-7 in the exp domain and 7.7e-7 in the log domain).  Hybrid fits
report exact distances, which must match the exact EMD to 1e-9.
"""

import numpy as np
import pytest
import torch

import annchor_tpu as at
import annchor_tpu_torch as att
from annchor_tpu import native as jax_native
from annchor_tpu.ops import wasserstein as jw
from annchor_tpu_torch import native
from annchor_tpu_torch.datasets import digit_images, grid_cost_matrix
from annchor_tpu_torch.ops import wasserstein as tw
from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms
from annchor_tpu_torch.ops.locality import candidate_pairs

torch.set_num_threads(2)

RTOL = 2e-6


@pytest.fixture(scope="module")
def digits():
    X, y = digit_images()
    return X, y, grid_cost_matrix()


def _pairs(rng, n, m):
    return rng.integers(0, n, size=(m, 2)).astype(np.int64)


def test_digit_images_equal_sklearn():
    from sklearn.datasets import load_digits

    X, y = digit_images()
    d = load_digits()
    np.testing.assert_array_equal(X, d.data)
    np.testing.assert_array_equal(y, d.target)


def test_emd_batch_bit_equal_to_jax(digits):
    X, _, M = digits
    rng = np.random.default_rng(0)
    IJ = _pairs(rng, len(X), 3000)
    got = native.emd_batch(X, X, M, IJ[:, 0], IJ[:, 1])
    np.testing.assert_array_equal(
        got, jax_native.emd_batch(X, X, M, IJ[:, 0], IJ[:, 1]))
    for i, j in IJ[:20]:
        assert native.emd_single(X[i], X[j], M) == jax_native.emd_single(X[i], X[j], M)
        # the independent solver agrees to rounding
        assert native.emd_single_ssp(X[i], X[j], M) == pytest.approx(
            native.emd_single(X[i], X[j], M), abs=1e-9)
    with pytest.raises(ValueError, match="out of range"):
        native.emd_batch(X, X, M, [0], [len(X)])
    with pytest.raises(ValueError, match="bins"):
        native.emd_batch(np.ones((2, 32768)), np.ones((2, 32768)), np.zeros((1, 1)),
                         [0], [1])


def test_sinkhorn_exp_chunk_matches_jax(digits):
    X, _, M = digits
    X = X[:400]
    rng = np.random.default_rng(1)
    IJ = _pairs(rng, len(X), 700)
    eng = tw.SinkhornExpEngine(M, n_iter=120, chunk=256, device="cpu")
    jeng = jw.SinkhornExpEngine(M, n_iter=120)
    want = np.asarray(jw._sinkhorn_exp_chunk(
        jeng._table(X), jeng._table(X), IJ[:, 0].astype(np.int32),
        IJ[:, 1].astype(np.int32), jeng._Kd, jeng._KCd, 120))
    got = eng(X, X, IJ)  # three chunks
    np.testing.assert_allclose(got, want, rtol=RTOL)
    dev, m = eng.dispatch(X, X, IJ)
    assert m == 700 and dev.dtype == torch.float32
    np.testing.assert_array_equal(dev.numpy(), got.astype(np.float32))
    np.testing.assert_array_equal(
        eng.batch_dev(X, torch.as_tensor(IJ[:, 0]), torch.as_tensor(IJ[:, 1])).numpy(),
        dev.numpy())
    assert eng.dispatch(X, X, np.zeros((0, 2))) == (None, 0)
    assert eng(X, X, np.zeros((0, 2))).shape == (0,)


def test_sinkhorn_maxmin_matches_jax(digits):
    X, _, M = digits
    X = X[:500]
    eng = tw.SinkhornExpEngine(M, n_iter=80, device="cpu")
    jeng = jw.SinkhornExpEngine(M, n_iter=80)
    A, D = eng.fused_maxmin(X, 12, 7)
    jA, jD = jeng.fused_maxmin(X, 12, 7)
    np.testing.assert_array_equal(A, jA)
    np.testing.assert_allclose(D, jD, rtol=RTOL, atol=1e-7)


def test_sinkhorn_batch_matches_jax(digits):
    X, _, M = digits
    rng = np.random.default_rng(2)
    IJ = _pairs(rng, len(X), 150)
    Xn = tw.unit_mass(X)
    eps = float(np.float32(0.02 * M.max()))
    A, B = Xn[IJ[:, 0]], Xn[IJ[:, 1]]
    want = np.asarray(jw._sinkhorn_batch(A, B, M.astype(np.float32), np.float32(eps), 60))
    got = tw.sinkhorn_batch(torch.from_numpy(A), torch.from_numpy(B),
                            torch.from_numpy(M.astype(np.float32)), eps, 60).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    eng = tw.SinkhornEngine(M, n_iter=60, chunk=64, device="cpu")
    np.testing.assert_allclose(eng(X, X, IJ), jw.SinkhornEngine(M, n_iter=60)(X, X, IJ),
                               rtol=RTOL)


def test_sinkhorn_exp_eps_guard():
    M = grid_cost_matrix()
    with pytest.raises(ValueError, match="eps too small"):
        tw.SinkhornExpEngine(M, eps=0.001, device="cpu")
    tw.SinkhornExpEngine(M, eps=0.013, device="cpu")  # max(C)/eps = 77 < 80


def test_metrics_resolve(digits):
    X, _, M = digits
    m = att.get_function_from_input("wasserstein", {"cost_matrix": M}, device="cpu")
    assert m.scout is None and m.is_metric
    assert m(X[0], X[1]) == jax_native.emd_single(X[0], X[1], M)
    h = att.get_function_from_input(
        "wasserstein", {"cost_matrix": M, "scout": "sinkhorn", "n_iter": 40}, device="cpu")
    assert isinstance(h.scout, tw.SinkhornExpEngine) and h.scout.n_iter == 40
    s = att.get_function_from_input(
        "wasserstein_sinkhorn", {"cost_matrix": M, "n_iter": 30}, device="cpu")
    assert not s.is_metric and isinstance(s.batch, tw.SinkhornEngine)
    want = at.get_function_from_input("wasserstein_sinkhorn", {"cost_matrix": M, "n_iter": 30})
    assert s(X[0], X[5]) == pytest.approx(want(X[0], X[5]), rel=RTOL)
    for name in ("wasserstein", "wasserstein_sinkhorn"):
        with pytest.raises(AssertionError, match="cost_matrix"):
            att.get_function_from_input(name, device="cpu")


def test_user_evaluator_beats_scout(digits):
    """A user get_exact_ijs wins over the scout (the plug-in contract,
    reference annchor.py:77-82)."""
    X, _, M = digits
    calls = []

    def mine(f, X_, IJ):
        calls.append(len(IJ))
        return np.array([f(X_[i], X_[j]) for i, j in IJ])

    ann = att.Annchor(X[:60], "wasserstein",
                      func_kwargs={"cost_matrix": M, "scout": "sinkhorn"},
                      n_anchors=5, n_neighbors=5, n_samples=200, p_work=0.5,
                      get_exact_ijs=mine, device="cpu")
    assert not ann._scouting and ann.is_metric
    assert len(calls) > 0


HYBRID_KW = dict(n_anchors=15, n_neighbors=10, n_samples=600, p_work=0.3, random_seed=42)


@pytest.fixture(scope="module")
def hybrid_fits(digits):
    """A hybrid fit on 150 digits (scout n_iter cut to 50) in both
    packages, the port drawing the JAX package's samples, and the exact
    EMD distance matrix."""
    X, _, M = digits
    X = X[:150]
    fk = {"cost_matrix": M, "scout": "sinkhorn", "n_iter": 50}
    ref = at.Annchor(X, "wasserstein", func_kwargs=fk, **HYBRID_KW)
    ref.fit()
    port = att.Annchor(X, "wasserstein", func_kwargs=fk, device="cpu",
                       uniforms=jax_threefry_uniforms, **HYBRID_KW)
    port.fit()
    bf = att.BruteForce(X, "wasserstein", func_kwargs={"cost_matrix": M}, device="cpu")
    bf.fit()
    return ref, port, bf, X, M


def test_hybrid_fit_matches_jax(hybrid_fits):
    ref, port, bf, X, _ = hybrid_fits
    k = HYBRID_KW["n_neighbors"]
    assert port._scouting and not port.is_metric
    np.testing.assert_array_equal(port.A, ref.A)
    err = att.compare_neighbor_graphs(bf.neighbor_graph, port.neighbor_graph, k)
    assert err <= at.compare_neighbor_graphs(bf.neighbor_graph, ref.neighbor_graph, k)
    # every reported distance is exact
    ngi, ngd = port.neighbor_graph
    np.testing.assert_allclose(ngd, bf.D[np.arange(len(X))[:, None], ngi], atol=1e-9)
    assert port._ng_exact.all()
    # the exact calls are the certification only
    assert 0 < port.evals < 0.35 * port.scout_evals
    assert (port.evals, port.scout_evals) == (ref.evals, ref.scout_evals)


def test_hybrid_query_matches_jax(hybrid_fits, digits):
    """The query's scout branch: exploration on the scout, the reported
    rows certified exactly, as in the JAX package."""
    ref, port, _, X, M = hybrid_fits
    Xall = digits[0]
    Q = Xall[150:190]
    got = port.query(Q, nn=6, p_work=0.4)
    want = ref.query(Q, nn=6, p_work=0.4)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    D = native.emd_batch(X, Q, M, got[0].reshape(-1), np.repeat(np.arange(len(Q)), 7))
    np.testing.assert_allclose(got[1].reshape(-1), D, atol=1e-9)


def test_hybrid_refine_certifies_with_exact_metric(hybrid_fits):
    """Refinement after a hybrid fit spends exact calls, never the
    scout's."""
    _, port, bf, X, _ = hybrid_fits
    scout0, evals0 = port.scout_evals, port.evals
    gi, gd = port.refine_neighbor_graph(rounds=1, budget=300)
    assert port.scout_evals == scout0 and port.evals > evals0
    np.testing.assert_allclose(gd, bf.D[np.arange(len(X))[:, None], gi], atol=1e-9)


def test_certify_graph_expansion_recovers_scout_misranks():
    """Port of tests/test_hybrid.py::test_certify_graph_expansion_recovers_
    scout_misranks: a scout whose deterministic per-pair noise buries some
    true neighbours deep in its ranking still yields the exact graph
    through the certify expansion; without it the same fit leaves
    errors."""
    rng = np.random.default_rng(1234)
    X = rng.normal(size=(300, 4))
    X[150:] += 3.0
    base = att.get_function_from_input("euclidean", device="cpu")

    def noisy_scout(Xa, Za, IJ):
        IJ = np.asarray(IJ)
        d = np.asarray(base.batch(Xa, Za, IJ), dtype=np.float64)
        i, j = IJ[:, 0], IJ[:, 1]
        return d + 0.3 * np.sin(0.7 * (i + j) + 0.13 * ((i * j) % 97))

    def build(expand_rounds):
        m = att.Metric(base.scalar, base.batch, name="euclid_noisy", scout=noisy_scout)
        ann = att.Annchor(X, m, n_anchors=15, n_neighbors=10, p_work=0.3,
                          random_seed=42, device="cpu")
        ann.certify_pad = 2
        ann.certify_expand_rounds = expand_rounds
        ann.fit()
        return ann

    bf = att.BruteForce(X, "euclidean", device="cpu")
    bf.fit()
    err0 = att.compare_neighbor_graphs(bf.neighbor_graph, build(0).neighbor_graph, 10)
    ann2 = build(2)
    err2 = att.compare_neighbor_graphs(bf.neighbor_graph, ann2.neighbor_graph, 10)
    assert err0 > 0
    assert err2 == 0
    assert ann2.evals < 0.5 * (300 * 299) // 2


def _certify_index(port, cap, rounds, log):
    """A stand-in index for either package's ``Annchor._certify``: 2,000
    points whose exact metric is the distance in a random 6-d embedding,
    and a scout that misranks it by up to 2 %, so the expansion admits
    pairs; every exact batch is appended to ``log``."""
    from types import SimpleNamespace

    emb = np.random.default_rng(3).normal(size=(2000, 6))

    def exact(IJ):
        IJ = np.array(IJ)
        log.append(IJ)
        return np.linalg.norm(emb[IJ[:, 0]] - emb[IJ[:, 1]], axis=1)

    def scout(IJ):
        IJ = np.asarray(IJ)
        d = np.linalg.norm(emb[IJ[:, 0]] - emb[IJ[:, 1]], axis=1)
        return d * (1 + 0.02 * np.sin(7.0 * IJ[:, 0] + IJ[:, 1]))

    idx = SimpleNamespace(n_neighbors=16, metric=SimpleNamespace(scout=object()),
                          _eval_pairs=scout, certify_expand_cap=cap,
                          certify_expand_rounds=rounds, evals=0, scout_evals=0,
                          X=None, f=None)
    if port:
        idx._exact_pairs = exact
        idx.device = torch.device("cpu")
    else:
        idx._exact_eval = lambda f, X, IJ: exact(IJ)
    return idx


@pytest.mark.parametrize("cap", [None, 500])
@pytest.mark.parametrize("rounds", [1, 2])
def test_certify_matches_jax(rounds, cap):
    """The port's certify, whose set operations and row ranking are torch
    ops on ``ann.device``, against the JAX package's numpy on the same
    candidate lists: bit-equal rows and the same exact evaluations, batch
    for batch and pair for pair."""
    emb = np.random.default_rng(3).normal(size=(2000, 6))
    noisy = emb + 0.3 * np.random.default_rng(4).normal(size=emb.shape)
    d2 = ((noisy[:, None, :] - noisy[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, -np.inf)
    ngi = np.argsort(d2, axis=1, kind="stable")[:, 1:24]
    logs = {True: [], False: []}
    want = at.Annchor._certify(_certify_index(False, cap, rounds, logs[False]), ngi,
                               np.zeros(ngi.shape))
    got = att.Annchor._certify(_certify_index(True, cap, rounds, logs[True]), ngi,
                               np.zeros(ngi.shape))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
    assert len(logs[True]) == len(logs[False]) == 1 + rounds
    for g, w in zip(logs[True], logs[False]):
        np.testing.assert_array_equal(g, w)


def test_pure_sinkhorn_graph_recall(digits):
    """Port of tests/test_hybrid.py::test_pure_sinkhorn_graph_recall at 150
    digits: the wasserstein_sinkhorn fit keeps >= 0.9 of the exact
    neighbour sets."""
    X, _, M = digits
    X = X[:150]
    k = 8
    exact = att.exact_knn(X, "wasserstein", {"cost_matrix": M}, k=k, device="cpu")[0]
    ann = att.Annchor(X, "wasserstein_sinkhorn", func_kwargs={"cost_matrix": M, "n_iter": 30},
                      n_anchors=12, n_neighbors=k, n_samples=400, p_work=0.25,
                      random_seed=42, device="cpu")
    assert not ann.is_metric
    ann.fit()
    got = ann.neighbor_graph[0][:, :k]
    hits = sum(len(np.intersect1d(exact[i], got[i])) for i in range(len(X)))
    assert hits / (k * len(X)) >= 0.9


def test_hybrid_scale_path_waits_for_item_15(digits, monkeypatch):
    """A hybrid fit is non-metric, so on the scale path it takes the
    admit-everything build, with the pairs of the host build."""
    X, _, M = digits
    monkeypatch.setenv("ANNCHOR_TPU_FORCE_SPARSE", "1")
    ann = att.Annchor(X[:120], "wasserstein",
                      func_kwargs={"cost_matrix": M, "scout": "sinkhorn", "n_iter": 20},
                      n_anchors=6, n_neighbors=5, device="cpu")
    ann.get_anchors()
    ann.get_locality()
    assert ann._locality_info["build"] == "admit"
    IJs = candidate_pairs(ann.D, ann.locality, ann.loc_thresh, ann.loc_min, "cpu")[0]
    np.testing.assert_array_equal(ann.IJs, IJs)
