"""Whole fits of the port, on the CPU, held against the JAX package and
against the reference's accuracy budget.

With JAX's sample uniforms injected, a fit of the port must pick the
same anchors and candidate pairs, spend the same number of metric
evaluations and report the same k-NN graph as the JAX fit.
"""

import json
import os

import numpy as np
import pytest
import torch

import annchor_tpu as at
import annchor_tpu_torch as att
from annchor_tpu.datasets import make_strings as jax_make_strings
from annchor_tpu_torch.datasets import load_strings, make_strings
from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms
from annchor_tpu_torch.ops.locality import candidate_pairs

torch.set_num_threads(2)


def _jax_uniforms(random_seed, loop_num, m, device):
    """The JAX package's sample-draw stream, handed over as numpy."""
    import jax
    import jax.numpy as jnp

    key = jax.random.fold_in(jax.random.PRNGKey(random_seed), loop_num)
    r = np.array(jax.random.uniform(key, (m,), dtype=jnp.float32))
    return torch.as_tensor(r, device=device)


@pytest.fixture(scope="module")
def fits():
    X, _ = make_strings(n=300, length=60, seed=7)
    kw = dict(n_anchors=12, n_neighbors=10, n_samples=800, p_work=0.3)
    ref = at.Annchor(list(X), "levenshtein", **kw)
    ref.fit()
    port = att.Annchor(
        list(X), "levenshtein", device="cpu", uniforms=_jax_uniforms, **kw
    )
    port.fit()
    return ref, port, ref._dev, port._dev  # the states, kept past host reads


def test_fit_matches_jax_anchors_and_pairs(fits):
    ref, port = fits[:2]
    np.testing.assert_array_equal(port.A, ref.A)
    np.testing.assert_array_equal(port.D, ref.D)
    np.testing.assert_array_equal(port.IJs, ref.IJs)


def test_fit_matches_jax_evals_and_graph(fits):
    ref, port = fits[:2]
    assert port.evals == ref.evals
    assert att.compare_neighbor_graphs(port.neighbor_graph, ref.neighbor_graph, 10) == 0
    np.testing.assert_array_equal(port.neighbor_graph[0], ref.neighbor_graph[0])


def test_fit_matches_jax_state(fits):
    """Same computed pairs; features bit-equal; estimates within the
    regression predict's FMA ulps (see tests/test_torch_pipeline.py)."""
    ref, port = fits[:2]
    np.testing.assert_array_equal(port.not_computed_mask, ref.not_computed_mask)
    np.testing.assert_array_equal(port.features, ref.features)
    ra_ref = ref.RefineApprox.astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(ra_ref), 1.0))
    assert np.all(np.abs(port.RefineApprox.astype(np.float32) - ra_ref) <= 4 * ulp)


def test_fit_matches_jax_exact_store(fits):
    """The dense fit keeps its exact values in the exact store: the JAX
    state's computed pairs (its m-sized mirror's non-NaN entries), with
    their values."""
    jdev, tdev = fits[2:]
    assert not tdev.sparse
    jdev._flush_exacts()
    tdev._flush_exacts()
    want = np.flatnonzero(~np.isnan(jdev.exact64))
    np.testing.assert_array_equal(tdev.exact.ids, want)
    np.testing.assert_array_equal(tdev.exact.vals, jdev.exact64[want])


def test_strings_levenshtein_budget():
    """Port copy of tests/test_annchor.py::test_strings_levenshtein_budget
    with the port's own torch generator: same set, knobs and budgets."""
    X, _ = make_strings(n=400, length=60, seed=1)
    bf = att.BruteForce(list(X), "levenshtein", device="cpu")
    bf.fit()
    ann = att.Annchor(
        list(X),
        "levenshtein",
        n_anchors=15,
        n_neighbors=15,
        n_samples=1000,
        p_work=0.15,
        niters=4,
        random_seed=42,
        device="cpu",
    )
    ann.fit()
    err = att.compare_neighbor_graphs(bf.neighbor_graph, ann.neighbor_graph, 15)
    assert err < 80
    assert ann.evals <= 1.4 * ann.p_work * ann.N + 2 * ann.n_samples


def test_bruteforce_matches_jax():
    X, _ = make_strings(n=120, length=30, seed=4)
    bf_t = att.BruteForce(list(X), "levenshtein", device="cpu")
    bf_t.fit()
    bf_j = at.BruteForce(list(X), "levenshtein")
    bf_j.fit()
    np.testing.assert_array_equal(bf_t.D, bf_j.D)
    np.testing.assert_array_equal(bf_t.neighbor_graph[0], bf_j.neighbor_graph[0])


def test_compare_neighbor_graphs_matches_jax():
    rng = np.random.default_rng(8)
    ngd = np.sort(rng.integers(0, 30, size=(50, 12)).astype(float), axis=1)
    ngi = np.argsort(rng.random((50, 12)), axis=1)
    bad = ngd.copy()
    bad[:17, 4] += 100.0
    for a, b in [((ngi, ngd), (ngi, ngd)), ((ngi, bad), (ngi, ngd)), ((ngi, ngd), (ngi, bad[:30]))]:
        assert att.compare_neighbor_graphs(a, b, 10) == at.compare_neighbor_graphs(a, b, 10)
    assert att.compare_neighbor_graphs((ngi, bad), (ngi, ngd), 10) == 17


def test_pickers_match_jax():
    X, _ = make_strings(n=80, length=30, seed=6)
    for Picker, args in [
        ("MaxMinAnchorPicker", ()),
        ("RandomAnchorPicker", ()),
        ("SelectedAnchorPicker", ([3, 9, 40],)),
        ("ExternalAnchorPicker", (["ACGTTGCA" * 3, "GATTACA" * 4, "TTTT"],)),
    ]:
        kw = dict(n_anchors=3, n_neighbors=5, n_samples=200, p_work=0.5)
        a = at.Annchor(list(X), "levenshtein", anchor_picker=getattr(at, Picker)(*args), **kw)
        b = att.Annchor(
            list(X), "levenshtein", anchor_picker=getattr(att, Picker)(*args),
            device="cpu", **kw,
        )
        a.get_anchors()
        b.get_anchors()
        np.testing.assert_array_equal(np.asarray(b.A), np.asarray(a.A))
        np.testing.assert_array_equal(b.D, a.D)
        assert a.evals == b.evals


def test_make_strings_matches_jax():
    a, ya = make_strings(n=50, length=20, seed=3, evolve=True)
    b, yb = jax_make_strings(n=50, length=20, seed=3, evolve=True)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ya, yb)


def test_load_strings_caches_bruteforce_graph(tmp_path, monkeypatch):
    import annchor_tpu_torch.datasets as ds

    small = make_strings(n=40, length=20, seed=2)
    monkeypatch.setattr(ds, "make_strings", lambda: small)
    first = load_strings(k=10, device="cpu", cache_dir=str(tmp_path))
    assert (tmp_path / "strings_gt_synth.npz").exists()
    bf = att.BruteForce(list(small[0]), "levenshtein", device="cpu")
    bf.fit()
    np.testing.assert_array_equal(first["neighbor_graph"][1], bf.neighbor_graph[1][:, :10])
    again = load_strings(k=5, device="cpu", cache_dir=str(tmp_path))
    np.testing.assert_array_equal(again["neighbor_graph"][0], first["neighbor_graph"][0][:, :5])


def test_unported_paths_raise(monkeypatch):
    """Custom strategy objects take the host pipeline and nx > 4096 the
    scale path.  The paths earlier slices left raising now run: custom
    strategy objects above 4,096 points (the blocked host pair build),
    non-metric and hybrid fits on the scale path and
    ANNCHOR_TPU_NO_PAIR_BUDGET (the admit-everything build), the rms
    score (the budgeted build); none raises NotImplementedError."""
    X, _ = make_strings(n=60, length=20, seed=1)
    ann = att.Annchor(
        list(X), "levenshtein", n_anchors=3, n_neighbors=5, n_samples=100,
        p_work=0.5, sampler=att.SimpleStratifiedSampler(n_partitions=5),
        device="cpu",
    )
    ann.sampler = type("Custom", (att.SimpleStratifiedSampler,), {})()
    ann.fit()
    assert ann._dev is None and ann.neighbor_graph[0].shape == (60, 5)

    B, _ = make_strings(n=4100, n_clusters=16, length=12, mutation_rate=0.3, seed=1,
                        evolve=True)
    big = att.Annchor(list(B), "levenshtein", device="cpu")
    assert big.n_anchors == 48 and big.refine_frac == 0.05
    big.sampler = type("Custom", (att.SimpleStratifiedSampler,), {})()
    big.get_anchors()
    big.get_locality()
    assert big._ij_dev is None and big.P_idx.shape[0] == 4100
    np.testing.assert_array_equal(
        big.IJs, candidate_pairs(big.D, big.locality, big.loc_thresh, big.loc_min, "cpu",
                                 block=10**4)[0])

    monkeypatch.setenv("ANNCHOR_TPU_FORCE_SPARSE", "1")
    for kw, env, build in [
        ({"is_metric": False}, {}, "admit"),
        ({}, {"ANNCHOR_TPU_NO_PAIR_BUDGET": "1"}, "admit"),
        ({}, {"ANNCHOR_TPU_BUILD_SCORE": "rms"}, "budgeted"),
    ]:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        ann = att.Annchor(list(X), "levenshtein", n_anchors=3, n_neighbors=5,
                          device="cpu", **kw)
        ann.get_anchors()
        ann.get_locality()
        assert ann._locality_info["build"] == build and ann._ij_dev[2] > 0
        for k in env:
            monkeypatch.delenv(k)
    # a hybrid fit is non-metric: on the scale path it takes the
    # admit-everything build
    hist = np.random.default_rng(0).integers(0, 5, size=(60, 4))
    hybrid = att.Annchor(hist, "wasserstein", n_anchors=3, n_neighbors=5, device="cpu",
                         func_kwargs={"cost_matrix": 1.0 - np.eye(4), "scout": "sinkhorn",
                                      "n_iter": 10})
    assert hybrid._scouting and not hybrid.is_metric
    hybrid.get_anchors()
    hybrid.get_locality()
    assert hybrid._locality_info["build"] == "admit"


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        att.Annchor(["ab", "abc", "b"], "levenshtein")


def test_tiny_dataset_exact_graph():
    """Data sets below the sampler's floor evaluate the remaining pool
    outright on the first iteration (port of tests/test_annchor.py::
    test_tiny_dataset_exact_graph): the graph comes out exact."""
    rng = np.random.default_rng(0)
    for n, na, k in [(4, 2, 2), (12, 5, 3)]:
        X = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(5, 15)))) for _ in range(n)]
        ann = att.Annchor(X, "levenshtein", n_anchors=na, n_neighbors=k, device="cpu")
        ann.fit()
        bf = att.BruteForce(X, "levenshtein", device="cpu")
        bf.fit()
        assert att.compare_neighbor_graphs(bf.neighbor_graph, ann.neighbor_graph, k) == 0
        assert not ann.not_computed_mask.any()


def test_user_evaluator_fit_matches_jax():
    """A user get_exact_ijs takes the host hops (the max-min host loop,
    host sample and refinement evals) in both packages."""
    X, _ = make_strings(n=150, length=40, seed=9)
    engine = att.get_function_from_input("levenshtein", device="cpu").batch
    calls = []

    def user_eval(f, X, IJ):
        calls.append(len(IJ))
        return engine(X, X, np.asarray(IJ))

    kw = dict(n_anchors=8, n_neighbors=8, n_samples=400, p_work=0.3,
              get_exact_ijs=user_eval)
    ref = at.Annchor(list(X), "levenshtein", **kw)
    ref.fit()
    n_ref_calls = len(calls)
    port = att.Annchor(
        list(X), "levenshtein", device="cpu", uniforms=_jax_uniforms, **kw
    )
    port.fit()
    assert port._dev_eval is None
    assert len(calls) == 2 * n_ref_calls
    np.testing.assert_array_equal(port.A, ref.A)
    assert port.evals == ref.evals
    assert att.compare_neighbor_graphs(port.neighbor_graph, ref.neighbor_graph, 8) == 0


# ---------------------------------------------------------------------------
# the host pipeline (custom strategy objects), vector and Python metrics


def _assert_same_graph(port, ref):
    """Same neighbour indices; distances within 8 float32 ulps (the
    vector engine's stated tolerance, tests/test_torch_metrics.py: XLA
    may contract the row sum into fused multiply-adds)."""
    np.testing.assert_array_equal(port.neighbor_graph[0], ref.neighbor_graph[0])
    want = ref.neighbor_graph[1]
    tol = 8 * np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(port.neighbor_graph[1] - want) <= tol)


class JaxHostSampler(at.SimpleStratifiedSampler):
    """A do-nothing subclass: sends the JAX package down its host
    pipeline."""


class HostSampler(att.SimpleStratifiedSampler):
    """The same for the port."""


@pytest.fixture(scope="module")
def host_fits():
    X, _ = make_strings(n=300, length=60, seed=7)
    kw = dict(n_anchors=12, n_neighbors=10, n_samples=800, p_work=0.3)
    ref = at.Annchor(list(X), "levenshtein", sampler=JaxHostSampler(), **kw)
    ref.fit()
    port = att.Annchor(list(X), "levenshtein", sampler=HostSampler(), device="cpu", **kw)
    port.fit()
    return ref, port


def test_host_pipeline_matches_jax_bit_for_bit(host_fits):
    """Same anchors, pairs, evals, features, estimates, computed set and
    graph as the JAX package's host pipeline, bit for bit."""
    ref, port = host_fits
    assert port._dev is None and not port._device_pipeline_ok()
    np.testing.assert_array_equal(port.A, ref.A)
    np.testing.assert_array_equal(port.IJs, ref.IJs)
    assert port.evals == ref.evals
    np.testing.assert_array_equal(port.features, ref.features)
    np.testing.assert_array_equal(port.RefineApprox, ref.RefineApprox)
    np.testing.assert_array_equal(port.not_computed_mask, ref.not_computed_mask)
    np.testing.assert_array_equal(port.P_idx, ref.P_idx)
    np.testing.assert_array_equal(port.nextback, ref.nextback)
    np.testing.assert_array_equal(port.neighbor_graph[0], ref.neighbor_graph[0])
    np.testing.assert_array_equal(port.neighbor_graph[1], ref.neighbor_graph[1])


@pytest.fixture(scope="module")
def blobs_fits(blobs):
    X, _ = blobs
    kw = dict(n_anchors=10, p_work=0.05)
    port = att.Annchor(X, "euclidean", device="cpu", **kw)
    port.fit()
    ref = at.Annchor(X, "euclidean", **kw)
    ref.fit()
    bf = att.BruteForce(X, "euclidean", device="cpu")
    bf.fit()
    return port, ref, bf


def test_blobs_euclidean_exact(blobs_fits):
    """The reference's blobs contract (tests/test_annchor.py:87-99):
    0 errors, with exactly the JAX package's evals and graph."""
    port, ref, bf = blobs_fits
    assert port.evals == ref.evals
    assert att.compare_neighbor_graphs(bf.neighbor_graph, port.neighbor_graph, 15) == 0
    assert att.compare_neighbor_graphs(port.neighbor_graph, ref.neighbor_graph, 15) == 0


def test_blobs_python_closure_matches_jax(blobs):
    """An L1 closure, evaluated on host threads: with JAX's sample
    stream the fit spends the JAX package's evals on the same graph."""
    X, _ = blobs

    def l1(x, y):
        return float(np.abs(x - y).sum())

    kw = dict(n_anchors=10, p_work=0.05)
    port = att.Annchor(X, l1, device="cpu", uniforms=jax_threefry_uniforms, **kw)
    port.fit()
    ref = at.Annchor(X, l1, **kw)
    ref.fit()
    assert port.metric.batch is None and port._dev_eval is None
    assert port.evals == ref.evals
    np.testing.assert_array_equal(port.neighbor_graph[0], ref.neighbor_graph[0])
    np.testing.assert_array_equal(port.neighbor_graph[1], ref.neighbor_graph[1])


def test_to_sparse_matrix_matches_jax(blobs_fits):
    port, ref, _ = blobs_fits
    S, S_ref = port.to_sparse_matrix(), ref.to_sparse_matrix()
    assert S.shape == (1000, 1000)
    np.testing.assert_array_equal(S.toarray() > 0, S_ref.toarray() > 0)
    want = S_ref.toarray()
    assert np.all(np.abs(S.toarray() - want) <= 8 * np.spacing(want.astype(np.float32)))
    S = S.tocsr()
    assert (abs(S - S.T) > 0).nnz == 0 and S.nnz > 0


class _Regression(att.SimpleStratifiedLinearRegression):
    pass


class _JaxRegression(at.SimpleStratifiedLinearRegression):
    pass


class _Errors(att.SimpleStratifiedErrorRegression):
    pass


class _JaxErrors(at.SimpleStratifiedErrorRegression):
    pass


@pytest.mark.parametrize(
    "strategy",
    [
        ("sampler", att.ClusterSampler, at.ClusterSampler),
        ("regression", _Regression, _JaxRegression),
        ("error_predictor", _Errors, _JaxErrors),
    ],
    ids=["cluster_sampler", "regression", "error_predictor"],
)
def test_custom_strategy_fit_matches_jax(blobs, strategy):
    """Each custom strategy object takes the host pipeline in both
    packages, with the same evals and graph."""
    name, port_cls, jax_cls = strategy
    X = blobs[0][:300]
    kw = dict(n_anchors=8, n_neighbors=10, n_samples=600, p_work=0.2)
    port = att.Annchor(X, "euclidean", device="cpu", **{name: port_cls()}, **kw)
    port.fit()
    ref = at.Annchor(X, "euclidean", **{name: jax_cls()}, **kw)
    ref.fit()
    assert port._dev is None
    assert port.evals == ref.evals
    _assert_same_graph(port, ref)


@pytest.mark.parametrize("pipeline", ["device", "host"])
def test_state_setters_and_lazy_point_index(blobs, pipeline):
    """F4: features, RefineApprox, not_computed_mask and IJs can be
    assigned after a fit, and P_idx is readable, as in the JAX package."""
    X = blobs[0][:150]
    kw = dict(n_anchors=8, n_samples=200, p_work=0.5)
    port_kw = {"sampler": HostSampler()} if pipeline == "host" else {}
    jax_kw = {"sampler": JaxHostSampler()} if pipeline == "host" else {}
    fits = [
        att.Annchor(X, "euclidean", device="cpu", uniforms=jax_threefry_uniforms,
                    **port_kw, **kw),
        at.Annchor(X, "euclidean", **jax_kw, **kw),
    ]
    for ann in fits:
        ann.fit()
        ann.RefineApprox[:3] = -7.0
        assert (ann.RefineApprox[:3] == -7.0).all()
        ann.RefineApprox = ann.RefineApprox * 2
        assert ann.RefineApprox[0] == -14.0
        ann.features = ann.features[:, :3]
        ann.not_computed_mask = np.zeros(ann.IJs.shape[0], dtype=bool)
        assert ann.features.shape[1] == 3 and not ann.not_computed_mask.any()
        P = ann.P_idx
        m = ann.IJs.shape[0]
        assert P.shape[0] == 150 and ((P < m).sum(axis=1) >= 15).all()
        ann.IJs = ann.IJs[:10]
        assert ann.IJs.shape == (10, 2)
    np.testing.assert_array_equal(fits[0].P_idx, fits[1].P_idx)


def test_verbose_fit_prints_stage_table(blobs, capsys):
    X = blobs[0][:150]
    ann = att.Annchor(X, "euclidean", n_anchors=8, n_samples=200, p_work=0.5,
                      verbose=True, device="cpu")
    ann.fit()
    out = capsys.readouterr().out
    for stage in ("get_anchors", "get_locality", "get_sample", "get_ann"):
        assert stage in out


def test_early_exit_when_nothing_to_sample(capsys):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(60, 3))
    ann = att.Annchor(X, "euclidean", n_anchors=10, n_neighbors=5, n_samples=400,
                      p_work=1.0, niters=8, device="cpu")
    ann.fit()
    assert ann.neighbor_graph is not None
    assert "terminated early with nothing left to sample" in capsys.readouterr().out
    assert not ann.not_computed_mask.any()


@pytest.mark.parametrize("pipeline", ["device", "host"])
def test_tiny_dataset_exact_graph_euclidean(pipeline):
    """Port of tests/test_annchor.py::test_tiny_dataset_exact_graph with
    euclidean.  On the host pipeline the JAX package indexes its unset
    RefineApprox at n = 4 and raises (F5); the port starts the estimates
    from the anchor columns and comes out exact."""
    rng = np.random.default_rng(0)
    for n, na, k in [(4, 2, 2), (12, 5, 3)]:
        X = rng.random((n, 3))
        kw = {"sampler": HostSampler()} if pipeline == "host" else {}
        ann = att.Annchor(X, "euclidean", n_anchors=na, n_neighbors=k, device="cpu", **kw)
        ann.fit()
        bf = att.BruteForce(X, "euclidean", device="cpu")
        bf.fit()
        assert att.compare_neighbor_graphs(bf.neighbor_graph, ann.neighbor_graph, k) == 0
        if n == 4:  # the whole pool was evaluated outright
            assert not ann.not_computed_mask.any()
        if pipeline == "host" and n == 4:
            with pytest.raises(TypeError):
                at.Annchor(X, "euclidean", n_anchors=na, n_neighbors=k,
                           sampler=JaxHostSampler()).fit()


def test_backend_argument(blobs, capsys):
    X = blobs[0][:120]
    att.Annchor(X, "euclidean", backend="threading", device="cpu")
    assert "backend='threading' is ignored" in capsys.readouterr().out

    def l1(x, y):
        return float(np.abs(x - y).sum())

    bf = att.BruteForce(X, l1, backend="threading", device="cpu")
    bf.fit()
    ref = at.BruteForce(X, l1)
    ref.fit()
    np.testing.assert_array_equal(bf.D, ref.D)
    ann = att.Annchor(X, l1, backend="threading", n_anchors=6, n_samples=200,
                      p_work=0.4, lookahead=3, device="cpu")
    ann.fit()
    assert ann.lookahead == 3 and ann.neighbor_graph[0].shape == (120, 15)


@pytest.mark.parametrize("shape", [(1000, 2), (4096, 64)])
def test_chip_smoke_make_blobs_equals_sklearn(shape):
    """chip_smoke.py carries a numpy make_blobs (the card's machine has
    no sklearn); it must equal sklearn's bit for bit at its two shapes."""
    from sklearn.datasets import make_blobs

    from chip_smoke import make_blobs as smoke_make_blobs

    n, d = shape
    X, y = smoke_make_blobs(n, d, 10, 42)
    X_ref, y_ref = make_blobs(n_samples=n, n_features=d, centers=10, random_state=42)
    np.testing.assert_array_equal(X, X_ref)
    np.testing.assert_array_equal(y, y_ref)


def test_trace_dir_writes_a_trace(tmp_path):
    """F9: both packages take trace_dir; the port runs the fit under
    torch.profiler, writes its trace there and reports the same graph as
    the same fit without it."""
    X, _ = make_strings(n=120, length=30, seed=4)
    kw = dict(n_anchors=8, n_neighbors=6, n_samples=300, p_work=0.3)
    assert at.Annchor(list(X), "levenshtein", trace_dir=str(tmp_path / "jax"),
                      **kw).trace_dir == str(tmp_path / "jax")
    traced = att.Annchor(list(X), "levenshtein", device="cpu",
                         trace_dir=str(tmp_path / "port"), **kw)
    traced.fit()
    plain = att.Annchor(list(X), "levenshtein", device="cpu", **kw)
    plain.fit()
    written = [f for f in os.listdir(tmp_path / "port") if f.endswith(".pt.trace.json")]
    assert written
    with open(tmp_path / "port" / written[0]) as fh:
        events = {e.get("name") for e in json.load(fh)["traceEvents"]}
    # the program's spans ride on the profiler's trace
    assert {"fit", "fit.get_anchors", "fit.get_ann"} <= events
    assert traced.evals == plain.evals
    for a, b in zip(traced.neighbor_graph, plain.neighbor_graph):
        np.testing.assert_array_equal(a, b)
