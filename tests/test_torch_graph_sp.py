"""The graph shortest-path metric and the graph and digit data of the
port on the CPU, held against the JAX package.  Shortest paths are
scipy's float64 dijkstra in both packages, so engine values, fit evals
and graphs are compared bit for bit.

The default ``make_graph()`` graph has four isolated vertices besides
its 796-vertex component.  Their distances to the rest are inf: the
ground truth keeps them, and a fit over all 800 vertices fails in both
packages (the JAX package inside its regression's lstsq, the port with a
named error before it), so graph-sp fits run on the giant component.
"""

import numpy as np
import pytest
import torch
from scipy.sparse.csgraph import connected_components

import annchor_tpu as at
import annchor_tpu.datasets as jds
import annchor_tpu_torch as att
import annchor_tpu_torch.datasets as tds
from annchor_tpu.graph_sp import GraphShortestPathMetric as JaxSP
from annchor_tpu_torch.graph_sp import shortest_path_metric
from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def small_graph():
    """tests/test_hybrid.py's 200-vertex graph: denser inter-cluster edges
    keep the sampler's bins filled."""
    edges, weights, y = tds.make_graph(n_vertices=200, n_clusters=4, p_intra=0.15,
                                       p_inter=0.03, seed=3)
    return tds.graph_adjacency(len(y), edges, weights), len(y)


@pytest.fixture(scope="module")
def default_graph():
    edges, weights, y = tds.make_graph()
    return tds.graph_adjacency(len(y), edges, weights)


def test_make_graph_and_grid_cost_bit_equal_to_jax():
    for kw in ({}, dict(n_vertices=200, n_clusters=4, p_intra=0.15, p_inter=0.03, seed=3)):
        for a, b in zip(tds.make_graph(**kw), jds.make_graph(**kw)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tds.grid_cost_matrix(), jds.grid_cost_matrix())
    np.testing.assert_array_equal(tds.grid_cost_matrix(5, 7), jds.grid_cost_matrix(5, 7))


def test_graph_sp_engine_matches_closure(small_graph):
    A, n = small_graph
    metric = att.GraphShortestPathMetric(A)
    closure = shortest_path_metric(A)
    rng = np.random.default_rng(0)
    IJ = rng.integers(0, n, size=(50, 2)).astype(np.int64)
    X = np.arange(n)
    batch = metric.batch(X, X, IJ)
    np.testing.assert_allclose(batch, [closure(i, j) for i, j in X[IJ]])
    np.testing.assert_array_equal(batch, JaxSP(A).batch(X, X, IJ))
    assert metric(3, 7) == pytest.approx(closure(3, 7))
    Z = np.array([5, 9, 11])
    qij = np.stack([np.arange(30) % n, np.arange(30) % 3], axis=1)
    np.testing.assert_array_equal(metric.batch(X, Z, qij), JaxSP(A).batch(X, Z, qij))


def test_graph_sp_fit_matches_jax(small_graph):
    """Both packages on tests/test_hybrid.py's graph-sp fit, the port
    drawing the JAX package's samples: the same evals and graph."""
    A, n = small_graph
    X = np.arange(n)
    kw = dict(n_anchors=12, n_neighbors=8, n_samples=800, p_work=0.5, random_seed=5)
    ref = at.Annchor(X, JaxSP(A), **kw)
    ref.fit()
    port = att.Annchor(X, att.GraphShortestPathMetric(A), device="cpu",
                       uniforms=jax_threefry_uniforms, **kw)
    port.fit()
    assert port.evals == ref.evals
    np.testing.assert_array_equal(port.neighbor_graph[0], ref.neighbor_graph[0])
    np.testing.assert_array_equal(port.neighbor_graph[1], ref.neighbor_graph[1])
    bf = att.BruteForce(X, att.GraphShortestPathMetric(A), device="cpu")
    bf.fit()
    assert att.compare_neighbor_graphs(bf.neighbor_graph, port.neighbor_graph, 8) <= 2


def test_load_graph_sp_keeps_inf_rows():
    """The port's load_graph_sp gives the JAX package's data and ground
    truth; checked with inf in mind (the JAX package's own check takes
    inf - inf)."""
    d = tds.load_graph_sp()
    ngi, ngd = d["neighbor_graph"]
    n = len(d["X"])
    jng = jds._sp_ground_truth(n, *jds.make_graph()[:2])[0]
    np.testing.assert_array_equal(ngi, jng[0])
    np.testing.assert_array_equal(ngd, jng[1])
    assert ngi.shape == (n, 100) and d["A"].shape == (n, n)
    assert (ngi[:, 0] == np.arange(n)).all() and (ngd[:, 0] == 0).all()
    inf = np.isinf(ngd)
    assert inf.sum() == 396  # four isolated vertices: 4 x 99
    assert (inf.sum(axis=1) > 0).sum() == 4
    finite_rows = ngd[~inf.any(axis=1)]
    assert (np.diff(finite_rows, axis=1) >= 0).all()
    # along each row the finite part is sorted and inf only follows it
    assert not (inf[:, :-1] & ~inf[:, 1:]).any()


def test_disconnected_graph_fit_fails_clearly(default_graph):
    """F10: over all 800 vertices the isolated ones sit at distance inf.
    The JAX package fails in its regression's lstsq; the port stops after
    the anchors, naming the cause, and returns no graph with NaN edges."""
    A = default_graph
    kw = dict(n_anchors=20, n_neighbors=15, p_work=0.15, random_seed=42)
    with pytest.raises(np.linalg.LinAlgError):
        at.Annchor(np.arange(800), JaxSP(A), **kw).fit()
    ann = att.Annchor(np.arange(800), att.GraphShortestPathMetric(A), device="cpu", **kw)
    with pytest.raises(ValueError, match="non-finite anchor distances"):
        ann.fit()
    assert ann.neighbor_graph is None


def test_giant_component_fit_matches_jax(default_graph):
    """The chip smoke's graph-sp cell on the CPU: the fit over the
    796-vertex component spends the JAX package's evals and reports its
    graph."""
    A = default_graph
    _, labels = connected_components(A, directed=False)
    X = np.flatnonzero(labels == np.argmax(np.bincount(labels)))
    assert X.shape == (796,)
    kw = dict(n_anchors=20, n_neighbors=15, p_work=0.15, random_seed=42)
    ref = at.Annchor(X, JaxSP(A), **kw)
    ref.fit()
    port = att.Annchor(X, att.GraphShortestPathMetric(A), device="cpu",
                       uniforms=jax_threefry_uniforms, **kw)
    port.fit()
    assert port.evals == ref.evals
    np.testing.assert_array_equal(port.neighbor_graph[0], ref.neighbor_graph[0])
    np.testing.assert_array_equal(port.neighbor_graph[1], ref.neighbor_graph[1])


def test_make_digits_large_bit_equal_to_jax():
    """The port's stand-in for the 5,620-image set, built from its own
    copy of the digit images, is the JAX package's image for image, and
    its loader gives the JAX loader's ground truth."""
    X, y = tds.make_digits_large()
    jX, jy = jds.make_digits_large()
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(tds.make_digits_large(n=100)[0], jX[:100])
    got, want = tds.load_digits_large(k=30), jds.load_digits_large(k=30)
    np.testing.assert_array_equal(got["X"], want["X"])
    for a, b in zip(got["neighbor_graph"], want["neighbor_graph"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["cost_matrix"], want["cost_matrix"])


def test_load_digits_caches_ground_truth_by_image_hash(tmp_path, monkeypatch):
    """load_digits computes its ground truth with exact_knn once, keyed on
    a hash of the images, and reads it back after (the computation itself
    is the exact_knn tested in test_torch_exact.py)."""
    import annchor_tpu_torch.exact as texact

    calls = []

    def fake_exact_knn(X, func, func_kwargs=None, k=16, **kw):
        calls.append((X.shape, func, k))
        idx = np.tile(np.arange(k), (X.shape[0], 1))
        return idx, idx.astype(np.float64)

    monkeypatch.setattr(texact, "exact_knn", fake_exact_knn)
    d = tds.load_digits(k=5, cache_dir=str(tmp_path))
    assert calls == [((1797, 64), "wasserstein", 100)]
    assert d["X"].shape == (1797, 64) and d["neighbor_graph"][0].shape == (1797, 5)
    np.testing.assert_array_equal(d["cost_matrix"], jds.grid_cost_matrix())
    again = tds.load_digits(k=7, cache_dir=str(tmp_path))
    assert len(calls) == 1 and again["neighbor_graph"][1].shape == (1797, 7)
    # a cache computed from other images is recomputed
    np.savez(str(tmp_path / "digits_gt.npz"), ngi=np.zeros((1, 1)), ngd=np.zeros((1, 1)),
             xhash="stale")
    tds.load_digits(cache_dir=str(tmp_path))
    assert len(calls) == 2
