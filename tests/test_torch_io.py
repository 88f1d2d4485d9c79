"""Checkpoints of the port (``annchor_tpu_torch/io.py``) on the CPU: the
port's copies of the JAX package's ``tests/test_io.py``, and files
written by either package loaded by the other.
"""

import os

import numpy as np
import pytest
import torch

import annchor_tpu as at
import annchor_tpu_torch as att
from annchor_tpu_torch.datasets import make_strings
from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms

torch.set_num_threads(2)


class _env:
    """Environment variables set for the duration of a ``with`` block."""

    def __init__(self, **kv):
        self.kv = kv

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.kv}
        os.environ.update(self.kv)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


SPARSE = dict(ANNCHOR_TPU_FORCE_SPARSE="1", ANNCHOR_TPU_DISABLE_SHARDING="1")


def _blobs(n, centers, features, seed):
    from sklearn.datasets import make_blobs

    X, _ = make_blobs(n_samples=n, centers=centers, n_features=features,
                      random_state=seed)
    return X


@pytest.fixture(scope="module")
def fitted(blobs):
    X, y = blobs
    X = X[:300]
    ann = att.Annchor(X, "euclidean", n_anchors=10, n_neighbors=10, n_samples=500,
                      p_work=0.3, random_seed=42, device="cpu")
    ann.fit()
    return ann, X


def test_save_load_roundtrip(fitted, tmp_path):
    ann, X = fitted
    p = str(tmp_path / "index.npz")
    ann.save(p)
    ann2 = att.Annchor.load(p, X, "euclidean", device="cpu")
    np.testing.assert_array_equal(ann2.neighbor_graph[0], ann.neighbor_graph[0])
    np.testing.assert_allclose(ann2.neighbor_graph[1], ann.neighbor_graph[1])
    assert ann2.evals == ann.evals
    assert ann2.device == torch.device("cpu")


def test_loaded_index_serves_queries(fitted, tmp_path, rng):
    ann, X = fitted
    p = str(tmp_path / "index.npz")
    ann.save(p)
    ann2 = att.Annchor.load(p, X, "euclidean", device="cpu")
    Q = X[:20] + rng.normal(scale=0.01, size=(20, 2))
    gi1, gd1 = ann.query(Q, nn=5, p_work=0.5)
    gi2, gd2 = ann2.query(Q, nn=5, p_work=0.5)
    np.testing.assert_array_equal(gi1, gi2)
    np.testing.assert_allclose(gd1, gd2)
    assert (gi2[:, 0] == np.arange(20)).all()


def test_loaded_index_refines(tmp_path):
    """The per-edge exactness survives the round trip, so refining a
    loaded index certifies only the predicted edges and still recovers
    what the pair cap lost."""
    X = _blobs(800, 8, 5, 11)
    with _env(ANNCHOR_TPU_PAIR_CAP="120", ANNCHOR_TPU_FORCE_SPARSE="1"):
        ann = att.Annchor(X, "euclidean", n_anchors=5, n_neighbors=8, n_samples=500,
                          p_work=0.03, random_seed=7, device="cpu")
        ann.fit()
    assert (~ann._ng_exact).any()
    p = str(tmp_path / "index.npz")
    ann.save(p)
    ann2 = att.Annchor.load(p, X, "euclidean", device="cpu")
    np.testing.assert_array_equal(ann._ng_exact, ann2._ng_exact)

    bf = att.BruteForce(X, "euclidean", device="cpu")
    bf.fit()
    err_before = att.compare_neighbor_graphs(bf.neighbor_graph, ann2.neighbor_graph, 8)
    ev0 = ann2.evals
    ann2.refine_neighbor_graph(rounds=2, budget=2000)
    err_after = att.compare_neighbor_graphs(bf.neighbor_graph, ann2.neighbor_graph, 8)
    assert ann2.evals - ev0 <= 2000
    assert err_after <= err_before
    gi, gd = ann2.neighbor_graph
    assert (gi[:, 0] == np.arange(len(X))).all()
    assert (np.diff(gd, axis=1) >= 0).all()


def test_save_before_fit_raises(blobs, tmp_path):
    X, _ = blobs
    ann = att.Annchor(X[:100], "euclidean", n_anchors=5, n_samples=100, p_work=0.5,
                      device="cpu")
    with pytest.raises(ValueError, match="fit"):
        ann.save(str(tmp_path / "x.npz"))


def test_load_wrong_dataset_size(fitted, tmp_path):
    ann, X = fitted
    p = str(tmp_path / "index.npz")
    ann.save(p)
    with pytest.raises(ValueError, match="points"):
        att.Annchor.load(p, X[:100], "euclidean", device="cpu")


@pytest.fixture(scope="module")
def sparse_fitted():
    """A budget-capped scale-path fit (sparse device state)."""
    X = _blobs(900, 8, 5, 4)
    with _env(ANNCHOR_TPU_FORCE_SPARSE="1"):
        ann = att.Annchor(X, "euclidean", n_anchors=12, n_neighbors=10,
                          n_samples=1000, p_work=0.2, random_seed=42, pair_cap=100,
                          device="cpu")
        ann.fit()
    return ann, X


def test_v2_save_never_materialises(sparse_fitted, tmp_path):
    """A scale-path save brings none of the m-sized pair state to the
    host."""
    ann, X = sparse_fitted
    p = str(tmp_path / "sparse.npz")
    ann.save(p)
    assert ann._IJs is None
    assert ann._features is None
    assert ann._RefineApprox is None
    assert ann._dev is not None
    z = np.load(p)
    assert int(z["format"]) == 2
    assert "IJs" not in z.files and "features" not in z.files
    assert "exact_keys" in z.files
    assert np.all(np.diff(z["exact_keys"]) > 0)
    assert z["exact_vals"].shape == z["exact_keys"].shape


def test_v2_dump_holds_every_computed_value(sparse_fitted, tmp_path):
    """The refinement batches evaluated on the device are in the dump:
    it holds exactly the state's computed pairs (ROADMAP F8)."""
    ann, X = sparse_fitted
    p = str(tmp_path / "sparse.npz")
    ann.save(p)
    z = np.load(p)
    dev = ann._dev
    assert not dev._pending_exact
    done = torch.nonzero(~dev.ncm)[:, 0].numpy()
    np.testing.assert_array_equal(np.sort(dev.exact.ids), done)
    assert z["exact_keys"].shape[0] == done.shape[0]


def test_v2_roundtrip_serves_queries(sparse_fitted, tmp_path, rng):
    ann, X = sparse_fitted
    p = str(tmp_path / "sparse.npz")
    ann.save(p)
    ann2 = att.Annchor.load(p, X, "euclidean", device="cpu")
    np.testing.assert_array_equal(ann2.neighbor_graph[0], ann.neighbor_graph[0])
    assert ann2.evals == ann.evals
    Q = X[:15] + rng.normal(scale=0.01, size=(15, 5))
    gi1, gd1 = ann.query(Q, nn=5, p_work=0.5)
    gi2, gd2 = ann2.query(Q, nn=5, p_work=0.5)
    np.testing.assert_array_equal(gi1, gi2)
    np.testing.assert_allclose(gd1, gd2)


def test_v2_exact_store_values_correct(sparse_fitted, tmp_path):
    ann, X = sparse_fitted
    p = str(tmp_path / "sparse.npz")
    ann.save(p)
    z = np.load(p)
    keys = z["exact_keys"][:200]
    vals = z["exact_vals"][:200]
    i, j = keys // ann.nx, keys % ann.nx
    np.testing.assert_allclose(vals, np.linalg.norm(X[i] - X[j], axis=1), rtol=1e-6)


def test_v2_rebuild_pairs(sparse_fitted, tmp_path):
    """The build knobs persist: rebuild_pairs reproduces the fit's pair
    list without the caller supplying them again."""
    ann, X = sparse_fitted
    p = str(tmp_path / "sparse.npz")
    ann.save(p)
    with _env(ANNCHOR_TPU_FORCE_SPARSE="1"):
        ann2 = att.Annchor.load(p, X, "euclidean", rebuild_pairs=True, device="cpu")
    assert ann2.pair_cap == ann.pair_cap == 100
    assert ann2.p_work == ann.p_work
    assert ann2.loc_min == ann.loc_min
    assert ann2._ij_dev is not None
    m = ann2._ij_dev[2]
    assert m == ann._dev.m
    for a, b in zip(ann2._ij_dev[:2], (ann._dev.ij_i, ann._dev.ij_j)):
        assert torch.equal(a, b[:m])


def test_refine_skips_store_for_scouting_ann(sparse_fitted, tmp_path):
    """Port of tests/test_io.py::test_refine_skips_store_for_scouting_ann:
    a scout/certify hybrid's store holds the scout's values for its
    exploration pairs, so refinement must not serve candidates from it
    as exact.  The gate reads ``_scouting``, flipped here on a loaded
    index as in the JAX test."""
    ann, X = sparse_fitted
    p = str(tmp_path / "sparse.npz")
    ann.save(p)
    ann2 = att.Annchor.load(p, X, "euclidean", device="cpu")
    assert ann2._exact_keys.size > 0
    ann2._scouting = True
    ann2._exact_eval = ann2.get_exact_ijs
    ann2.refine_neighbor_graph(rounds=1, budget=100)
    assert sum(s.get("store_hits", 0) for s in ann2._refine_stats) == 0


def test_v2_include_exact_false(sparse_fitted, tmp_path):
    ann, X = sparse_fitted
    p = str(tmp_path / "lean.npz")
    ann.save(p, include_exact=False)
    z = np.load(p)
    assert "exact_keys" not in z.files
    ann2 = att.Annchor.load(p, X, "euclidean", device="cpu")
    np.testing.assert_array_equal(ann2.neighbor_graph[0], ann.neighbor_graph[0])


def test_v2_loaded_refine_reuses_exact_store(sparse_fitted, tmp_path):
    """Refining a loaded v2 index takes the 2-hop candidates the fit
    already evaluated from the stored values, at no metric cost."""
    ann, X = sparse_fitted
    p = str(tmp_path / "sparse.npz")
    ann.save(p)
    ann2 = att.Annchor.load(p, X, "euclidean", device="cpu")
    assert ann2._exact_keys.size > 0
    evals0 = ann2.evals
    ann2.refine_neighbor_graph(rounds=2, budget=200)
    spent = ann2.evals - evals0
    hits = sum(s.get("store_hits", 0) for s in ann2._refine_stats)
    assert hits > 0
    assert spent <= 200
    gi, gd = ann2.neighbor_graph
    for r in np.arange(0, ann2.nx, 37):
        d = np.linalg.norm(X[gi[r, 1:]] - X[r], axis=1)
        np.testing.assert_allclose(gd[r, 1:], d, rtol=1e-5, atol=1e-5)


def test_env_pair_cap_zero_overrides_ctor():
    """ANNCHOR_TPU_PAIR_CAP=0 restores the derived cap even when the
    constructor passed pair_cap."""
    X = _blobs(600, 6, 4, 7)
    kw = dict(n_anchors=10, n_neighbors=8, n_samples=800, p_work=0.3, random_seed=1,
              device="cpu")

    def pairs(**extra):
        ann = att.Annchor(X, "euclidean", **kw, **extra)
        ann.get_anchors()
        ann.get_locality()
        return int(ann._ij_dev[2])

    with _env(ANNCHOR_TPU_FORCE_SPARSE="1"):
        m_cap = pairs(pair_cap=60)
        with _env(ANNCHOR_TPU_PAIR_CAP="0"):
            m_env = pairs(pair_cap=60)
        m_def = pairs()
    assert m_env == m_def
    assert m_cap != m_def


# ---------------------------------------------------------------------------
# files across the packages


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_v1_cross_load(fitted, tmp_path, writer):
    """A v1 file written by one package loads in the other with the
    same graph, per-pair state and models."""
    ann, X = fitted
    p = str(tmp_path / "index.npz")
    if writer == "port":
        ann.save(p)
        other = at.Annchor.load(p, X, "euclidean")
    else:
        ref = at.Annchor(X, "euclidean", n_anchors=10, n_neighbors=10, n_samples=500,
                         p_work=0.3, random_seed=42)
        ref.fit()
        ref.save(p)
        other = att.Annchor.load(p, X, "euclidean", device="cpu")
    z = np.load(p)
    np.testing.assert_array_equal(other.neighbor_graph[0], z["ng_i"])
    np.testing.assert_array_equal(other.neighbor_graph[1], z["ng_d"])
    np.testing.assert_array_equal(np.asarray(other.IJs), z["IJs"])
    np.testing.assert_array_equal(other.RefineApprox, z["RefineApprox"])
    np.testing.assert_array_equal(other.regression.coefs, z["reg_coefs"])
    assert other.evals == int(z["evals"])


@pytest.fixture(scope="module")
def sparse_pair(tmp_path_factory):
    """The same forced-sparse Levenshtein fit in both packages (the port
    draws the JAX sample stream), each saved as v2."""
    X, _ = make_strings(n=500, length=60, seed=7)
    X = list(X)
    kw = dict(n_anchors=12, n_neighbors=10, n_samples=1000, p_work=0.2,
              random_seed=42, pair_cap=100)
    d = tmp_path_factory.mktemp("v2")
    with _env(**SPARSE):
        ref = at.Annchor(X, "levenshtein", **kw)
        ref.fit()
        port = att.Annchor(X, "levenshtein", device="cpu",
                           uniforms=jax_threefry_uniforms, **kw)
        port.fit()
    ref.save(str(d / "jax.npz"))
    port.save(str(d / "port.npz"))
    return X, ref, port, str(d / "jax.npz"), str(d / "port.npz")


def test_v2_files_match_across_packages(sparse_pair):
    """Every array of the two v2 files is equal, but for the exact store:
    the JAX package's dump lacks the refinement batches it has not
    brought to the host (ROADMAP F8), so its keys are a subset of the
    port's, with the same values."""
    X, ref, port, pj, pp = sparse_pair
    assert port.evals == ref.evals
    zj, zp = np.load(pj), np.load(pp)
    assert set(zj.files) == set(zp.files)
    for k in zj.files:
        if k in ("exact_keys", "exact_vals"):
            continue
        assert zj[k].dtype == zp[k].dtype, k
        np.testing.assert_array_equal(zj[k], zp[k], err_msg=k)
    pos = np.searchsorted(zp["exact_keys"], zj["exact_keys"])
    np.testing.assert_array_equal(zp["exact_keys"][pos], zj["exact_keys"])
    np.testing.assert_array_equal(zp["exact_vals"][pos], zj["exact_vals"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_v2_cross_load(sparse_pair, writer):
    """A v2 file loads in the other package with the file's exact store,
    and rebuild_pairs gives both packages the fit's pair list."""
    X, ref, port, pj, pp = sparse_pair
    path = pj if writer == "jax" else pp
    z = np.load(path)
    with _env(**SPARSE):
        got = att.Annchor.load(path, X, "levenshtein", rebuild_pairs=True, device="cpu")
        want = at.Annchor.load(path, X, "levenshtein", rebuild_pairs=True)
    for ann in (got, want):
        np.testing.assert_array_equal(ann._exact_keys, z["exact_keys"])
        np.testing.assert_array_equal(ann._exact_vals, z["exact_vals"])
        np.testing.assert_array_equal(ann.neighbor_graph[0], ref.neighbor_graph[0])
    m = port._dev.m
    assert got._ij_dev[2] == want._ij_dev[2] == m
    for a, b in zip(got._ij_dev[:2], want._ij_dev[:2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[:m])
    np.testing.assert_array_equal(got.P_cnt, np.asarray(want.P_cnt))
