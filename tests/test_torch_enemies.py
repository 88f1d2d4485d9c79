"""Nearest-enemy graph and selective subsets of the port
(``annchor_tpu_torch/enemies.py``) on the CPU.

* The host path, on a JAX-fitted index loaded from its v1 checkpoint,
  must give the JAX package's enemy graph, selective subset and
  alpha-RSS subset bit for bit (the JAX side runs its fitted index,
  whose host state the file holds: a v1 file carries no ``loc_eff``, and
  the JAX package's loaded index cannot run the extras, ROADMAP F7).
* The device passes (enemy candidates, label-masked thresholds, refine
  selection, enemy assembly, cover incidence) are held bit for bit
  against the JAX package's programs on the same inputs.
* The device path, dense and sparse, is held against the host path on a
  twin fit (the port's copies of ``tests/test_scale_path.py``'s
  device-resident extras, with their tolerances) and must leave the fit
  state on the device.
* ``tracked_mask`` is held against ``np.isin`` at list lengths m = 2^k,
  where the JAX package's binary search runs one halving short (F1).
* A fitted index and its device state are freed with their last
  reference, without the cyclic collector.
"""

import gc
import os
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import annchor_tpu as at
import annchor_tpu_torch as att
from annchor_tpu.ops import device_pipeline as jdp
from annchor_tpu.ops import locality as jloc
from annchor_tpu_torch.datasets import make_strings
from annchor_tpu_torch.ops import device_pipeline as tdp
from annchor_tpu_torch.ops import locality as tloc

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """A JAX fit of a small Levenshtein index (host state after its v1
    save) and the port's load of that file: (X, y, JAX index, port)."""
    X, y = make_strings(n=300, length=60, seed=7)
    X = list(X)
    ref = at.Annchor(X, "levenshtein", n_anchors=12, n_neighbors=10, n_samples=800,
                     p_work=0.3)
    ref.fit()
    path = str(tmp_path_factory.mktemp("enemies") / "index.npz")
    ref.save(path)  # brings the JAX state to the host
    assert ref._dev is None
    port = att.Annchor.load(path, X, "levenshtein", device="cpu")
    return X, y, ref, port


def test_loaded_loc_eff_matches_fit(loaded):
    X, y, ref, port = loaded
    np.testing.assert_array_equal(np.asarray(port.loc_eff), np.asarray(ref.loc_eff))


def test_host_path_matches_jax(loaded):
    """Enemy graph, selective subsets (two alphas) and alpha-RSS, bit
    for bit, after the same metric evaluations."""
    X, y, ref, port = loaded
    ev_ref, ev = ref.evals, port.evals
    want = ref.get_nearest_enemies(y, nn=3)
    got = port.get_nearest_enemies(y, nn=3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert port.evals - ev == ref.evals - ev_ref > 0
    np.testing.assert_array_equal(np.asarray(port.IJs), np.asarray(ref.IJs))
    for alpha in (0, 0.5):
        np.testing.assert_array_equal(
            port.annchor_selective_subset(y, alpha=alpha),
            ref.annchor_selective_subset(y, alpha=alpha),
        )
    np.testing.assert_array_equal(port.alpha_rss(y), ref.alpha_rss(y))
    assert (y[got[0]] != y[:, None]).all()


# ---------------------------------------------------------------------------
# the device passes against the JAX package's programs


def _membership(nx, na, locality, seed):
    rng = np.random.default_rng(seed)
    D = np.abs(rng.normal(size=(nx, na)))
    S, _ = tloc.anchor_membership(D, locality)
    return S.numpy(), rng


@pytest.mark.parametrize("nx,loc_min", [(77, 5), (130, 20)])
def test_enemy_thresholds_and_candidates_match_jax(nx, loc_min):
    S, rng = _membership(nx, 10, 4, nx)
    y = rng.integers(0, 4, size=nx)
    want_e = jloc.effective_thresholds(S, 2, loc_min, label_neq=y)
    got_e = tloc.effective_thresholds(S, 2, loc_min, label_neq=y, device="cpu")
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    mask = y[:, None] != y[None, :]
    got_m = tloc.effective_thresholds(S, 2, loc_min, label_mask=mask, device="cpu")
    np.testing.assert_array_equal(got_m.numpy(), want_e)
    loc_eff = jloc.effective_thresholds(S, 3, loc_min)
    for excl in (loc_eff, np.full(nx, np.inf, np.float32)):
        want = jloc.enemy_candidate_pairs(S, y, want_e, excl)
        got = tloc.enemy_candidate_pairs(S, y, got_e, excl, device="cpu")
        assert got.dtype == np.int32 and got.shape[0] > 0
        np.testing.assert_array_equal(got, want)


def _random_state(nx, m, seed):
    """A random pair state (i < j, no repeats) with its incidence."""
    rng = np.random.default_rng(seed)
    iu = np.stack(np.triu_indices(nx, 1), axis=1)
    IJ = iu[np.sort(rng.choice(len(iu), m, replace=False))].astype(np.int32)
    RA = rng.integers(1, 40, size=m).astype(np.float32)  # ties on purpose
    ncm = rng.random(m) < 0.6
    ub = RA + rng.random(m).astype(np.float32) * 5
    counts = np.bincount(IJ.reshape(-1), minlength=nx)
    ii = torch.as_tensor(IJ[:, 0])
    jj = torch.as_tensor(IJ[:, 1])
    P = tdp.pidx_from_pairs(ii, jj, nx, int(counts.max()))
    return IJ, RA, ncm, ub, P, rng


@pytest.mark.parametrize("nx,m", [(50, 400), (300, 3000)])
def test_enemy_device_passes_match_jax(nx, m):
    IJ, RA, ncm, ub, P, rng = _random_state(nx, m, nx)
    y = rng.integers(0, 3, size=nx)
    t = dict(RA=torch.as_tensor(RA), ncm=torch.as_tensor(ncm),
             ii=torch.as_tensor(IJ[:, 0]), jj=torch.as_tensor(IJ[:, 1]))
    j = dict(RA=jnp.asarray(RA), ncm=jnp.asarray(ncm), ii=jnp.asarray(IJ[:, 0]),
             jj=jnp.asarray(IJ[:, 1]))
    Pj = jnp.asarray(P.numpy())
    yt, yj = torch.as_tensor(y), jnp.asarray(y.astype(np.int32))

    want = np.asarray(jdp._enemy_refine_select(j["RA"], j["ncm"], Pj, j["ii"], j["jj"],
                                               yj, 7))
    got = tdp.enemy_refine_select(t["RA"], t["ncm"], P, t["ii"], t["jj"], yt, 7)
    np.testing.assert_array_equal(got.numpy(), want)

    want = jdp._enemy_knn(j["RA"], j["ncm"], Pj, j["ii"], j["jj"], yj, 3)
    got = tdp.enemy_knn(t["RA"], t["ncm"], P, t["ii"], t["jj"], yt, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    subset = np.sort(rng.choice(nx, nx // 5, replace=False))
    slot = np.full(nx, -1, dtype=np.int64)
    slot[subset] = np.arange(subset.shape[0])
    radii = rng.integers(5, 45, size=nx).astype(np.float32)
    want = jdp._cover_incidence(j["RA"], j["ncm"], jnp.asarray(ub), Pj, j["ii"],
                                j["jj"], jnp.asarray(slot.astype(np.int32)),
                                jnp.asarray(radii), subset.shape[0])
    got = tdp.cover_incidence(t["RA"], t["ncm"], torch.as_tensor(ub), P, t["ii"],
                              t["jj"], torch.as_tensor(slot), torch.as_tensor(radii),
                              subset.shape[0])
    assert got.numpy().sum() > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 6, 10, 11])
def test_tracked_mask_at_powers_of_two(k):
    """m = 2^k tracked pairs; every tracked pair is found (the last in
    lexicographic order included) and no other pair is."""
    nx = 200
    m = 1 << k
    rng = np.random.default_rng(k)
    iu = np.stack(np.triu_indices(nx, 1), axis=1)
    tracked = iu[rng.choice(len(iu), m, replace=False)]
    tracked[-1] = (nx - 2, nx - 1)  # the largest key
    tracked = np.unique(tracked, axis=0)[::-1].copy()  # stored out of order
    st = tdp.DeviceFitState.__new__(tdp.DeviceFitState)
    st.nx = nx
    st.device = torch.device("cpu")
    st.ij_i = torch.as_tensor(tracked[:, 0].astype(np.int32))
    st.ij_j = torch.as_tensor(tracked[:, 1].astype(np.int32))
    st.m = tracked.shape[0]
    st._tracked_keys = None
    q = np.concatenate([tracked, iu[rng.choice(len(iu), 3 * m)], [(0, 1), (nx - 2, nx - 1)]])
    keys = lambda a: a[:, 0].astype(np.int64) * nx + a[:, 1]  # noqa: E731
    np.testing.assert_array_equal(st.tracked_mask(q), np.isin(keys(q), keys(tracked)))
    assert st.tracked_mask(np.zeros((0, 2), np.int64)).shape == (0,)


@pytest.mark.parametrize("case", ["dense", "sparse", "dense-enemies"])
def test_fit_state_freed_without_collector(case, monkeypatch):
    """The fit state holds nothing that points back at the Annchor: with
    the cyclic collector off, deleting a fitted Annchor frees it and its
    state at once, after a dense fit, a scale-path fit, and a dense fit
    whose nearest-enemy extras appended pairs to the state."""
    if case == "sparse":
        monkeypatch.setenv("ANNCHOR_TPU_FORCE_SPARSE", "1")
    X, y = make_strings(n=200, length=40, seed=4)
    gc.collect()
    gc.disable()
    try:
        ann = att.Annchor(list(X), "levenshtein", n_anchors=10, n_neighbors=6,
                          n_samples=500, p_work=0.3, loc_thresh=3, device="cpu")
        ann.fit()
        assert ann._dev is not None and ann._dev.sparse == (case == "sparse")
        if case == "dense-enemies":
            m0 = ann._dev.m
            ann.get_nearest_enemies(y, nn=3)
            assert ann._dev.m > m0
        refs = weakref.ref(ann), weakref.ref(ann._dev)
        del ann
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# the device path against the host path (tests/test_scale_path.py:433-475)


@pytest.mark.parametrize("sparse", [False, True])
def test_enemies_device_resident(sparse, monkeypatch):
    """The extras run on the live device state: ann._dev survives, a
    sparse fit's host pair list is never assembled, and the results
    agree with the host path on a twin fit."""
    from sklearn.datasets import make_blobs

    if sparse:
        monkeypatch.setenv("ANNCHOR_TPU_FORCE_SPARSE", "1")
    nx = 700
    X, y = make_blobs(n_samples=nx, centers=8, n_features=4, random_state=5)

    def fit():
        ann = att.Annchor(X, "euclidean", n_anchors=12, n_neighbors=8,
                          n_samples=1500, p_work=0.15, random_seed=42, device="cpu")
        ann.fit()
        return ann

    ann_d = fit()
    assert ann_d._dev is not None and ann_d._dev.sparse == sparse
    ngi_d, ngd_d = ann_d.get_nearest_enemies(y, nn=3)
    sub_d = ann_d.annchor_selective_subset(y)
    assert ann_d._dev is not None
    if sparse:
        assert ann_d._IJs is None and ann_d._ij_dev is not None

    ann_h = fit()
    ann_h._sync_from_device()  # drops _dev: the host path
    ngi_h, ngd_h = ann_h.get_nearest_enemies(y, nn=3)
    sub_h = ann_h.annchor_selective_subset(y)

    np.testing.assert_allclose(ngd_d, ngd_h, rtol=1e-4, atol=1e-4)
    assert (ngi_d == ngi_h).mean() > 0.99
    assert (y[ngi_d] != y[:, None]).all()
    D = np.linalg.norm(X[:, None, :] - X[None, :, :], axis=2)
    assert (D[:, sub_d].min(axis=1) < ngd_d[:, 0] + 1e-9).mean() > 0.95
    assert abs(len(sub_d) - len(sub_h)) <= max(2, len(sub_h) // 20)


def test_enemies_device_dense_append():
    """Dense-mode enemies with appended cross-cluster pairs keep
    ann.IJs, features, RefineApprox and the not-computed mask aligned at
    the new m (tests/test_scale_path.py:520)."""
    from sklearn.datasets import make_blobs

    nx = 300
    X, y = make_blobs(n_samples=nx, centers=2, n_features=4, cluster_std=0.5,
                      center_box=(-30.0, 30.0), random_state=11)
    ann = att.Annchor(X, "euclidean", n_anchors=10, n_neighbors=5, n_samples=800,
                      p_work=0.05, loc_thresh=2, random_seed=42, device="cpu")
    ann.fit()
    assert ann._dev is not None and not ann._dev.sparse
    m_before = len(ann.IJs)

    ngi, ngd = ann.get_nearest_enemies(y, nn=3)
    m_after = ann._dev.m
    assert m_after > m_before
    assert len(ann.IJs) == m_after
    assert int(np.asarray(ann.P_cnt).sum()) == 2 * m_after
    assert len(ann.features) == m_after
    assert len(ann.RefineApprox) == m_after
    assert len(ann.not_computed_mask) == m_after
    assert (y[ngi] != y[:, None]).all()
    assert np.isfinite(ngd).all() and (ngd > 0).all()
    assert ann.P_idx.max() >= m_before


def test_sparse_extras_keep_device_state():
    """On a sparse fit the appended pairs reach the device pair list
    only: ann._ij_dev follows the state, the lazy host list stays
    unassembled, and tracked_mask finds the appended pairs."""
    from sklearn.datasets import make_blobs

    X, y = make_blobs(n_samples=400, centers=4, n_features=3, random_state=2)
    os.environ["ANNCHOR_TPU_FORCE_SPARSE"] = "1"
    try:
        ann = att.Annchor(X, "euclidean", n_anchors=8, n_neighbors=6, n_samples=600,
                          p_work=0.1, random_seed=3, pair_cap=40, device="cpu")
        ann.fit()
    finally:
        os.environ.pop("ANNCHOR_TPU_FORCE_SPARSE")
    dev = ann._dev
    m0 = dev.m
    new = tloc.enemy_candidate_pairs(
        ann._S_raw, y,
        tloc.effective_thresholds(ann._S_raw, ann.loc_thresh, 100, label_neq=y),
        np.full(ann.nx, np.inf, np.float32),
    )
    fresh = new[~dev.tracked_mask(new)]
    assert fresh.shape[0] > 0
    ann.get_nearest_enemies(y, nn=3)
    assert dev.m == m0 + fresh.shape[0]
    assert ann._IJs is None and ann._ij_dev[2] == dev.m
    assert dev.tracked_mask(fresh).all()
    assert dev.P_idx_d.shape[0] == ann.nx
