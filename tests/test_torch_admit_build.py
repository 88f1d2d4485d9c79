"""The scale path's admit-everything pair build, its hand-over to the
budgeted build, the rms build score and the blocked host pair build of
the port, held against the JAX package on the CPU.

Integer results are bit-equal: pair lists in order, per-point counts,
memberships and thresholds, eval counts and graph indices.  The rms
score panel is float32 arithmetic summed in another order than XLA's
(the port forms its products and norms in float64 and rounds each once):
it is held to JAX's panel within the cancellation bound stated at
``test_rms_score_panel_close_to_jax``.
"""


import numpy as np
import pytest
import torch

import annchor_tpu as at
import annchor_tpu_torch as att
from annchor_tpu.ops import locality as jloc
from annchor_tpu_torch.datasets import make_strings
from annchor_tpu_torch.ops import locality as tloc
from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms

torch.set_num_threads(2)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.fixture
def scale_env(monkeypatch):
    monkeypatch.setenv("ANNCHOR_TPU_FORCE_SPARSE", "1")
    monkeypatch.setenv("ANNCHOR_TPU_DISABLE_SHARDING", "1")


@pytest.mark.parametrize("nx,block", [(400, 4096), (400, 128), (900, 256), (700, 300)])
def test_candidate_pairs_device_bit_equal_to_jax(nx, block):
    """Port of tests/test_scale_path.py::test_candidate_pairs_device_matches_host,
    held to the JAX package's build itself: the same pair list in the same
    order, P_cnt, sid, S and eff."""
    rng = np.random.default_rng(nx * 1000 + block)
    D = rng.random((nx, 16))
    want = jloc.candidate_pairs_device(D, 5, 2, 25, block=block)
    info = {}
    got = tloc.candidate_pairs_device(D, 5, 2, 25, block=block, info=info)
    assert got[2] == want[2] == info["admitted"] and info["build"] == "admit"
    for k in (0, 1, 3, 4, 5, 6):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
    assert got[0].dtype == got[1].dtype == torch.int32
    assert (_np(got[0]) < _np(got[1])).all()
    # the host pipeline's build admits the same pairs
    IJs = tloc.candidate_pairs(D, 5, 2, 25, "cpu")[0]
    np.testing.assert_array_equal(IJs, np.stack([_np(got[0]), _np(got[1])], axis=1))


def test_block_halving_keeps_flat_indices_in_int32(monkeypatch):
    """The row block halves until block * nx < 2^31, as in the JAX
    package; shrunk here through the block argument."""
    D = np.random.default_rng(4).random((600, 12))
    a = tloc.candidate_pairs_device(D, 4, 2, 20, block=600)
    b = tloc.candidate_pairs_device(D, 4, 2, 20, block=37)
    for k in (0, 1, 6):
        np.testing.assert_array_equal(_np(a[k]), _np(b[k]))


@pytest.mark.parametrize("nx,block", [(700, 256), (1000, 300)])
def test_blocked_host_candidate_pairs_bit_equal_to_jax(nx, block):
    """The host pipeline's blocked build (above ``block`` points) against
    the JAX package's blocked branch: the pair list in order, sid, S and
    eff."""
    D = np.random.default_rng(nx + block).random((nx, 20))
    IJs, sid, S, eff = tloc.candidate_pairs(D, 5, 2, 25, "cpu", block=block)
    jIJs, jsid, jS, jeff = jloc.candidate_pairs(D, 5, 2, 25, block=block)
    assert IJs.dtype == np.int32
    np.testing.assert_array_equal(IJs, jIJs)
    np.testing.assert_array_equal(_np(sid), np.asarray(jsid))
    np.testing.assert_array_equal(_np(S), np.asarray(jS))
    np.testing.assert_array_equal(_np(eff), np.asarray(jeff))
    # one block gives the same pairs as the row blocks
    np.testing.assert_array_equal(tloc.candidate_pairs(D, 5, 2, 25, "cpu")[0], IJs)


def test_auto_switch_hands_over_to_the_budgeted_build():
    """Over ``max_resident`` admitted pairs the build is the budgeted one
    at ``budget_cap``, from the counting pass's membership and
    thresholds, in both packages."""
    D = np.random.default_rng(7).random((500, 16))
    info = {}
    got = tloc.candidate_pairs_device(D, 5, 2, 25, block=128, max_resident=1000,
                                      budget_cap=30, info=info)
    assert info["build"] == "budgeted" and info["admitted"] > 1000
    direct = tloc.candidate_pairs_device_budgeted(D, 5, 2, 25, 30, block=128)
    want = jloc.candidate_pairs_device(D, 5, 2, 25, block=128, max_resident=1000,
                                       budget_cap=30)
    assert got[2] == direct[2] == want[2] < info["admitted"]
    for k in (0, 1, 3, 4, 5, 6):
        np.testing.assert_array_equal(_np(got[k]), _np(direct[k]))
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
    # under the bound nothing switches
    info = {}
    tloc.candidate_pairs_device(D, 5, 2, 25, block=128, max_resident=10**8,
                                budget_cap=30, info=info)
    assert info["build"] == "admit"


def test_auto_budget_switch(scale_env, monkeypatch):
    """Port of tests/test_scale_path.py::test_auto_budget_switch: with
    ANNCHOR_TPU_NO_PAIR_BUDGET the metric fit takes the admit-everything
    build, which over ANNCHOR_TPU_MAX_RESIDENT_PAIRS (or the
    max_resident_pairs keyword) switches to the budgeted build at the
    derived cap; that fit equals the one with the cap set explicitly, and
    the JAX package's auto fit."""
    from sklearn.datasets import make_blobs

    X, _ = make_blobs(n_samples=700, centers=6, n_features=5, random_state=9)
    kw = dict(n_anchors=12, n_neighbors=10, n_samples=900, p_work=0.3, random_seed=42)
    derived_cap = max(4 * 10, int(round(0.7 * 0.3 * 700)))
    monkeypatch.setenv("ANNCHOR_TPU_NO_PAIR_BUDGET", "1")
    monkeypatch.setenv("ANNCHOR_TPU_MAX_RESIDENT_PAIRS", "5000")
    ref = at.Annchor(X, "euclidean", **kw)
    ref.fit()
    auto = att.Annchor(X, "euclidean", device="cpu", uniforms=jax_threefry_uniforms, **kw)
    auto.fit()
    assert auto._locality_info["build"] == "budgeted"
    assert auto._locality_info["admitted"] > 5000
    monkeypatch.delenv("ANNCHOR_TPU_MAX_RESIDENT_PAIRS")
    kwarg = att.Annchor(X, "euclidean", device="cpu", uniforms=jax_threefry_uniforms,
                        max_resident_pairs=5000, **kw)
    kwarg.get_anchors()
    kwarg.get_locality()
    assert kwarg._locality_info["build"] == "budgeted"
    monkeypatch.delenv("ANNCHOR_TPU_NO_PAIR_BUDGET")
    monkeypatch.setenv("ANNCHOR_TPU_PAIR_CAP", str(derived_cap))
    # the explicit cap's tracked set is the auto fit's, so is its fit
    explicit = att.Annchor(X, "euclidean", device="cpu", uniforms=jax_threefry_uniforms, **kw)
    explicit.get_anchors()
    explicit.get_locality()
    assert explicit._locality_info["build"] == "budgeted"
    assert auto._ij_dev[2] == explicit._ij_dev[2] == kwarg._ij_dev[2] == ref._ij_dev[2]
    for k in (0, 1):
        np.testing.assert_array_equal(_np(auto._ij_dev[k]), _np(explicit._ij_dev[k]))
        np.testing.assert_array_equal(_np(auto._ij_dev[k]), np.asarray(ref._ij_dev[k]))
    assert auto.evals == ref.evals
    np.testing.assert_array_equal(auto.neighbor_graph[0], ref.neighbor_graph[0])
    bf = att.BruteForce(X, "euclidean", device="cpu")
    bf.fit()
    assert att.compare_neighbor_graphs(bf.neighbor_graph, auto.neighbor_graph, 10) <= 2


def test_non_metric_sparse_fit_equals_jax(scale_env):
    """A non-metric fit on the scale path takes the admit-everything build
    in both packages: the same pairs, evals and graph."""
    X, _ = make_strings(n=400, n_clusters=8, length=60, mutation_rate=0.02, seed=5,
                        evolve=True)
    X = list(X)
    kw = dict(n_anchors=12, n_neighbors=10, n_samples=900, p_work=0.15, random_seed=42,
              loc_thresh=3, is_metric=False)
    ref = at.Annchor(X, "levenshtein", **kw)
    ref.fit()
    port = att.Annchor(X, "levenshtein", device="cpu", uniforms=jax_threefry_uniforms, **kw)
    port.fit()
    assert port._locality_info == {"build": "admit", "admitted": ref._ij_dev[2]}
    assert port._dev.sparse
    np.testing.assert_array_equal(_np(port._ij_dev[0]), np.asarray(ref._ij_dev[0]))
    np.testing.assert_array_equal(_np(port._ij_dev[1]), np.asarray(ref._ij_dev[1]))
    np.testing.assert_array_equal(port.P_cnt, ref.P_cnt)
    assert port.evals == ref.evals
    np.testing.assert_array_equal(port.neighbor_graph[0], ref.neighbor_graph[0])
    np.testing.assert_array_equal(port.neighbor_graph[1], ref.neighbor_graph[1])


def test_rms_score_panel_close_to_jax():
    """The rms panel against the JAX package's ``_band_score``.  Both round
    their sums to float32, in other orders, so l2sq = |a|^2 + |b|^2 - 2ab
    differs by a few float32 ulps of |a|^2 + |b|^2 before its
    cancellation, and sqrt(x + e) - sqrt(x) <= sqrt(e): the bound below is
    sqrt(8 eps max(|a|^2 + |b|^2) / na).  linf is order-free and
    bit-equal."""
    rng = np.random.default_rng(11)
    Db = (rng.random((300, 96)) * 50).astype(np.float32)
    Dc = np.concatenate([Db[:40] + 1e-3, (rng.random((200, 96)) * 50).astype(np.float32)])
    got = _np(tloc._band_score(torch.from_numpy(Db), torch.from_numpy(Dc), "rms"))
    want = np.asarray(jloc._band_score(Db, Dc, "rms"))
    sq = (Db.astype(np.float64) ** 2).sum(1)[:, None] + (Dc.astype(np.float64) ** 2).sum(1)[None]
    bound = np.sqrt(8 * np.finfo(np.float32).eps * sq.max() / 96)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= bound
    exact = np.sqrt(((Db.astype(np.float64)[:, None] - Dc[None]) ** 2).mean(axis=2))
    assert np.abs(got - exact).max() <= bound
    lin = _np(tloc._band_score(torch.from_numpy(Db), torch.from_numpy(Dc), "linf"))
    np.testing.assert_array_equal(lin, np.asarray(jloc._band_score(Db, Dc, "linf")))


def test_rms_build_score(scale_env, monkeypatch):
    """Port of tests/test_scale_path.py::test_rms_build_score: at a huge
    cap the thresholds are +inf, so rms tracks the linf set; at a tight
    cap the rms fit stays within the JAX test's family bound of the linf
    fit's errors.  An unknown score is refused."""
    from sklearn.datasets import make_blobs

    X, _ = make_blobs(n_samples=700, centers=7, n_features=5, random_state=7)

    def fit(cap, score, whole=True):
        monkeypatch.setenv("ANNCHOR_TPU_PAIR_CAP", str(cap))
        monkeypatch.setenv("ANNCHOR_TPU_BUILD_SCORE", score)
        ann = att.Annchor(X, "euclidean", n_anchors=12, n_neighbors=8, n_samples=900,
                          p_work=0.2, random_seed=42, device="cpu",
                          uniforms=jax_threefry_uniforms)
        if whole:
            ann.fit()
        else:
            ann.get_anchors()
            ann.get_locality()
        return ann

    # the same tracked set, so the same fit
    huge = fit(100000, "linf", False), fit(100000, "rms", False)
    for k in (0, 1):
        np.testing.assert_array_equal(_np(huge[0]._ij_dev[k]), _np(huge[1]._ij_dev[k]))
    lin, rms = fit(50, "linf"), fit(50, "rms")
    assert rms.evals <= int(rms.p_work * rms.N)
    bf = att.BruteForce(X, "euclidean", device="cpu")
    bf.fit()
    err_l = att.compare_neighbor_graphs(bf.neighbor_graph, lin.neighbor_graph, 8)
    err_r = att.compare_neighbor_graphs(bf.neighbor_graph, rms.neighbor_graph, 8)
    assert err_r <= max(2 * err_l, err_l + 20)
    monkeypatch.setenv("ANNCHOR_TPU_BUILD_SCORE", "l2")
    with pytest.raises(ValueError, match="linf"):
        tloc.candidate_pairs_device_budgeted(np.eye(40, 8), 5, 2, 10, 20)
