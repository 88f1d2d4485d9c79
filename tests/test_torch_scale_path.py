"""The scale path of the port (nx > 4096), held against the JAX package
on the CPU at small sizes.

``ANNCHOR_TPU_FORCE_SPARSE`` sends both packages down the scale path at
a few hundred points: the budgeted band build, the sparse fit state with
its exact store, and the post-fit graph-expansion refinement.  The JAX
package runs on one device (``ANNCHOR_TPU_DISABLE_SHARDING``): the
eight virtual CPU devices of the test run would otherwise send it down its
sharded twin, whose derived pair cap scales with the mesh.  The port
draws JAX's sample stream (``jax_threefry_uniforms``), so every integer
result must be equal: pair lists, incidence rows, eval counts and graph
indices.  The column tighten, which the fit runs only above 4,096
points, is held against ``_tighten_cols`` on a fit's own state.
"""

import os

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
from annchor_tpu_torch.ops.device_pipeline import ExactStore, jax_threefry_uniforms

torch.set_num_threads(2)

_ENV = {"ANNCHOR_TPU_FORCE_SPARSE": "1", "ANNCHOR_TPU_DISABLE_SHARDING": "1"}


@pytest.fixture(scope="module", autouse=True)
def _scale_env():
    saved = {k: os.environ.get(k) for k in _ENV}
    os.environ.update(_ENV)
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _blobs(n, seed):
    from sklearn.datasets import make_blobs

    X, _ = make_blobs(n_samples=n, centers=8, n_features=5, random_state=seed)
    return X


def _fit_pair(X, func, **kw):
    """The same fit in both packages: (JAX fit, port fit)."""
    ref = at.Annchor(X, func, **kw)
    ref.fit()
    port = att.Annchor(X, func, device="cpu", uniforms=jax_threefry_uniforms, **kw)
    port.fit()
    return ref, port


class Fits:
    """A fit in both packages, with their device states kept apart from
    the fits (a host read of the state drops ``ann._dev``)."""

    def __init__(self, X, func, **kw):
        self.X = X
        self.ref, self.port = _fit_pair(X, func, **kw)
        self.jdev, self.tdev = self.ref._dev, self.port._dev


def _assert_close(got, want, scale=None):
    """Equal, or within the vector engine's 8 float32 ulps of each value
    (the euclidean anchor columns differ from XLA's in the last bits,
    tests/test_torch_annchor.py), or of ``scale`` where values are
    differences of such distances."""
    want = np.asarray(want)
    ref = np.abs(want) if scale is None else np.float64(scale)
    assert np.all(np.abs(got - want) <= 8 * np.spacing(np.float32(ref)))


# ---------------------------------------------------------------------------
# locality: thresholds and the budgeted band build


@pytest.mark.parametrize("block", [4096, 256])
def test_effective_thresholds_match_jax(block):
    from annchor_tpu.ops.features import anchor_membership

    D = np.random.default_rng(3).random((700, 16))
    S, _ = anchor_membership(D, 5)
    want = jloc.effective_thresholds(S, 2, 30, block=block, locality=5)
    got = tloc.effective_thresholds(torch.tensor(np.asarray(S)), 2, 30, block=block,
                                    locality=5)
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize(
    "nx,block,cap",
    [(900, 4096, 40), (900, 256, 40), (700, 256, 25), (900, 256, 10**6)],
    ids=["one-band", "bands", "bands-padded", "bands-uncapped"],
)
def test_budgeted_build_matches_jax(nx, block, cap):
    """Pair order, m, P_cnt and the locality by-products, bit for bit,
    with one band (block >= nx) and with several."""
    D = np.random.default_rng(nx + block).random((nx, 16))
    want = jloc.candidate_pairs_device_budgeted(D, 5, 2, 30, cap, block=block)
    got = tloc.candidate_pairs_device_budgeted(D, 5, 2, 30, cap, block=block)
    assert got[2] == want[2]
    for k in (0, 1, 3, 4, 5, 6):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
    assert got[0].dtype == torch.int32 and got[6].dtype == np.int32
    assert (_np(got[0]) < _np(got[1])).all()


def test_budgeted_build_extraction_row_slices(monkeypatch):
    """The row-sliced extraction (``_EXTRACT_ELEMS`` shrunk to one row
    per slice) gives the JAX package's pair list."""
    D = np.random.default_rng(11).random((900, 16))
    want = jloc.candidate_pairs_device_budgeted(D, 5, 2, 30, 40, block=512)
    monkeypatch.setattr(tloc, "_EXTRACT_ELEMS", 1)
    got = tloc.candidate_pairs_device_budgeted(D, 5, 2, 30, 40, block=512)
    assert got[2] == want[2]
    for k in (0, 1, 6):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))


@pytest.mark.parametrize("nx", [768, 700], ids=["unpadded", "padded"])
def test_budgeted_build_zero_threshold(nx):
    """With loc_min >= nx every effective threshold is 0 and every pair
    is admitted.  Without column padding (nx a multiple of the band)
    the build is the JAX package's bit for bit; with padding the port
    masks the padded columns, which a zero threshold would otherwise
    admit (ROADMAP F6), so every pair stays inside the data set."""
    D = np.random.default_rng(1).random((nx, 16))
    got = tloc.candidate_pairs_device_budgeted(D, 5, 2, 800, 40, block=256)
    assert float(_np(got[5]).max()) == 0.0
    assert int(_np(got[1]).max()) < nx and got[6].sum() == 2 * got[2]
    if nx % 256 == 0:
        want = jloc.candidate_pairs_device_budgeted(D, 5, 2, 800, 40, block=256)
        assert got[2] == want[2]
        for k in (0, 1, 6):
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))


def test_rms_build_score_raises(monkeypatch):
    """The rms score builds (at a cap past every row's candidates it keeps
    the linf build's pairs); a score other than linf and rms raises."""
    D = np.random.default_rng(6).random((300, 8))
    lin = tloc.candidate_pairs_device_budgeted(D, 5, 2, 10, 10**4)
    monkeypatch.setenv("ANNCHOR_TPU_BUILD_SCORE", "rms")
    rms = tloc.candidate_pairs_device_budgeted(D, 5, 2, 10, 10**4)
    for k in (0, 1, 6):
        np.testing.assert_array_equal(_np(rms[k]), _np(lin[k]))
    monkeypatch.setenv("ANNCHOR_TPU_BUILD_SCORE", "dot")
    with pytest.raises(ValueError, match="rms"):
        tloc.candidate_pairs_device_budgeted(np.eye(40, 8), 5, 2, 10, 20)


# ---------------------------------------------------------------------------
# the exact store


def test_exact_store_roundtrip():
    """Port of tests/test_scale_path.py::test_exact_store_roundtrip."""
    s = ExactStore()
    assert np.all(np.isnan(s.lookup(np.array([0, 5]))))
    s.add(np.array([10, 3, 7]), np.array([1.0, 2.0, 3.0]))
    s.add(np.array([5, 20]), np.array([4.0, 5.0]))
    got = s.lookup(np.array([3, 5, 7, 10, 20, 11]))
    assert np.allclose(got[:5], [2.0, 4.0, 3.0, 1.0, 5.0])
    assert np.isnan(got[5])
    got2 = s.lookup(np.array([[3, 11], [20, 5]]))
    assert got2.shape == (2, 2)
    assert np.allclose(got2[[0, 1], [0, 1]], [2.0, 4.0])
    assert np.isnan(got2[0, 1])
    assert np.all(np.diff(s.ids) > 0)


def test_exact_store_dedupes_and_reports_new():
    """Port of tests/test_scale_path.py::
    test_exact_store_dedupes_and_reports_new, step for step against the
    JAX package's store."""
    ours, theirs = ExactStore(), jdp._ExactStore()
    steps = [([3, 5, 3], [1.0, 2.0, 9.0]), ([5, 7], [4.0, 6.0]), ([1, 7, 1], [8.0, 0.5, 2.0])]
    for ids, vals in steps:
        n = ours.add(np.array(ids), np.array(vals))
        assert n == theirs.add(np.array(ids), np.array(vals))
        np.testing.assert_array_equal(ours.ids, theirs.ids)
        np.testing.assert_array_equal(ours.vals, theirs.vals)
    assert ours.add(np.array([3, 5, 3]), np.array([1.0, 2.0, 9.0])) == 0
    np.testing.assert_array_equal(ours.lookup(np.array([1, 3, 5, 7])), [8.0, 1.0, 2.0, 0.5])


# ---------------------------------------------------------------------------
# whole fits


@pytest.fixture(scope="module")
def blobs_fits():
    """Euclidean blobs, the derived pair cap, refine_frac 0.1."""
    return Fits(_blobs(700, 7), "euclidean", n_anchors=12, n_neighbors=10,
                n_samples=900, p_work=0.2, random_seed=42, refine_frac=0.1)


@pytest.fixture(scope="module")
def strings_fits():
    """Evolve strings with an explicit pair cap."""
    X, _ = make_strings(n=600, n_clusters=8, length=80, mutation_rate=0.02, seed=3,
                        evolve=True)
    return Fits(list(X), "levenshtein", n_anchors=12, n_neighbors=10, n_samples=900,
                p_work=0.15, random_seed=42, pair_cap=90)


@pytest.fixture(params=["blobs", "strings"])
def fits(request, blobs_fits, strings_fits):
    return {"blobs": blobs_fits, "strings": strings_fits}[request.param]


def test_fit_matches_jax(fits):
    """Same tracked pairs, incidence matrix, evals and graph indices;
    distances equal (strings) or within 8 float32 ulps (blobs)."""
    ref, port = fits.ref, fits.port
    assert port._ij_dev[2] == ref._ij_dev[2]
    np.testing.assert_array_equal(_np(port._ij_dev[0]), np.asarray(ref._ij_dev[0]))
    np.testing.assert_array_equal(_np(port._ij_dev[1]), np.asarray(ref._ij_dev[1]))
    np.testing.assert_array_equal(port.P_cnt, ref.P_cnt)
    np.testing.assert_array_equal(_np(fits.tdev.P_idx_d), np.asarray(fits.jdev.P_idx_d))
    assert port.evals == ref.evals
    np.testing.assert_array_equal(port.neighbor_graph[0], ref.neighbor_graph[0])
    _assert_close(port.neighbor_graph[1], ref.neighbor_graph[1])
    np.testing.assert_array_equal(port._ng_exact, ref._ng_exact)


def test_fit_keeps_pairs_on_device(fits):
    port, tdev = fits.port, fits.tdev
    assert port._IJs is None and tdev.sparse
    assert not hasattr(tdev, "ncm_host") and not hasattr(tdev, "exact64")
    # the store holds the computed pairs: the JAX package's own set on
    # strings (exact integer distances), as many of them on blobs (ulp
    # differences in the estimates reorder tied selection probabilities)
    assert tdev.exact.ids.shape == fits.jdev.exact.ids.shape
    if isinstance(fits.X, list):
        np.testing.assert_array_equal(tdev.exact.ids, fits.jdev.exact.ids)


def test_scale_defaults_match_jax():
    """Above 4,096 points unset knobs take the JAX package's scale
    defaults; at 4,096 the reference's."""
    for n, want in [(4097, (48, 3, 4, 0.05)), (4096, (20, 1, 2, 0.0)),
                    (90_000, (96, 3, 4, 0.05))]:
        X = ["ab"] * n
        port = att.Annchor(X, "levenshtein", device="cpu")
        ref = at.Annchor(X, "levenshtein")
        for ann in (port, ref):
            assert (ann.n_anchors, ann.loc_thresh, ann.niters, ann.refine_frac) == want
        assert port._p_work_fit == ref._p_work_fit
        assert port.refine_rounds == ref.refine_rounds == 3


def test_fit_materialises_like_jax(fits):
    """The lazy host surfaces of a sparse fit, as in the JAX package's
    test_sparse_fit_matches_host_pipeline: IJs, features, RefineApprox
    and not_computed_mask materialise consistently."""
    X, ref, port = fits.X, fits.ref, fits.port
    IJs = port.IJs
    np.testing.assert_array_equal(IJs, ref.IJs)
    ncm = port.not_computed_mask  # read before the sync drops the state
    assert ncm.sum() == ref.not_computed_mask.sum()
    feats = port.features
    assert port._dev is None and feats.shape == (IJs.shape[0], 4)
    np.testing.assert_array_equal(port.not_computed_mask, ncm)
    np.testing.assert_array_equal(feats[:, 3], ref.features[:, 3])
    _assert_close(feats[:, 2], ref.features[:, 2], scale=np.abs(port.D).max())
    RA = port.RefineApprox
    if isinstance(X, list):  # strings: the same computed set, so the same bounds
        np.testing.assert_array_equal(ncm, ref.not_computed_mask)
        np.testing.assert_array_equal(feats, ref.features)
        np.testing.assert_array_equal(RA[~ncm], ref.RefineApprox[~ncm])
    exact = port.metric.batch(X, X, IJs[~ncm])
    np.testing.assert_array_equal(RA[~ncm], exact)
    assert (feats[:, 0] <= RA + 1e-4).all() and (RA <= feats[:, 1] + 1e-4).all()
    assert isinstance(port.S, np.ndarray) and port.S.shape == (len(X), 12)
    np.testing.assert_array_equal(port.loc_eff, np.asarray(ref.loc_eff))


def test_refine_frac_spends_the_held_back_budget(blobs_fits):
    ref, port = blobs_fits.ref, blobs_fits.port
    assert port.evals <= int(port.p_work * port.N)
    stages = [s["stage"] for s in port._refine_stats]
    assert stages == [s["stage"] for s in ref._refine_stats] and stages[0] == "certify"
    assert [s.get("evals") for s in port._refine_stats] == [
        s.get("evals") for s in ref._refine_stats]


def test_pair_cap_ctor_kwarg_matches_env(strings_fits, monkeypatch):
    """Port of tests/test_scale_path.py::test_pair_cap_ctor_kwarg_matches_env:
    the ``pair_cap`` keyword and ``ANNCHOR_TPU_PAIR_CAP`` build the same
    tracked set and fit."""
    X, by_kwarg = strings_fits.X, strings_fits.port
    monkeypatch.setenv("ANNCHOR_TPU_PAIR_CAP", "90")
    by_env = att.Annchor(X, "levenshtein", n_anchors=12, n_neighbors=10, n_samples=900,
                         p_work=0.15, random_seed=42, device="cpu",
                         uniforms=jax_threefry_uniforms)
    by_env.fit()
    assert by_env.evals == by_kwarg.evals
    np.testing.assert_array_equal(_np(by_env._ij_dev[0]), _np(by_kwarg._ij_dev[0]))
    np.testing.assert_array_equal(by_env.neighbor_graph[0], by_kwarg.neighbor_graph[0])
    np.testing.assert_array_equal(by_env.neighbor_graph[1], by_kwarg.neighbor_graph[1])


def test_pair_cap_factor_ctor_kwarg():
    """Port of tests/test_scale_path.py::test_pair_cap_factor_ctor_kwarg:
    the factor tunes the derived cap, and so the tracked pair count."""
    X = _blobs(700, 7)
    kw = dict(n_anchors=12, n_neighbors=10, n_samples=900, p_work=0.2, random_seed=42,
              device="cpu")
    sizes = []
    for factor in (0.3, 0.9):
        ann = att.Annchor(X, "euclidean", pair_cap_factor=factor, **kw)
        ann.get_anchors()
        ann.get_locality()
        sizes.append(ann._ij_dev[2])
    assert sizes[0] < sizes[1]


# ---------------------------------------------------------------------------
# incidence matrix and column tighten on a fit's state


@pytest.mark.parametrize("capped", [False, True], ids=["uncapped", "capped"])
def test_pidx_matches_jax(strings_fits, capped, monkeypatch):
    """The device incidence matrix bit for bit, uncapped and with
    ANNCHOR_TPU_PIDX_BUDGET = 64 nx (the lower-bound-ordered capped
    build, two stable argsorts), rebuilt on each fit's final state."""
    jdev, tdev = strings_fits.jdev, strings_fits.tdev
    saved = [(d, d.P_idx_d, d._pidx_capped) for d in (jdev, tdev)]
    if capped:
        monkeypatch.setenv("ANNCHOR_TPU_PIDX_BUDGET", str(64 * len(strings_fits.X)))
    try:
        jdev._rebuild_pidx()
        tdev._rebuild_pidx()
        assert tdev._pidx_capped == capped == jdev._pidx_capped
        np.testing.assert_array_equal(_np(tdev.P_idx_d), np.asarray(jdev.P_idx_d))
    finally:
        for d, P, c in saved:
            d.P_idx_d, d._pidx_capped = P, c


@pytest.mark.parametrize("panel", ["scatter", "incidence"])
@pytest.mark.parametrize("col_chunk", [None, 48], ids=["one-pass", "passes"])
def test_tighten_cols_matches_jax(strings_fits, panel, col_chunk):
    """``tighten_cols`` against the JAX package's ``_tighten_cols``, lb
    and ub bit for bit: 120 pseudo-anchor columns (integer degrees, so
    many ties: the stable-sort rule H1) in one pass or in passes of 48
    (the last padded with repeats), the contenders in chunks of 500 and
    truncated at cmax, the panel built by pair scatter or from the
    uncapped incidence rows.  The state is a strings fit's, with 60 % of
    its pairs marked uncomputed so that thousands contend."""
    st = strings_fits.jdev
    assert st.thresh is not None and not st._pidx_capped
    args = [np.asarray(a) for a in (st.ij_i, st.ij_j, st.RA, st.ncm, st.lb, st.ub,
                                    st.thresh)]
    args[3] = np.random.default_rng(5).random(args[3].shape[0]) < 0.6
    cap = np.maximum(args[6][args[0]], args[6][args[1]])
    n_cont = int((args[3] & (args[4] < cap)).sum())
    kw = dict(ncol=120, cmax=n_cont - 7, chunk=500, col_chunk=col_chunk)
    pidx = np.asarray(st.P_idx_d) if panel == "incidence" else None
    want = jdp._tighten_cols(*args, P_idx=pidx, **kw)
    got = tdp.tighten_cols(*(torch.tensor(a) for a in args),
                           P_idx=None if pidx is None else torch.tensor(pidx), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert (_np(got[0]) > args[4]).any()  # the tighten moved some bounds


# ---------------------------------------------------------------------------
# post-fit refinement


@pytest.fixture(scope="module")
def refined():
    """A fit starved by a tight pair cap, then refine_neighbor_graph
    (rounds=2, budget=3000) in both packages (port of
    tests/test_scale_path.py::test_refine_graph_invariants)."""
    X = _blobs(500, 3)
    ref, port = _fit_pair(X, "euclidean", n_anchors=10, n_neighbors=8, n_samples=600,
                          p_work=0.2, random_seed=1, pair_cap=30, refine_frac=0.0)
    before = port.neighbor_graph[0].copy(), port.evals
    assert ref.evals == port.evals
    np.testing.assert_array_equal(ref.neighbor_graph[0], before[0])
    ref.refine_neighbor_graph(rounds=2, budget=3000)
    port.refine_neighbor_graph(rounds=2, budget=3000)
    return X, ref, port, before


def test_refine_matches_jax(refined):
    X, ref, port, (gi0, evals0) = refined
    assert port.evals == ref.evals and 0 < port.evals - evals0 <= 3000
    np.testing.assert_array_equal(port.neighbor_graph[0], ref.neighbor_graph[0])
    _assert_close(port.neighbor_graph[1], ref.neighbor_graph[1])
    np.testing.assert_array_equal(port._ng_exact, ref._ng_exact)
    strip = [{k: s.get(k) for k in ("stage", "evals", "eval_batches")}
             for s in port._refine_stats]
    assert strip == [{k: s.get(k) for k in ("stage", "evals", "eval_batches")}
                     for s in ref._refine_stats]
    assert not (port.neighbor_graph[0] == gi0).all()  # refinement changed edges


def test_refine_graph_invariants(refined):
    """Refined rows are self-prepended, ascending, free of duplicate
    partners, and never worse than before under the exact metric."""
    X, _, port, (gi0, _) = refined
    gi, gd = port.neighbor_graph
    stats = port._refine_stats
    assert stats and stats[0]["stage"] == "certify"
    assert all("wall_s" in s for s in stats)
    assert sum(s.get("evals", 0) for s in stats) <= 3000
    assert (gi[:, 0] == np.arange(500)).all() and (gd[:, 0] == 0).all()
    assert (np.diff(gd[:, 1:], axis=1) >= 0).all()
    for r in range(0, 500, 37):
        row = gi[r][gi[r] >= 0]
        assert len(set(row.tolist())) == len(row)
    D = np.linalg.norm(X[:, None, :] - X[None, :, :], axis=2)
    true_k0 = D[np.arange(500)[:, None], gi0[:, 1:]].max(axis=1)
    true_k1 = D[np.arange(500)[:, None], gi[:, 1:]].max(axis=1)
    assert (true_k1 <= true_k0 + 1e-9).mean() > 0.97
    assert port._ng_exact.shape == gi.shape


def test_refine_default_budget_and_device_screen(refined, monkeypatch):
    """The default budget is the unspent p_work allowance; the device
    screen, forced on the CPU, refines exactly as the host screen does."""
    X, _, port, _ = refined
    allowance = max(0, int(port.p_work * port.N) - port.evals)
    ev0 = port.evals
    fitted = (port.neighbor_graph, port._ng_exact, port.evals)
    port.refine_neighbor_graph(rounds=1)
    assert port.evals - ev0 <= allowance
    host = (port.neighbor_graph, port._ng_exact, port.evals)
    port.neighbor_graph, port._ng_exact, port.evals = fitted
    monkeypatch.setenv("ANNCHOR_TPU_FORCE_DEVICE_EXPAND", "1")
    port.refine_neighbor_graph(rounds=1)
    assert port.evals == host[2]
    for got, want in zip((*port.neighbor_graph, port._ng_exact), (*host[0], host[1])):
        np.testing.assert_array_equal(got, want)
    assert all("screen_dev_s" in s for s in port._refine_stats[1:])
