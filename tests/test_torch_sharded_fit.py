"""The port's multi-device fit (``ops/sharded_fit.py``) on the CPU.

Port of ``tests/test_sharded_fit.py`` (whose JAX tests are slow; these
are not): a fit whose pair state is sharded over a mesh of 2, 3 or 8
shards (``ANNCHOR_TPU_MESH_DEVICES`` on the one CPU device) must report
the single-device fit's graph, bit for bit, with the same evaluations,
whenever both track the same pair set (the scale path's derived pair cap
scales with the mesh, so those fits pin ``ANNCHOR_TPU_PAIR_CAP``).  The
dense fit is also held to the JAX package's fit, which this test
session runs sharded over its 8 virtual CPU devices.
"""

import contextlib
import os

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

import annchor_tpu as at
import annchor_tpu_torch as att
from annchor_tpu_torch import parallel
from annchor_tpu_torch.datasets import make_strings
from annchor_tpu_torch.ops import locality as tloc
from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms

torch.set_num_threads(2)

_KEYS = ("ANNCHOR_TPU_MESH_DEVICES", "ANNCHOR_TPU_DISABLE_SHARDING",
         "ANNCHOR_TPU_FORCE_SPARSE", "ANNCHOR_TPU_PAIR_CAP", "ANNCHOR_TPU_NO_SHARDED_BUILD",
         "ANNCHOR_TPU_BUILD_SCORE")


@contextlib.contextmanager
def _env(**kw):
    """The mesh variables set as given and every other one unset."""
    saved = {k: os.environ.pop(k, None) for k in _KEYS}
    os.environ.update({k: str(v) for k, v in kw.items()})
    try:
        yield
    finally:
        for k in _KEYS:
            os.environ.pop(k, None)
            if saved[k] is not None:
                os.environ[k] = saved[k]


def _fit(X, mesh=None, **kw):
    """A port fit on the CPU over a mesh of ``mesh`` shards (None: one
    device), drawing the JAX package's sample stream."""
    env = dict(kw.pop("env", {}))
    if mesh:
        env["ANNCHOR_TPU_MESH_DEVICES"] = mesh
    with _env(**env):
        ann = att.Annchor(X, device="cpu", uniforms=jax_threefry_uniforms, **kw)
        ann.fit()
    assert (ann._dev.shard is not None) == bool(mesh)
    if mesh:
        assert ann._dev.shard.s == mesh
    return ann


def _same(a, b):
    np.testing.assert_array_equal(a.neighbor_graph[0], b.neighbor_graph[0])
    np.testing.assert_array_equal(a.neighbor_graph[1], b.neighbor_graph[1])
    assert a.evals == b.evals


BLOBS_KW = dict(func="euclidean", n_anchors=12, n_neighbors=10, n_samples=800,
                p_work=0.2, random_seed=42)
MESHES = pytest.mark.parametrize("s", [2, 3, 8])


@pytest.fixture(scope="module")
def blobs():
    X, y = make_blobs(n_samples=500, n_features=5, centers=6, random_state=2)
    return X, y, _fit(X, **BLOBS_KW)


@pytest.fixture(scope="module")
def blobs_jax(blobs):
    """The JAX package's fit, sharded over its 8 virtual CPU devices."""
    with _env():
        ref = at.Annchor(blobs[0], **BLOBS_KW)
        ref.fit()
    assert ref._dev.shard is not None and ref._dev.shard.s == 8
    return ref


@MESHES
def test_dense_fit_matches_single_device_and_jax(blobs, blobs_jax, s):
    """The dense device pipeline: the sharded fit's graph is the
    single-device fit's, bit for bit, with the same evals; and the JAX
    package's 8-device fit's (indices and evals equal, distances within
    the vector engine's 8 float32 ulps, tests/test_torch_annchor.py)."""
    X, _, single = blobs
    sharded = _fit(X, mesh=s, **BLOBS_KW)
    _same(sharded, single)
    dev = sharded._dev
    assert [t.shape[0] for t in dev.RA] == [dev.m_pad // s] * s
    ref = blobs_jax
    np.testing.assert_array_equal(sharded.neighbor_graph[0], ref.neighbor_graph[0])
    assert sharded.evals == ref.evals
    want = ref.neighbor_graph[1]
    assert np.all(np.abs(sharded.neighbor_graph[1] - want)
                  <= 8 * np.spacing(np.abs(want).astype(np.float32)))


STRINGS_KW = dict(func="levenshtein", n_anchors=12, n_neighbors=8, n_samples=800,
                  p_work=0.3, random_seed=42,
                  env={"ANNCHOR_TPU_FORCE_SPARSE": 1, "ANNCHOR_TPU_PAIR_CAP": 64})


@pytest.fixture(scope="module")
def strings():
    X, y = make_strings(n=300, length=60, seed=7)
    X = list(X)
    return X, y, _fit(X, **STRINGS_KW)


@pytest.mark.parametrize("s", [3, 8])
def test_sparse_fit_matches_single_device(strings, s):
    """The scale path (device-built pair list, sparse state) at a pinned
    cap: the same graph and evals, with each shard holding m_pad / s
    pairs and nx_pad / s incidence rows."""
    X, _, single = strings
    sharded = _fit(X, mesh=s, **STRINGS_KW)
    _same(sharded, single)
    dev = sharded._dev
    assert dev.sparse and dev.m == single._dev.m
    assert dev.m_pad % s == 0 and dev.shard.nx_pad % s == 0
    for arr in (dev.RA, dev.ncm, dev.lb, dev.ub, dev.dad, dev.ij_i, dev.ij_j):
        assert [t.shape[0] for t in arr] == [dev.m_pad // s] * s
    assert [t.shape[0] for t in dev.P_idx_d] == [dev.shard.nx_pad // s] * s


def test_mesh_scales_the_derived_cap(strings):
    """Without a pinned cap the derived cap, and so the tracked set,
    grows with the mesh (JAX ``Annchor._mesh_scale``)."""
    X, _, _ = strings
    kw = dict(STRINGS_KW, env={"ANNCHOR_TPU_FORCE_SPARSE": 1})
    sizes = []
    for s in (None, 3):
        with _env(**kw["env"], **({"ANNCHOR_TPU_MESH_DEVICES": s} if s else {})):
            ann = att.Annchor(X, device="cpu", **{k: v for k, v in kw.items()
                                                  if k != "env"})
            assert ann._mesh_scale() == (s or 1)
            ann.get_anchors()
            ann.get_locality()
            sizes.append((ann._derived_pair_cap(), ann._ij_dev[2]))
    assert sizes[1][0] > sizes[0][0] and sizes[1][1] > sizes[0][1]


@MESHES
@pytest.mark.parametrize("nx,block,loc_min", [(900, 256, 30), (700, 256, 30),
                                              (768, 256, 800), (700, 256, 800)],
                         ids=["bands", "padded", "zero-thr", "zero-thr-padded"])
def test_sharded_budgeted_build(s, nx, block, loc_min):
    """The budgeted band build dealt out over the mesh equals the
    single-device band loop: pair list and order, m and P_cnt, with
    several bands per shard, column padding and, with loc_min >= nx,
    every threshold 0 (ROADMAP F6: no padding column is admitted)."""
    D = np.random.default_rng(nx + block).random((nx, 16))
    with _env(ANNCHOR_TPU_MESH_DEVICES=s):
        got = tloc.candidate_pairs_device_budgeted(D, 5, 2, loc_min, 40, block=block)
    with _env():
        want = tloc.candidate_pairs_device_budgeted(D, 5, 2, loc_min, 40, block=block)
    assert got[2] == want[2] > 0
    for k in (0, 1, 3, 4, 5, 6):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    assert int(got[1].max()) < nx


def test_sharded_build_refuses_rms():
    """ROADMAP F3: the JAX package drops the rms score for linf on a mesh
    unannounced; the port raises, naming the score and the mesh size."""
    D = np.random.default_rng(6).random((300, 8))
    with _env(ANNCHOR_TPU_MESH_DEVICES=3, ANNCHOR_TPU_BUILD_SCORE="rms"):
        with pytest.raises(ValueError, match="'rms'.*3 shards"):
            tloc.candidate_pairs_device_budgeted(D, 5, 2, 10, 40)
    with _env(ANNCHOR_TPU_MESH_DEVICES=3, ANNCHOR_TPU_BUILD_SCORE="rms",
              ANNCHOR_TPU_NO_SHARDED_BUILD=1):
        tloc.candidate_pairs_device_budgeted(D, 5, 2, 10, 40)  # one device: builds


@pytest.mark.parametrize("case", ["dense", "sparse"])
def test_extras_and_append_on_a_sharded_fit(blobs, strings, case):
    """The nearest enemies and the selective subset on a sharded fit
    equal the single-device results.  On the scale path the enemy
    candidates are appended to the state, which is split anew at the new
    m (the dense fit here already tracks every enemy candidate)."""
    X, y, _ = blobs if case == "dense" else strings
    kw = BLOBS_KW if case == "dense" else STRINGS_KW
    out = []
    for s in (None, 3):
        ann = _fit(X, mesh=s, **kw)
        m0 = ann._dev.m
        env = kw.get("env", {})
        with _env(**env, **({"ANNCHOR_TPU_MESH_DEVICES": s} if s else {})):
            ngi, ngd = ann.get_nearest_enemies(y, nn=2)
            dev = ann._dev
            assert dev.m > m0 or case == "dense"
            if s:
                assert [t.shape[0] for t in dev.RA] == [dev.m_pad // s] * s
                assert dev.m_pad == -(-dev.m // s) * s
            subset = ann.annchor_selective_subset(y)
        out.append((ngi, ngd, np.asarray(subset), ann.evals))
    (gi1, gd1, ss1, e1), (gi2, gd2, ss2, e2) = out
    np.testing.assert_array_equal(gi2, gi1)
    np.testing.assert_array_equal(gd2, gd1)
    np.testing.assert_array_equal(ss2, ss1)
    assert e1 == e2


def test_sharded_v2_save_loads_on_one_device(strings, tmp_path):
    """A sharded scale-path fit saves as v2 and loads into a
    single-device index with the same graph."""
    X, _, single = strings
    sharded = _fit(X, mesh=3, **STRINGS_KW)
    p = str(tmp_path / "sharded.npz")
    sharded.save(p)
    with _env():
        ann = att.Annchor.load(p, X, "levenshtein", device="cpu")
    np.testing.assert_array_equal(ann.neighbor_graph[0], single.neighbor_graph[0])
    np.testing.assert_array_equal(ann.neighbor_graph[1], single.neighbor_graph[1])
    assert ann.evals == single.evals
    assert int(np.load(p)["format"]) == 2


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip(n):
    with _env():
        parallel.dryrun_multichip(n, device="cpu")
