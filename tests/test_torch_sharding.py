"""The port's device mesh (``annchor_tpu_torch/parallel``), its sharded
metric engines and each ``ShardedFit`` stage program, on the CPU.

A mesh here is several shards on the one CPU device (the port's
counterpart of the JAX test session's 8 virtual CPU devices).  Every
sharded program must give the single-device function's result bit for
bit, on a state whose pair and point counts are not multiples of the
mesh size (the sentinel padding) and whose values tie often (the
selection's merge order).  The engines are also held to the JAX
package's ``m.batch`` under its 8-device mesh (port of
``tests/test_sharding.py``).
"""

import numpy as np
import pytest
import torch

from annchor_tpu_torch import parallel
from annchor_tpu_torch._backend import Kernel, shard_scope
from annchor_tpu_torch.metrics import get_function_from_input
from annchor_tpu_torch.ops import device_pipeline as dp
from annchor_tpu_torch.ops.sharded_fit import ShardedFit

torch.set_num_threads(2)

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# the mesh and its variables


def test_mesh_for_repeats_devices():
    m = parallel.mesh_for(4, devices=[CPU])
    assert m.size == 4 and m.devices == (CPU,) * 4 and m.distinct == (CPU,)
    assert m.axis_names == (parallel.PAIR_AXIS,)
    assert parallel.mesh_for(3, devices=["cpu", "meta"]).devices == (
        CPU, torch.device("meta"), CPU)


def test_auto_mesh_variables(monkeypatch):
    monkeypatch.delenv("ANNCHOR_TPU_DISABLE_SHARDING", raising=False)
    monkeypatch.delenv("ANNCHOR_TPU_MESH_DEVICES", raising=False)
    assert parallel.auto_mesh("cpu") is None  # one device: the single-device fit
    monkeypatch.setenv("ANNCHOR_TPU_MESH_DEVICES", "1")
    assert parallel.auto_mesh("cpu") is None
    monkeypatch.setenv("ANNCHOR_TPU_MESH_DEVICES", "3")
    assert parallel.auto_mesh("cpu") == parallel.Mesh([CPU] * 3)
    monkeypatch.setenv("ANNCHOR_TPU_DISABLE_SHARDING", "1")
    assert parallel.auto_mesh("cpu") is None


def test_auto_mesh_on_cards(monkeypatch):
    """Several cards: every card from the fit's own, round-robin when
    more shards are asked for; one card: no mesh unless asked for."""
    monkeypatch.delenv("ANNCHOR_TPU_DISABLE_SHARDING", raising=False)
    monkeypatch.delenv("ANNCHOR_TPU_MESH_DEVICES", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cards = [torch.device("cuda", k) for k in (1, 2, 0)]
    assert parallel.auto_mesh("cuda:1").devices == tuple(cards)
    monkeypatch.setenv("ANNCHOR_TPU_MESH_DEVICES", "4")
    assert parallel.auto_mesh("cuda:1").devices == tuple(cards + cards[:1])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert parallel.auto_mesh("cuda:0").devices == (torch.device("cuda", 0),) * 4
    monkeypatch.delenv("ANNCHOR_TPU_MESH_DEVICES")
    assert parallel.auto_mesh("cuda:0") is None


@pytest.mark.parametrize("n,multiple", [(10, 8), (16, 8), (7, 3), (1, 4)])
def test_pad_to_multiple_matches_jax(n, multiple):
    from annchor_tpu import parallel as jpar

    a = np.arange(n)
    b = np.arange(2 * n).reshape(n, 2)
    got, gn = parallel.pad_to_multiple([a, b], multiple)
    want, wn = jpar.pad_to_multiple([a, b], multiple)
    assert gn == wn == n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("s", [2, 3, 8])
def test_collectives_match_numpy(s):
    rng = np.random.default_rng(s)
    parts = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(s)]
    tparts = [torch.tensor(p) for p in parts]
    devs = [CPU] * s
    for got, want in (
        (parallel.all_gather(tparts, devs), np.concatenate(parts)),
        (parallel.psum(tparts, devs), np.sum(parts, axis=0, dtype=np.float32)),
        (parallel.pmax(tparts, devs), np.max(parts, axis=0)),
        (parallel.pmin(tparts, devs), np.min(parts, axis=0)),
        (parallel.broadcast(tparts[0], devs), parts[0]),
    ):
        assert len(got) == s
        assert all(g is got[0] for g in got)  # one copy per distinct device
        np.testing.assert_array_equal(got[0].numpy(), want)
    ints = [torch.tensor(rng.integers(0, 9, 50)) for _ in range(s)]
    np.testing.assert_array_equal(parallel.psum(ints)[0].numpy(),
                                  np.sum([t.numpy() for t in ints], axis=0))


def test_sharded_pair_kernel_and_shard_counts():
    """The canonical pattern (dataset replicated, pairs split) equals the
    unsharded kernel, and a kernel counts each launch toward the shard
    whose slice it ran."""
    rng = np.random.default_rng(42)
    X = rng.normal(size=(50, 4)).astype(np.float32)
    I = rng.integers(0, 50, size=64)
    J = rng.integers(0, 50, size=64)
    k = Kernel("probe", "probe.cu", {}, modes=("thread",))

    def kern(X, I, J):
        k.count("thread")
        return torch.sqrt(((X[I] - X[J]) ** 2).sum(dim=1))

    run = parallel.sharded_pair_kernel(kern, parallel.mesh_for(8, devices=[CPU]), 1)
    got = run(X, I, J).numpy()
    want = np.linalg.norm(X[I] - X[J], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert k.shard_launches == {c: 1 for c in range(8)} and k.launches == 8
    with shard_scope(3):
        k.count("thread")
    assert k.shard_launches[3] == 2
    k.reset_counts()
    assert k.shard_launches == {} and k.launches == 0
    with pytest.raises(ValueError, match="multiple"):
        run(X, I[:63], J[:63])


# ---------------------------------------------------------------------------
# the sharded metric engines


@pytest.fixture()
def jax_mesh(cpu_devices, monkeypatch):
    """The JAX package's engines under its 8-device mesh (as
    tests/test_sharding.py runs them)."""
    from annchor_tpu import parallel as jpar

    mesh = jpar.mesh_for(8, devices=cpu_devices)
    monkeypatch.setattr(jpar, "auto_mesh", lambda: mesh)
    return mesh


@pytest.mark.parametrize("s", [2, 3, 8])
def test_euclidean_engine_sharded(s, jax_mesh, monkeypatch):
    from annchor_tpu.metrics import get_function_from_input as jget

    rng = np.random.default_rng(s)
    X = rng.normal(size=(64, 5))
    IJ = rng.integers(0, 64, size=(101, 2))
    monkeypatch.delenv("ANNCHOR_TPU_MESH_DEVICES", raising=False)
    plain = get_function_from_input("euclidean", device="cpu").batch
    want = plain(X, X, IJ)
    monkeypatch.setenv("ANNCHOR_TPU_MESH_DEVICES", str(s))
    eng = get_function_from_input("euclidean", device="cpu").batch
    np.testing.assert_array_equal(eng(X, X, IJ), want)
    I, J = torch.tensor(IJ[:, 0]), torch.tensor(IJ[:, 1])
    np.testing.assert_array_equal(eng.batch_dev(X, I, J).numpy(),
                                  plain.batch_dev(X, I, J).numpy())
    # the JAX engine under its mesh: the vector engine's 8 float32 ulps
    jw = jget("euclidean", None).batch(X, X, IJ)
    assert np.all(np.abs(want - jw) <= 8 * np.spacing(np.float32(np.abs(jw))))


@pytest.mark.parametrize("s", [2, 3, 8])
def test_levenshtein_engine_sharded(s, jax_mesh, monkeypatch):
    from annchor_tpu.metrics import get_function_from_input as jget

    rng = np.random.default_rng(42)
    strs = ["".join(rng.choice(list("abcd"), size=int(rng.integers(5, 60))))
            for _ in range(40)]
    Q = strs[:7]
    IJ = rng.integers(0, 40, size=(333, 2))
    IJq = np.stack([rng.integers(0, 40, 50), rng.integers(0, 7, 50)], axis=1)
    monkeypatch.delenv("ANNCHOR_TPU_MESH_DEVICES", raising=False)
    plain = get_function_from_input("levenshtein", device="cpu").batch
    want, want_q = plain(strs, strs, IJ), plain(strs, Q, IJq)
    monkeypatch.setenv("ANNCHOR_TPU_MESH_DEVICES", str(s))
    eng = get_function_from_input("levenshtein", device="cpu").batch
    np.testing.assert_array_equal(eng(strs, strs, IJ), want)
    np.testing.assert_array_equal(eng(strs, Q, IJq), want_q)
    I, J = torch.tensor(IJ[:, 0]), torch.tensor(IJ[:, 1])
    np.testing.assert_array_equal(eng.batch_dev(strs, I, J).numpy(), want.astype(np.float32))
    assert eng.batch_dev(strs, I[:0], J[:0]).shape == (0,)
    np.testing.assert_array_equal(want, jget("levenshtein", None).batch(strs, strs, IJ))


# ---------------------------------------------------------------------------
# the ShardedFit stage programs on one random state


NX, M = 203, 4999  # neither a multiple of 2, 3 or 8


class State:
    """A random single-device fit state: m unique pairs i < j in
    row-major order, anchor columns, estimates on a coarse grid (so
    thresholds and probabilities tie), 60 % of the pairs uncomputed."""

    def __init__(self, seed=7):
        rng = np.random.default_rng(seed)
        keys = np.sort(rng.choice(NX * NX, size=4 * M, replace=False))
        a, b = keys // NX, keys % NX
        ok = a < b
        ij = np.stack([a[ok], b[ok]], axis=1)[:M]
        assert ij.shape[0] == M
        self.ij_i = torch.tensor(ij[:, 0], dtype=torch.int32)
        self.ij_j = torch.tensor(ij[:, 1], dtype=torch.int32)
        self.D = torch.tensor(rng.random((NX, 6)), dtype=torch.float32)
        self.lb, self.ub, self.dad = dp.features(self.D, self.ij_i, self.ij_j, 1000)
        self.RA = torch.tensor(np.round(rng.random(M) * 8) / 4, dtype=torch.float32)
        self.ncm = torch.tensor(rng.random(M) < 0.6)
        self.r = torch.tensor(rng.random(M), dtype=torch.float32)
        deg = np.bincount(ij.ravel(), minlength=NX)
        self.max_deg = int(deg.max())
        self.P_idx = dp.pidx_from_pairs(self.ij_i, self.ij_j, NX, self.max_deg)
        self.thresh = torch.tensor(np.round(rng.random(NX) * 8) / 4 + 0.5,
                                   dtype=torch.float32)
        K, G = 4, 16
        self.inner = torch.tensor([0.5, 1.0, 1.5], dtype=torch.float32)
        grid = np.sort(np.round(rng.random((K, G)) * 4) / 4, axis=1)
        self.cdf = (torch.tensor(grid, dtype=torch.float32),
                    torch.full((K,), -1.0), torch.full((K,), (G - 1) / 2.0),
                    torch.full((K,), 1.0))
        self.y = torch.tensor(rng.integers(0, 3, NX))


@pytest.fixture(scope="module")
def st():
    return State()


def _sharded(st, s):
    mesh = parallel.mesh_for(s, devices=[CPU])
    m_pad, nx_pad = -(-M // s) * s, -(-NX // s) * s
    sf = ShardedFit(mesh, M, m_pad, NX, nx_pad)
    put = {name: sf.put_pairs(getattr(st, name), fill) for name, fill in (
        ("ij_i", 0), ("ij_j", 0), ("lb", 0.0), ("ub", F32_INF), ("dad", 0.0),
        ("RA", F32_INF), ("ncm", False))}
    put["P_idx"] = sf.build_pidx(put["ij_i"], put["ij_j"], put["lb"], NX, st.max_deg, False)
    return sf, put


F32_INF = float("inf")
MESHES = pytest.mark.parametrize("s", [2, 3, 8])


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _pads(ids):
    """Pair ids with the sharded pad id m_pad read as the single-device
    pad id m."""
    return torch.where(ids >= M, M, ids)


@MESHES
def test_layout_and_features(st, s):
    sf, p = _sharded(st, s)
    assert [t.shape[0] for t in p["RA"]] == [sf.m_pad // s] * s
    assert [t.shape[0] for t in p["P_idx"]] == [sf.nx_pad // s] * s
    for got, want in zip(sf.features(st.D, p["ij_i"], p["ij_j"], 300),
                         (st.lb, st.ub, st.dad)):
        _eq(sf.real(got), want)


@MESHES
@pytest.mark.parametrize("capped", [False, True])
def test_build_pidx(st, s, capped):
    sf, p = _sharded(st, s)
    deg = 9 if capped else st.max_deg
    want = dp.pidx_from_pairs(st.ij_i, st.ij_j, NX, deg, lb=st.lb if capped else None)
    got = sf.full(sf.build_pidx(p["ij_i"], p["ij_j"], p["lb"], NX, deg, capped))
    assert (got[NX:] == sf.m_pad).all()
    _eq(_pads(got[:NX]), want)


@MESHES
@pytest.mark.parametrize("equal_mass", [False, True])
def test_sample_draw(st, s, equal_mass):
    sf, p = _sharded(st, s)
    pool = int(st.ncm.sum())
    r = torch.cat([st.r, torch.zeros(sf.m_pad - M)])
    want = dp.sample_draw(st.dad, st.ncm, st.r, 10, pool - 10, pool, (40, 40, 41),
                          equal_mass=equal_mass)
    got = sf.sample_draw(p["dad"], p["ncm"], r, 10, pool - 10, pool, (40, 40, 41),
                         equal_mass=equal_mass)
    for g, w in zip(got, want):
        _eq(g, w)


@MESHES
@pytest.mark.parametrize("init", [True, False])
def test_regress_update_and_scatters(st, s, init):
    sf, p = _sharded(st, s)
    sids = np.random.default_rng(s).choice(M, 300, replace=False)
    sy = np.random.default_rng(1).random(300)
    coefs = torch.tensor(np.random.default_rng(2).normal(size=(4, 3)), dtype=torch.float32)
    icepts = torch.tensor([0.1, -0.2, 0.3, 0.0])
    for metric in (True, False):
        want = dp.regress_update(st.lb, st.ub, st.dad, st.RA, st.ncm, st.inner, coefs,
                                 icepts, torch.tensor(sids), torch.tensor(sy,
                                 dtype=torch.float32), metric, init)
        got = sf.regress_update(p["lb"], p["ub"], p["dad"], p["RA"], p["ncm"], st.inner,
                                coefs, icepts, sids, sy, metric, init)
        for g, w in zip(got, want):
            _eq(sf.real(g), w)
        assert (sf.full(got[0])[M:] == F32_INF).all() and not sf.full(got[1])[M:].any()
    # exact values landed at device ids and at host ids
    ids = torch.tensor(np.random.default_rng(3).choice(M, 200, replace=False))
    vals = torch.rand(200)
    RA, ncm = st.RA.clone(), st.ncm.clone()
    dp.scatter_exact(RA, ncm, ids, vals)
    got = sf.scatter_exact(p["RA"], p["ncm"], ids, vals)
    _eq(sf.real(got[0]), RA)
    _eq(sf.real(got[1]), ncm)
    got = sf.scatter_exact_host([t.clone() for t in p["RA"]], [t.clone() for t in p["ncm"]],
                                ids.numpy(), vals.numpy())
    _eq(sf.real(got[0]), RA)
    _eq(sf.real(got[1]), ncm)
    loc = sf.localize(ids.numpy(), vals.numpy())
    RA2 = sf.override_rows([t.clone() for t in p["RA"]], loc)
    RA1 = st.RA.clone()
    RA1[ids] = vals
    _eq(sf.real(RA2), RA1)


@MESHES
def test_gather_pairs(st, s):
    sf, p = _sharded(st, s)
    ids = torch.tensor(np.random.default_rng(4).integers(0, M, 500))
    got = sf.gather_pairs((p["lb"], p["ij_j"], p["ncm"]), ids)
    for g, w in zip(got, (st.lb, st.ij_j, st.ncm)):
        _eq(g, w[ids])


@MESHES
@pytest.mark.parametrize("guarantee", [False, True])
@pytest.mark.parametrize("n_ref", [37, 1000])
def test_select_with_ties(st, s, guarantee, n_ref):
    """The merge of the shards' local top-k equals the single-device
    stable sort, with many tied probabilities; n_ref = 1000 exceeds the
    8-shard mesh's 625 pairs per shard."""
    sf, p = _sharded(st, s)
    args = (st.inner, *st.cdf, 6, n_ref, guarantee, 4)
    want = dp.select(st.RA, st.ncm, st.ij_i, st.ij_j, st.dad, st.P_idx, *args)
    got = sf.select(p["RA"], p["ncm"], p["ij_i"], p["ij_j"], p["dad"], p["P_idx"], *args)
    prob = np.sort(want[0].numpy())
    for g, w in zip(got, want):
        _eq(g, w)
    # the state does tie: many chosen pairs share a probability
    ths = want[1][st.ij_i.long()].maximum(want[1][st.ij_j.long()])
    assert len(np.unique(ths.numpy())) < 40 and prob.shape[0] == n_ref


@MESHES
def test_per_point_passes(st, s):
    sf, p = _sharded(st, s)
    args = (p["RA"], p["ncm"], p["P_idx"], p["ij_i"], p["ij_j"])
    single = (st.RA, st.ncm, st.P_idx, st.ij_i, st.ij_j)
    got, want = sf.knn(*args, 5), dp.knn(*single, 5)
    _eq(_pads(got[0]), want[0])
    for g, w in zip(got[1:], want[1:]):
        _eq(g, w)
    _eq(_pads(sf.enemy_refine(*args, st.y, 50)), dp.enemy_refine_select(*single, st.y, 50))
    got, want = sf.enemy_knn(*args, st.y, 4), dp.enemy_knn(*single, st.y, 4)
    _eq(_pads(got[0]), want[0])
    _eq(got[1], want[1])
    _eq(got[2], want[2])
    slot = torch.full((NX,), -1, dtype=torch.int64)
    slot[torch.arange(0, NX, 5)] = torch.arange(len(range(0, NX, 5)))
    radii = torch.rand(NX) * 2
    S = int(slot.max()) + 1
    _eq(sf.cover_incidence(p["RA"], p["ncm"], p["ub"], p["P_idx"], p["ij_i"], p["ij_j"],
                           slot, radii, S),
        dp.cover_incidence(st.RA, st.ncm, st.ub, st.P_idx, st.ij_i, st.ij_j, slot, radii, S))


@MESHES
def test_tighten_full_and_clip(st, s):
    """The tropical tighten with the columns split over the shards
    (nx = 203: the 8-shard mesh's last shard has no column)."""
    sf, p = _sharded(st, s)
    want = dp.tighten_full(st.ij_i, st.ij_j, st.RA, st.ncm, st.lb, st.ub, NX)
    got = sf.tighten_full(p["ij_i"], p["ij_j"], p["RA"], p["ncm"], p["lb"], p["ub"], NX)
    for g, w in zip(got, want):
        _eq(sf.real(g), w)
    assert (want[0] > st.lb).any()
    _eq(sf.real(sf.clip_ra(p["RA"], p["ncm"], *got)), dp.clip_ra(st.RA, st.ncm, *want))


@MESHES
@pytest.mark.parametrize("col_chunk", [None, 16], ids=["one-pass", "passes"])
def test_tighten_cols(st, s, col_chunk):
    """The column tighten: 40 columns (integer degrees: ties), the
    contenders truncated at cmax in global id order, chunks of 100."""
    sf, p = _sharded(st, s)
    cap = torch.maximum(st.thresh[st.ij_i.long()], st.thresh[st.ij_j.long()])
    n_cont = int((st.ncm & (st.lb < cap)).sum())
    kw = dict(ncol=40, cmax=n_cont - 7, chunk=100, col_chunk=col_chunk)
    want = dp.tighten_cols(st.ij_i, st.ij_j, st.RA, st.ncm, st.lb, st.ub, st.thresh, **kw)
    got = sf.tighten_cols(p["ij_i"], p["ij_j"], p["RA"], p["ncm"], p["lb"], p["ub"],
                          st.thresh, **kw)
    for g, w in zip(got, want):
        _eq(sf.real(g), w)
    assert (want[0] > st.lb).any()
