"""The device 2-hop screen of the port's graph-expansion refinement, held
against its host screen and against the JAX package's host screen (the
JAX default) on the CPU.

``ANNCHOR_TPU_FORCE_DEVICE_EXPAND`` runs the port's device screen on CPU
tensors, and ``_DEV_ROWS`` is shrunk so that the row blocks end in a
short tail block.  Each round's slates must be bit-equal to the host
screen's, so the refined graphs, the eval counts and the pairs sent to
the evaluator must equal the JAX package's.  The pool of known pairs is
also made exactly a power of two long, where the JAX package's device
screen misses members (ROADMAP F1): the port searches sorted int64 keys
and is held to the host screen there too.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import annchor_tpu as at
import annchor_tpu.refine as jrefine
import annchor_tpu_torch as att
import annchor_tpu_torch.refine as trefine
from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms

torch.set_num_threads(2)


def _graph_inputs(nx, kk, n_pool, seed):
    """Row lists (gi, gd) over points in R^3, their kth distances and a
    sorted pool of n_pool canonical keys, a third of them taken from the
    2-hop candidates so that the membership test bites."""
    rng = np.random.default_rng(seed)
    P = rng.random((nx, 3))
    gi = np.stack([rng.choice(nx, kk, replace=False) for _ in range(nx)]).astype(np.int64)
    gi[rng.random((nx, kk)) < 0.1] = -1
    gd = np.where(gi >= 0, np.linalg.norm(P[:, None, :] - P[np.maximum(gi, 0)], axis=2), np.inf)
    order = np.argsort(gd, axis=1, kind="stable")
    gi = np.take_along_axis(gi, order, axis=1)
    gd = np.take_along_axis(gd, order, axis=1)
    kth = gd[:, -1]
    a = rng.integers(0, nx, 4 * n_pool)
    jj = np.maximum(gi[a, rng.integers(0, kk, a.shape[0])], 0)
    b = np.maximum(gi[jj, rng.integers(0, kk, a.shape[0])], 0)
    cand = np.minimum(a, b) * nx + np.maximum(a, b)
    other = rng.integers(0, nx * nx, 4 * n_pool)
    keys = np.unique(np.concatenate([cand[a != b][: n_pool // 3], other]))
    keys = np.sort(rng.choice(keys, n_pool, replace=False))
    return gi, gd, kth, keys


@pytest.mark.parametrize("nx,kk,q,n_pool,rows", [
    (300, 6, 16, 1000, 64),   # tail block of 44 rows
    (257, 9, 32, 1024, 100),  # pool of 2^10 keys (F1)
    (130, 4, 16, 4096, 1 << 16),  # one block; pool of 2^12 keys
])
def test_device_screen_bit_equal_to_host(nx, kk, q, n_pool, rows, monkeypatch):
    gi, gd, kth, keys = _graph_inputs(nx, kk, n_pool, nx + kk)
    monkeypatch.setattr(trefine, "_DEV_ROWS", rows)
    lq_h, ubq_h = trefine._screen_host(gi, gd, kth, keys, nx, kk, q)
    lq_d, ubq_d = trefine._screen_blocks_dev(gi, gd, kth, keys, nx, kk, q,
                                             torch.device("cpu"))
    assert lq_d.dtype == lq_h.dtype == np.int32 and ubq_d.dtype == np.float32
    np.testing.assert_array_equal(lq_d, lq_h)
    np.testing.assert_array_equal(ubq_d.view(np.int32), ubq_h.view(np.int32))
    admitted = np.isfinite(ubq_h)
    assert admitted.any()
    # no admitted candidate is a pool member
    me = np.arange(nx)[:, None]
    ck = np.minimum(me, lq_h) * nx + np.maximum(me, lq_h)
    assert not np.isin(ck[admitted], keys).any()


class _Recorder:
    """An evaluator that records the pairs it is asked for, with euclidean
    distances between points of R^3."""

    def __init__(self, P):
        self.P = P
        self.calls = []

    def __call__(self, f, X, IJ):
        IJ = np.asarray(IJ)
        self.calls.append(IJ.copy())
        return np.linalg.norm(self.P[IJ[:, 0]] - self.P[IJ[:, 1]], axis=1)


def _fake_index(nx, kk, n_edges, seed):
    """A fitted-index stand-in with exactly ``n_edges`` distinct graph
    edges (each listed by both endpoints, so the refinement's pool is
    n_edges long), a third of their values predicted, not exact."""
    rng = np.random.default_rng(seed)
    P = rng.random((nx, 3))
    keys = np.sort(rng.choice(nx * (nx - 1) // 2, n_edges, replace=False))
    iu = np.triu_indices(nx, k=1)
    a, b = iu[0][keys], iu[1][keys]
    d = np.linalg.norm(P[a] - P[b], axis=1)
    pred = rng.random(n_edges) < 1 / 3
    d = np.where(pred, d * rng.uniform(0.8, 1.2, n_edges), d)
    rows = np.concatenate([a, b])
    cols = np.concatenate([b, a])
    vals = np.concatenate([d, d])
    flags = np.concatenate([~pred, ~pred])
    order = np.lexsort((vals, rows))
    rows, cols, vals, flags = rows[order], cols[order], vals[order], flags[order]
    start = np.searchsorted(rows, np.arange(nx))
    rank = np.arange(rows.shape[0]) - start[rows]
    assert rank.max() < kk, "kk too small to list every edge"
    ngi = np.full((nx, kk + 1), -1, dtype=np.int64)
    ngd = np.full((nx, kk + 1), np.inf)
    ngx = np.ones((nx, kk + 1), dtype=bool)
    ngi[:, 0], ngd[:, 0] = np.arange(nx), 0.0
    ngi[rows, rank + 1], ngd[rows, rank + 1], ngx[rows, rank + 1] = cols, vals, flags
    return P, (ngi, ngd, ngx)


def _refine_fake(mod, P, graph, device_screen, budget, rounds):
    ngi, ngd, ngx = graph
    rec = _Recorder(P)
    nx = ngi.shape[0]
    ann = SimpleNamespace(
        nx=nx, N=nx * (nx - 1) // 2, p_work=0.5, evals=0, X=None, f=None,
        neighbor_graph=(ngi.copy(), ngd.copy()), _ng_exact=ngx.copy(), _scouting=False,
        get_exact_ijs=rec, verbose=False, device=torch.device("cpu"))
    env = "ANNCHOR_TPU_FORCE_DEVICE_EXPAND" if device_screen else "ANNCHOR_TPU_DISABLE_DEVICE_EXPAND"
    os.environ[env] = "1"
    try:
        mod.refine_neighbor_graph(ann, rounds=rounds, budget=budget)
    finally:
        os.environ.pop(env)
    return ann, rec.calls


@pytest.mark.parametrize("nx,kk,n_edges,rows", [(240, 24, 1024, 50), (300, 26, 1500, 1 << 16)])
def test_refine_with_device_screen_equals_jax_host_screen(nx, kk, n_edges, rows, monkeypatch):
    """The whole refinement with the port's device screen against the JAX
    package's host screen: the pairs sent to the evaluator, in order, the
    refined graph and the eval counts (1,024 edges: the pool is 2^10 long
    when the first round screens)."""
    monkeypatch.setattr(trefine, "_DEV_ROWS", rows)
    P, graph = _fake_index(nx, kk, n_edges, nx)
    ref, ref_calls = _refine_fake(jrefine, P, graph, False, 6000, 3)
    dev, dev_calls = _refine_fake(trefine, P, graph, True, 6000, 3)
    host, host_calls = _refine_fake(trefine, P, graph, False, 6000, 3)
    assert len(ref_calls) >= 3
    for calls in (dev_calls, host_calls):
        assert len(calls) == len(ref_calls)
        for got, want in zip(calls, ref_calls):
            np.testing.assert_array_equal(got, want)
    for ann in (dev, host):
        assert ann.evals == ref.evals
        np.testing.assert_array_equal(ann.neighbor_graph[0], ref.neighbor_graph[0])
        np.testing.assert_array_equal(ann.neighbor_graph[1], ref.neighbor_graph[1])
        np.testing.assert_array_equal(ann._ng_exact, ref._ng_exact)
        assert [s.get("evals") for s in ann._refine_stats] == [
            s.get("evals") for s in ref._refine_stats]
    rounds = [s for s in dev._refine_stats if s["stage"].startswith("round")]
    assert rounds and all("screen_dev_s" in s and "screen_s" not in s for s in rounds)
    assert all({"row_lists_s", "dedupe_s", "host_screen_s"} <= set(s) for s in rounds)
    assert all("screen_s" in s for s in host._refine_stats if s["stage"].startswith("round"))


def test_device_screen_policy(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for k in ("ANNCHOR_TPU_FORCE_DEVICE_EXPAND", "ANNCHOR_TPU_DISABLE_DEVICE_EXPAND"):
        monkeypatch.delenv(k, raising=False)
    assert trefine._use_device_screen(cuda) and not trefine._use_device_screen(cpu)
    monkeypatch.setenv("ANNCHOR_TPU_FORCE_DEVICE_EXPAND", "1")
    assert trefine._use_device_screen(cpu)
    monkeypatch.setenv("ANNCHOR_TPU_DISABLE_DEVICE_EXPAND", "1")
    assert not trefine._use_device_screen(cpu) and not trefine._use_device_screen(cuda)


def test_device_expand_screen_matches_host():
    """Port of tests/test_scale_path.py::test_device_expand_screen_matches_host:
    a fit starved by a tight pair cap, refined (rounds=3, budget=5000)
    with the host and with the device screen, gives the same graphs,
    evals and per-round evals, and those of the JAX package's fit refined
    with its host screen."""
    from sklearn.datasets import make_blobs

    X, _ = make_blobs(n_samples=900, centers=9, n_features=5, random_state=3)
    kw = dict(n_anchors=12, n_neighbors=10, n_samples=1000, p_work=0.15, random_seed=42)
    env = {"ANNCHOR_TPU_FORCE_SPARSE": "1", "ANNCHOR_TPU_DISABLE_SHARDING": "1",
           "ANNCHOR_TPU_PAIR_CAP": "40"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        ref = at.Annchor(X, "euclidean", **kw)
        ref.fit()
        ann = att.Annchor(X, "euclidean", device="cpu", uniforms=jax_threefry_uniforms, **kw)
        ann.fit()
        fitted = (ann.neighbor_graph, ann._ng_exact, ann.evals)
        results = {}
        for mode, var in [("host", "ANNCHOR_TPU_DISABLE_DEVICE_EXPAND"),
                          ("dev", "ANNCHOR_TPU_FORCE_DEVICE_EXPAND")]:
            # each refinement starts from the fitted graph
            ann.neighbor_graph, ann._ng_exact, ann.evals = fitted
            os.environ[var] = "1"
            try:
                ann.refine_neighbor_graph(rounds=3, budget=5000)
            finally:
                os.environ.pop(var)
            results[mode] = (ann.neighbor_graph, ann.evals, list(ann._refine_stats))
        ref.refine_neighbor_graph(rounds=3, budget=5000)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    (host_g, host_ev, host_st), (dev_g, dev_ev, dev_st) = results["host"], results["dev"]
    np.testing.assert_array_equal(host_g[0], dev_g[0])
    np.testing.assert_array_equal(host_g[1], dev_g[1])
    assert host_ev == dev_ev == ref.evals
    per_round = [s.get("evals", 0) for s in dev_st]
    assert per_round == [s.get("evals", 0) for s in host_st]
    assert per_round == [s.get("evals", 0) for s in ref._refine_stats]
    np.testing.assert_array_equal(dev_g[0], ref.neighbor_graph[0])
    # the euclidean engine sums in another order than XLA: 8 float32 ulps
    np.testing.assert_allclose(dev_g[1], ref.neighbor_graph[1], rtol=8 * 2.0**-23, atol=1e-6)
