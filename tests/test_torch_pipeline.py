"""The port's locality stage and device-pipeline programs held against
the JAX package's, each started from the same numpy state.

The state comes from the JAX package (anchors, anchor columns, the
candidate pairs and exact distances of a small string set) and goes to
the port through ``annchor_tpu_torch.convert``.  Integer results and
results of exact float32 arithmetic (max, min, abs, sums of integers)
must be bit-equal; the regression predict may differ in the last ulps
because XLA can contract its multiply-adds into FMAs.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annchor_tpu.datasets import make_strings
from annchor_tpu.error_predictors import SimpleStratifiedErrorRegression
from annchor_tpu.ops import device_pipeline as jdp
from annchor_tpu.ops import levenshtein_myers as jax_myers
from annchor_tpu.ops.levenshtein import encode_strings
from annchor_tpu.ops.locality import candidate_pairs as jax_candidate_pairs
from annchor_tpu_torch.convert import fit_inputs_from_numpy
from annchor_tpu_torch.ops import device_pipeline as tdp
from annchor_tpu_torch.ops.locality import candidate_pairs

torch.set_num_threads(2)

NN = 8


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def state():
    """A JAX-built fit state on 160 strings: anchors, columns, the
    candidate pairs, their features and a computed/estimated split."""
    X, _ = make_strings(n=160, length=40, seed=5)
    enc = jax_myers.MyersEncoding.from_codes(*encode_strings(list(X)))
    A, D = jax_myers.myers_maxmin(enc, 10, 3)
    IJs, _, _, _ = jax_candidate_pairs(D, 5, 3, 30)
    nx, m = len(X), IJs.shape[0]
    assert m < nx * (nx - 1) // 2  # the counting-sort incidence branch
    exact = jax_myers.myers_pairs(enc, IJs[:, 0], IJs[:, 1]).astype(np.float32)
    rng = np.random.default_rng(0)
    ncm = rng.random(m) < 0.7
    # estimates: exact values plus integer-ish noise, so RA ties abound
    RA = np.where(ncm, exact + rng.integers(-2, 4, size=m), exact).astype(np.float32)
    return types.SimpleNamespace(
        X=X, A=A, D=D, IJs=IJs, nx=nx, m=m, ncm=ncm, RA=RA, exact=exact,
        inputs=fit_inputs_from_numpy(A, D, IJs, "cpu"),
    )


def _jax_features(s):
    D32 = jnp.asarray(s.D.astype(np.float32))
    return jdp._features_init(D32, jnp.asarray(s.IJs[:, 0]), jnp.asarray(s.IJs[:, 1]))


@pytest.mark.parametrize("loc_thresh,loc_min", [(1, 100), (3, 30), (2, 10)])
def test_candidate_pairs_bit_equal(loc_thresh, loc_min):
    X, _ = make_strings(n=200, length=40, seed=2)
    enc = jax_myers.MyersEncoding.from_codes(*encode_strings(list(X)))
    _, D = jax_myers.myers_maxmin(enc, 12, 0)
    IJ_j, sid_j, _, eff_j = jax_candidate_pairs(D, 5, loc_thresh, loc_min)
    IJ_t, sid_t, S_t, eff_t = candidate_pairs(D, 5, loc_thresh, loc_min, "cpu")
    assert IJ_t.dtype == np.int32
    np.testing.assert_array_equal(IJ_t, IJ_j)
    np.testing.assert_array_equal(sid_t.numpy(), _np(sid_j))
    np.testing.assert_array_equal(eff_t.numpy(), _np(eff_j))
    assert float(S_t.sum()) == 5 * len(X)


def test_candidate_pairs_refuses_scale_path():
    with pytest.raises(NotImplementedError, match="item 13"):
        candidate_pairs(np.zeros((4097, 3)), 2, 1, 1, "cpu")


def test_features_bit_equal(state):
    lb, ub, dad = tdp.features(
        state.inputs.D32, state.inputs.ij_i, state.inputs.ij_j, chunk=1000
    )
    for got, want in zip((lb, ub, dad), _jax_features(state)):
        np.testing.assert_array_equal(got.numpy(), _np(want))


def test_incidence_equal(state):
    max_deg = int(
        (np.bincount(state.IJs[:, 0], minlength=state.nx)
         + np.bincount(state.IJs[:, 1], minlength=state.nx)).max()
    )
    got = tdp.pidx_from_pairs(state.inputs.ij_i, state.inputs.ij_j, state.nx, max_deg)
    want = jdp._pidx_from_pairs(
        jnp.asarray(state.IJs[:, 0]), jnp.asarray(state.IJs[:, 1]), state.nx, max_deg
    )
    np.testing.assert_array_equal(got.numpy(), _np(want))
    np.testing.assert_array_equal(
        tdp.pidx_full(37, "cpu").numpy(), _np(jdp._pidx_full_dev(37))
    )


@pytest.mark.parametrize("equal_mass", [False, True])
def test_sample_draw_bit_equal_with_injected_uniforms(state, equal_mass):
    _, _, dad = _jax_features(state)
    ncm = state.ncm
    pool = int(ncm.sum())
    key = jax.random.fold_in(jax.random.PRNGKey(42), 3)
    r = np.asarray(jax.random.uniform(key, (state.m,), dtype=jnp.float32))
    quotas = (72, 71, 71, 71, 71, 71, 71)
    ilo, ihi = pool // 100, (99 * pool) // 100
    ids_j, got_j, inner_j = jdp._sample_draw(
        dad, jnp.asarray(ncm), key, jnp.int32(ilo), jnp.int32(ihi),
        jnp.int32(pool), quotas, equal_mass=equal_mass,
    )
    ids_t, got_t, inner_t = tdp.sample_draw(
        _t(dad), _t(ncm), _t(r), ilo, ihi, pool, quotas, equal_mass=equal_mass
    )
    np.testing.assert_array_equal(ids_t.numpy(), _np(ids_j))
    np.testing.assert_array_equal(got_t.numpy(), _np(got_j))
    np.testing.assert_array_equal(inner_t.numpy(), _np(inner_j))


@pytest.mark.parametrize("seed,loop,m", [(42, 0, 10), (42, 1, 4097), (7, 3, 12345), (0, 0, 5)])
def test_threefry_uniforms_bit_equal_to_jax(seed, loop, m):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), loop)
    want = np.asarray(jax.random.uniform(key, (m,), dtype=jnp.float32))
    got = tdp.jax_threefry_uniforms(seed, loop, m, "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_default_uniforms_seeded():
    a = tdp.default_uniforms(42, 0, 1000, "cpu")
    assert a.dtype == torch.float32 and a.shape == (1000,)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    assert torch.equal(a, tdp.default_uniforms(42, 0, 1000, "cpu"))
    assert not torch.equal(a, tdp.default_uniforms(42, 1, 1000, "cpu"))


@pytest.mark.parametrize("init", [True, False])
def test_regress_update_within_ulps(state, init):
    """RA within 4 ulps of the JAX program (XLA may fuse the per-bin
    multiply-adds into FMAs); the not-computed mask is equal."""
    lb, ub, dad = _jax_features(state)
    rng = np.random.default_rng(1)
    inner = np.sort(rng.uniform(5, 40, size=6)).astype(np.float32)
    coefs = rng.normal(0.4, 0.3, size=(7, 3)).astype(np.float32)
    icepts = rng.normal(0, 2, size=7).astype(np.float32)
    sids = rng.choice(np.flatnonzero(state.ncm), 50, replace=False).astype(np.int32)
    sy = state.exact[sids]
    RA_j, ncm_j = jdp._regress_update(
        lb, ub, dad, jnp.asarray(state.RA), jnp.asarray(state.ncm),
        jnp.asarray(inner), jnp.asarray(coefs), jnp.asarray(icepts),
        jnp.asarray(sids), jnp.asarray(sy), True, init,
    )
    RA_t, ncm_t = tdp.regress_update(
        _t(lb), _t(ub), _t(dad), _t(state.RA), _t(state.ncm), _t(inner),
        _t(coefs), _t(icepts), _t(sids.astype(np.int64)), _t(sy), True, init,
    )
    np.testing.assert_array_equal(ncm_t.numpy(), _np(ncm_j))
    RA_j = _np(RA_j)
    ulp = np.spacing(np.maximum(np.abs(RA_j), 1.0).astype(np.float32))
    assert np.all(np.abs(RA_t.numpy() - RA_j) <= 4 * ulp)


def _cdf_inputs(state, dad):
    """The JAX error model fitted on synthetic residuals, and its CDF
    grid tables (host numpy, shared by both packages)."""
    rng = np.random.default_rng(2)
    n = 700
    feats = np.zeros((n, 4))
    feats[:, 2] = rng.choice(_np(dad), n)
    ep = SimpleStratifiedErrorRegression()
    bins = np.concatenate(([-np.inf], np.linspace(10, 35, 6), [np.inf]))
    ep.fit(feats, ["lower bound", "upper bound", "double anchor distance",
                   "is anchor"], np.round(rng.normal(0, 3, n)), sample_bins=bins)
    tables = jdp.DeviceFitState._cdf_tables(
        types.SimpleNamespace(CDF_GRID=4096), ep
    )
    return bins[1:-1].astype(np.float32), tables


@pytest.mark.parametrize("guarantee", [True, False])
def test_select_chooses_equal_ids(state, guarantee):
    _, _, dad = _jax_features(state)
    deg = (np.bincount(state.IJs[:, 0], minlength=state.nx)
           + np.bincount(state.IJs[:, 1], minlength=state.nx)).max()
    P = jdp._pidx_from_pairs(
        jnp.asarray(state.IJs[:, 0]), jnp.asarray(state.IJs[:, 1]), state.nx, int(deg)
    )
    inner, (grid, lo, hi, inv) = _cdf_inputs(state, dad)
    n_ref = int(0.3 * state.ncm.sum())
    ch_j, th_j, si_j, sj_j = jdp._select(
        jnp.asarray(state.RA), jnp.asarray(state.ncm), jnp.asarray(state.IJs[:, 0]),
        jnp.asarray(state.IJs[:, 1]), dad, P, jnp.asarray(inner), jnp.asarray(grid),
        jnp.asarray(lo), jnp.asarray(inv), jnp.asarray(hi), NN, n_ref, guarantee,
        3 * NN // 2,
    )
    ch_t, th_t, si_t, sj_t = tdp.select(
        _t(state.RA), _t(state.ncm), state.inputs.ij_i, state.inputs.ij_j, _t(dad),
        _t(P), _t(inner), _t(grid), _t(lo), _t(inv), _t(hi), NN, n_ref,
        guarantee, 3 * NN // 2,
    )
    np.testing.assert_array_equal(th_t.numpy(), _np(th_j))
    np.testing.assert_array_equal(ch_t.numpy(), _np(ch_j))
    np.testing.assert_array_equal(si_t.numpy(), _np(si_j))
    np.testing.assert_array_equal(sj_t.numpy(), _np(sj_j))


def test_tighten_full_and_clip_bit_equal(state):
    lb, ub, _ = _jax_features(state)
    args_j = (jnp.asarray(state.IJs[:, 0]), jnp.asarray(state.IJs[:, 1]),
              jnp.asarray(state.RA), jnp.asarray(state.ncm), lb, ub)
    lb_j, ub_j = jdp._tighten_full(*args_j, state.nx)
    lb_t, ub_t = tdp.tighten_full(
        state.inputs.ij_i, state.inputs.ij_j, _t(state.RA), _t(state.ncm),
        _t(lb), _t(ub), state.nx,
    )
    np.testing.assert_array_equal(lb_t.numpy(), _np(lb_j))
    np.testing.assert_array_equal(ub_t.numpy(), _np(ub_j))
    np.testing.assert_array_equal(
        tdp.clip_ra(_t(state.RA), _t(state.ncm), lb_t, ub_t).numpy(),
        _np(jdp._clip_ra(jnp.asarray(state.RA), jnp.asarray(state.ncm), lb_j, ub_j)),
    )


def test_knn_equal(state):
    deg = (np.bincount(state.IJs[:, 0], minlength=state.nx)
           + np.bincount(state.IJs[:, 1], minlength=state.nx)).max()
    P = jdp._pidx_from_pairs(
        jnp.asarray(state.IJs[:, 0]), jnp.asarray(state.IJs[:, 1]), state.nx, int(deg)
    )
    want = jdp._knn(
        jnp.asarray(state.RA), jnp.asarray(state.ncm), P,
        jnp.asarray(state.IJs[:, 0]), jnp.asarray(state.IJs[:, 1]), NN - 1,
    )
    got = tdp.knn(
        _t(state.RA), _t(state.ncm), _t(P), state.inputs.ij_i, state.inputs.ij_j,
        NN - 1,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_scatter_exact_lands_values(state):
    RA, ncm = _t(state.RA), _t(state.ncm)
    ids = torch.tensor([0, 5, 7])
    vals = torch.tensor([1.5, 2.5, 3.5])
    RA2, ncm2 = tdp.scatter_exact(RA.clone(), ncm.clone(), ids, vals)
    assert torch.equal(RA2[ids], vals) and not bool(ncm2[ids].any())
