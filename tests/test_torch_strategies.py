"""The port's strategy layer held against the JAX package's: samplers,
regression and error model, fed the same numpy features (port of
tests/test_strategies.py).  The samplers draw from the same numpy
generator, so samples, their count and the bin edges must be bit-equal,
including the degenerate-bins retries."""

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

import annchor_tpu.error_predictors as jax_errors
import annchor_tpu.regressors as jax_regressors
import annchor_tpu.samplers as jax_samplers
import annchor_tpu_torch.error_predictors as errors
import annchor_tpu_torch.regressors as regressors
import annchor_tpu_torch.samplers as samplers

FEATURES = ["lower bound", "upper bound", "double anchor distance"]


def _feats(rng, m=4000):
    lb = rng.random(m) * 10
    ub = lb + rng.random(m) * 5
    dad = (lb + ub) / 2 + rng.normal(scale=0.3, size=m)
    return np.stack([lb, ub, dad], axis=1)


def _case(name):
    rng = np.random.default_rng(42)
    F = _feats(rng)
    ncm = rng.random(len(F)) < 0.8
    if name == "small":  # n_samples reduced with a warning
        F, ncm = F[:200], np.ones(200, dtype=bool)
    elif name == "bimodal":  # linspace edges in a density gap: equal-mass retry
        F[:, 2] = np.where(rng.random(len(F)) < 0.5, 0.0, 100.0)
        F[:40, 2] = np.linspace(0.0, 100.0, 40)
    elif name == "constant":  # every edge coincides: uniform retry
        F[:, 2] = 3.0
    return F, ncm


@pytest.mark.parametrize(
    "kind,case",
    [("SimpleStratifiedSampler", c) for c in ("plain", "small", "bimodal", "constant")]
    + [("ClusterSampler", c) for c in ("plain", "small", "bimodal")],
)
def test_sampler_matches_jax(kind, case, capsys):
    F, ncm = _case(case)
    port, ref = getattr(samplers, kind)(), getattr(jax_samplers, kind)()
    for loop in range(2):  # the per-loop seed advances identically
        outs = []
        for s in (port, ref):
            if kind == "ClusterSampler":
                np.random.seed(7 + loop)  # KMeans draws from the global state
            # one OpenMP thread: sklearn's Lloyd iteration adds the
            # threads' partial centre sums in lock order, which varies
            # from run to run and can move a tied point between clusters
            with threadpool_limits(limits=1, user_api="openmp"):
                outs.append(s.sample(F, FEATURES, 700, ncm.copy(), 42))
            outs[-1] = outs[-1] + (capsys.readouterr().out,)
        (ix_t, n_t, bins_t, out_t), (ix_j, n_j, bins_j, out_j) = outs
        np.testing.assert_array_equal(ix_t, ix_j)
        assert n_t == n_j == len(ix_t)
        np.testing.assert_array_equal(bins_t, bins_j)
        assert out_t == out_j
        assert ncm[ix_t].all() and len(np.unique(ix_t)) == n_t
    if case == "bimodal" and kind == "SimpleStratifiedSampler":
        assert "equal-mass" in out_t
    if case == "constant":
        assert "sampling uniformly" in out_t
    if case == "small" and kind == "SimpleStratifiedSampler":
        assert "Reducing n_samples" in out_t


def test_sampler_nothing_to_sample():
    F, _ = _case("plain")
    with pytest.raises(samplers.NothingToSample):
        samplers.SimpleStratifiedSampler().sample(
            F, FEATURES, 100, np.zeros(len(F), dtype=bool), 42
        )


def test_sampler_abc_and_helpers():
    """A subclass supplies get_partition; the shared draw is exact per
    bin; the helpers equal the JAX package's."""
    with pytest.raises(TypeError):
        samplers.Sampler("double anchor distance", 3)

    class Halves(samplers.Sampler):
        def get_partition(self, sample_feature, n_samples):
            return samplers._edges_from_inner([np.median(sample_feature)]), n_samples

    F, ncm = _case("plain")
    ix, n, bins = Halves("double anchor distance", 2).sample(F, FEATURES, 300, ncm, 1)
    assert n == 300 and bins.shape == (3,)
    counts = np.bincount(samplers._label_bins(F[ix, 2], bins), minlength=2)
    assert list(counts) == [150, 150]
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 5, size=20)
    np.testing.assert_array_equal(samplers._ramp(counts), jax_samplers._ramp(counts))
    x = rng.random(500)
    assert samplers._spanning_order_stats(x, 5, 495) == jax_samplers._spanning_order_stats(x, 5, 495)


@pytest.mark.parametrize("bins", [None, "given"])
def test_regression_matches_jax(bins):
    rng = np.random.default_rng(5)
    F = _feats(rng, 3000)
    y = 0.3 * F[:, 0] + 0.5 * F[:, 1] + 0.2 * F[:, 2] + rng.normal(size=3000)
    sb = None if bins is None else np.array([-np.inf, 3.0, 6.0, np.inf])
    port = regressors.SimpleStratifiedLinearRegression()
    ref = jax_regressors.SimpleStratifiedLinearRegression()
    port.fit(F, FEATURES, y, sample_bins=sb)
    ref.fit(F, FEATURES, y, sample_bins=sb)
    np.testing.assert_array_equal(port.coefs, ref.coefs)
    np.testing.assert_array_equal(port.predict(F, FEATURES), ref.predict(F, FEATURES))


def test_error_predictor_matches_jax():
    rng = np.random.default_rng(6)
    F = _feats(rng, 2000)
    resid = rng.normal(size=2000)
    fresh = rng.normal(size=100) + 10
    port = errors.SimpleStratifiedErrorRegression()
    ref = jax_errors.SimpleStratifiedErrorRegression()
    for ep in (port, ref):
        ep.fit(F, FEATURES, resid)
        ep.update_errors(fresh, np.arange(100) % 7)
    np.testing.assert_array_equal(port.predict(F, FEATURES), ref.predict(F, FEATURES))
    assert port.errs.keys() == ref.errs.keys()
    for k in ref.errs:
        np.testing.assert_array_equal(port.errs[k], ref.errs[k])
