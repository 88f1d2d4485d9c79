"""The port's metric layer held against the JAX package's: the vector
metrics' batched engine, the host fan-out of Python metrics, metric
resolution and the construction-time smoke test.

Tolerance of the vector engine: both packages compute in float32, but
they sum each 64-wide row in different orders.  Summing 64 non-negative
terms in a balanced order errs by up to log2(64) = 6 ulps of the result
on either side; 5 ulps was the largest difference seen on this data, so
euclidean and sqeuclidean must agree within 8 ulps of the distance.
Cosine's 1 - num/den cancels, so its error is in ulps of the ratio: it
must agree within 2 ulps of max(|d|, 1).
"""

import threading

import numpy as np
import pytest
import torch

import annchor_tpu.distances as jax_distances
import annchor_tpu.metrics as jm
import annchor_tpu_torch.distances as distances
import annchor_tpu_torch.metrics as tm

torch.set_num_threads(2)

KINDS = ["euclidean", "sqeuclidean", "cosine"]


def _ulps(kind, d):
    d = np.abs(np.asarray(d)).astype(np.float32)
    if kind == "cosine":
        return 2 * np.spacing(np.maximum(d, np.float32(1)))
    return 8 * np.spacing(d)


def _close(kind, got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= _ulps(kind, want)), (
        np.max(np.abs(got - want) / np.spacing(np.abs(want).astype(np.float32)))
    )


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, 64)) * 3 + 1
    X[7] = 0.0  # a zero vector: cosine's scalar and engine differ there
    IJ = rng.integers(0, 400, size=(6000, 2))
    return X, IJ


def _engines(kind):
    return jm.get_function_from_input(kind).batch, tm.get_function_from_input(
        kind, device="cpu"
    ).batch


@pytest.mark.parametrize("kind", KINDS)
def test_dense_engine_call_matches_jax(kind, data):
    X, IJ = data
    jax_eng, eng = _engines(kind)
    got = eng(X, X, IJ)
    assert got.dtype == np.float64
    _close(kind, got, jax_eng(X, X, IJ))
    # the query form: rows of X against rows of another set
    Q = X[:50] * 0.5
    qij = np.stack([IJ[:300, 0], IJ[:300, 1] % 50], axis=1)
    _close(kind, eng(X, Q, qij), jax_eng(X, Q, qij))
    assert eng(X, X, np.zeros((0, 2), dtype=np.int64)).shape == (0,)


@pytest.mark.parametrize("kind", KINDS)
def test_dense_batch_dev_matches_jax_and_chunks(kind, data):
    """batch_dev: float32 on the device with no host hop; the chunked
    result equals the one-shot result element for element."""
    import jax.numpy as jnp

    X, IJ = data
    jax_eng, eng = _engines(kind)
    I = torch.as_tensor(IJ[:, 0].astype(np.int32))
    J = torch.as_tensor(IJ[:, 1].astype(np.int32))
    one = eng.batch_dev(X, I, J)
    assert one.dtype == torch.float32 and one.device.type == "cpu"
    want = np.asarray(
        jax_eng.batch_dev(X, jnp.asarray(IJ[:, 0], jnp.int32), jnp.asarray(IJ[:, 1], jnp.int32))
    )
    _close(kind, one.numpy(), want)
    eng.chunk = 512
    assert torch.equal(eng.batch_dev(X, I, J), one)
    np.testing.assert_array_equal(eng(X, X, IJ), one.numpy().astype(np.float64))


@pytest.mark.parametrize("kind", KINDS)
def test_dense_fused_maxmin_matches_jax(kind, data):
    """Same anchors (including the reference's D[1:] running-minimum
    quirk), columns within the stated tolerance, float64 (n, na)."""
    X, _ = data
    jax_eng, eng = _engines(kind)
    A_j, D_j = jax_eng.fused_maxmin(X, 12, 3)
    A_t, D_t = eng.fused_maxmin(X, 12, 3)
    np.testing.assert_array_equal(A_t, A_j)
    assert D_t.dtype == np.float64 and D_t.shape == (400, 12)
    _close(kind, D_t, D_j)


def test_dense_fused_maxmin_quirk():
    """The running minimum skips the first anchor's column: on four
    points on a line the third anchor is the point farthest from the
    second anchor alone."""
    X = np.array([[0.0], [1.0], [10.0], [4.0]])
    eng = tm.get_function_from_input("euclidean", device="cpu").batch
    A, D = eng.fused_maxmin(X, 3, 1)
    # anchor 1 -> farthest is 2 (x=10); min over D[1:] = distances to
    # x=10 only -> farthest is 0 (x=0), not 3
    assert list(A) == [1, 2, 0]
    A_j, _ = jm.get_function_from_input("euclidean").batch.fused_maxmin(X, 3, 1)
    assert list(A_j) == list(A)


def test_dense_engine_lru_cache():
    """Two entries keyed by identity; the fitted X survives a stream of
    query batches, and a recycled id() never returns a stale upload."""
    rng = np.random.default_rng(1)
    eng = tm.get_function_from_input("euclidean", device="cpu").batch
    X = rng.normal(size=(20, 3))
    ij = np.array([[0, 1], [2, 3]])
    eng(X, X, ij)
    for _ in range(3):
        Q = rng.normal(size=(5, 3))
        eng(X, Q, np.array([[0, 1]]))
        assert id(X) in eng._dev_cache and len(eng._dev_cache) == 2
    X2 = rng.normal(size=(20, 3))
    eng._dev_cache = {id(X2): (X, eng._dev_cache[id(X)][1])}
    np.testing.assert_allclose(
        eng(X2, X2, ij), np.linalg.norm(X2[ij[:, 0]] - X2[ij[:, 1]], axis=1), rtol=1e-6
    )


def _l1(x, y):
    return float(np.abs(x - y).sum())


def _l1_scaled(x, y, scale=1.0):
    return float(np.abs(x - y).sum()) * scale


@pytest.mark.parametrize("m", [100, 3000], ids=["serial", "threaded"])
@pytest.mark.parametrize(
    "func,kw", [(_l1, None), (_l1_scaled, {"scale": 0.5})], ids=["plain", "kwargs"]
)
def test_python_metric_fanout_bit_equal(func, kw, m):
    """A callable metric through make_get_exact_ijs -> _fanout_scalar is
    bit-equal to a list comprehension over f, serial below 256 pairs and
    on the shared thread pool above."""
    rng = np.random.default_rng(m)
    X = rng.normal(size=(200, 5))
    IJ = rng.integers(0, 200, size=(m, 2))
    metric = tm.get_function_from_input(func, kw)
    assert metric.batch is None
    got = tm.make_get_exact_ijs(metric)(metric.scalar, X, IJ)
    want = np.array([metric.scalar(X[i], X[j]) for i, j in IJ], dtype=np.float64)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    jax_metric = jm.get_function_from_input(func, kw)
    np.testing.assert_array_equal(
        got, jm.make_get_exact_ijs(jax_metric)(jax_metric.scalar, X, IJ)
    )
    if m >= 256:
        assert "threading" in tm._EXECUTORS
    Z = X[:30]
    qij = np.stack([IJ[:, 0], IJ[:, 1] % 30], axis=1)
    got_q = tm.make_get_exact_query_ijs(metric)(metric.scalar, X, Z, qij)
    np.testing.assert_array_equal(
        got_q, [metric.scalar(X[i], Z[j]) for i, j in qij]
    )


def test_fanout_worker_failure_finishes_serially():
    """A metric that fails in the worker threads: the evaluation is
    finished serially on the calling thread, as in the JAX package."""
    main = threading.main_thread()

    def picky(x, y):
        if threading.current_thread() is not main:
            raise RuntimeError("worker")
        return float(np.abs(x - y).sum())

    rng = np.random.default_rng(3)
    X = rng.normal(size=(50, 4))
    IJ = rng.integers(0, 50, size=(1000, 2))
    got = tm._fanout_scalar(picky, X, X, IJ, "threading")
    np.testing.assert_array_equal(got, [_l1(X[i], X[j]) for i, j in IJ])


def test_get_function_from_input_resolves():
    for name in ("euclidean", "sqeuclidean", "cosine", "levenshtein"):
        m = tm.get_function_from_input(name, device="cpu")
        assert m.batch is not None and m.name == name
    for name in ("wasserstein", "wasserstein_sinkhorn"):
        m = tm.get_function_from_input(name, {"cost_matrix": np.eye(2)}, device="cpu")
        assert m.batch is not None and m.name == name
    with pytest.raises(AssertionError):
        tm.get_function_from_input("no_such_metric", device="cpu")
    own = tm.Metric(_l1)
    assert tm.get_function_from_input(own) is own
    bound = tm.get_function_from_input(_l1_scaled, {"scale": 2.0})
    x, y = np.ones(3), np.zeros(3)
    assert bound(x, y) == 6.0 and bound.batch is None


def test_scalars_match_jax():
    rng = np.random.default_rng(4)
    x, y = rng.normal(size=8), rng.normal(size=8)
    z = np.zeros(8)
    for a, b in [(x, y), (x, z), (z, z)]:
        assert distances.euclidean(a, b) == jax_distances.euclidean(a, b)
        assert distances.cosine(a, b) == jax_distances.cosine(a, b)
        assert tm._sqeuclidean_scalar(a, b) == jm.get_function_from_input(
            "sqeuclidean"
        ).scalar(a, b)
    assert distances.cosine(x, z) == 0.0
    assert distances.levenshtein("kitten", "sitting") == jax_distances.levenshtein(
        "kitten", "sitting"
    ) == 3


def test_batched_engines_match_scalar(data):
    """Port of tests/test_metrics.py::test_batched_engines_match_scalar
    (away from the zero vector, where the scalar reads 0 and the engine
    1 for cosine, in both packages)."""
    X, IJ = data
    IJ = IJ[(IJ != 7).all(axis=1)][:64]
    for name in KINDS:
        m = tm.get_function_from_input(name, device="cpu")
        batch = m.batch(X, X, IJ)
        scalar = np.array([m.scalar(X[i], X[j]) for i, j in IJ])
        np.testing.assert_allclose(batch, scalar, rtol=1e-4, atol=1e-5)


def test_parallelisation_smoke(data):
    X, _ = data
    m = tm.get_function_from_input("euclidean", device="cpu")
    out = tm.test_parallelisation(tm.make_get_exact_ijs(m), m.scalar, X, len(X), s=20)
    assert out.shape == (20,)


def _broken(f, X, IJ):
    raise RuntimeError("boom")


def _wrong_shape(f, X, IJ):
    return np.zeros((len(IJ), 2))


@pytest.mark.parametrize(
    "evaluator", [_broken, _wrong_shape], ids=["bad_backend", "bad_shape"]
)
def test_parallelisation_errors_match_jax(evaluator, data):
    """The smoke test's errors carry the JAX package's messages
    (tests/test_metrics.py:116-123, 152-158)."""
    X, _ = data
    msgs = []
    for mod in (tm, jm):
        with pytest.raises(RuntimeError) as err:
            mod.test_parallelisation(evaluator, None, X, len(X))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert ("smoke test failed" if evaluator is _broken else "expected") in msgs[0]
