"""K8, the Sinkhorn loop, on the CPU: the plain versions that CPU tensors
take (``sinkhorn_exp_chunk_plain``, ``sinkhorn_batch_plain``) held against
the JAX package's ``_sinkhorn_exp_chunk`` and ``_sinkhorn_batch``; a torch
model of K8a's own arithmetic (``sinkhorn_cuda.exp_chunk_model``: float64
products summed over k in the kernel's order, one rounding, the clamp, a
float32 division, the cost summed per thread and then over the threads)
against the plain version; the launch plans; the dispatch and the
wrapper's checks.  The kernels themselves run on the card:
``tests/test_torch_cuda.py`` (``test_k8*``) and ``chip_smoke.py`` phase 2.

Tolerances: rtol 2e-6, the bound ``tests/test_torch_wasserstein.py``
states between the two packages: XLA:CPU accumulates each product in
float32 in its own order, the port rounds a float64 sum once, so over the
iterations the two drift apart by a few float32 ulps.  The model and the
plain version both round float64 sums of exact products once and differ
only in the order of those sums, so they too must agree to rtol 2e-6 (on
the CPU they agree bit for bit on the digits).
"""

import numpy as np
import pytest
import torch

from annchor_tpu.ops import wasserstein as jw
from annchor_tpu_torch.datasets import digit_images, grid_cost_matrix
from annchor_tpu_torch.ops import sinkhorn_cuda as sc
from annchor_tpu_torch.ops import wasserstein as tw
from annchor_tpu_torch.ops.sinkhorn_cuda import K8

torch.set_num_threads(2)

RTOL = 2e-6


def _problem(n, seed, m=200):
    """(X float32 (m, n) raw histograms, C float32 (n, n)): the digits and
    their grid cost at n 64; otherwise random asymmetric costs and
    histograms with zero bins.  Row 0 is all zeros, row 1 has one bin."""
    rng = np.random.default_rng(seed)
    if n == 64:
        X = digit_images()[0][:m].astype(np.float32).copy()
        C = grid_cost_matrix().astype(np.float32)
    else:
        X = (rng.random((m, n)) * (rng.random((m, n)) < 0.7)).astype(np.float32)
        C = (rng.random((n, n)) * 10).astype(np.float32)
    X[0] = 0
    X[1] = 0
    X[1, n // 2] = 3
    return X, C


def _pairs(m, count, seed):
    """Random pairs plus the edge cases: self pairs, the all-zero row on
    either side and with itself, the one-bin row."""
    rng = np.random.default_rng(seed)
    edge = [(0, 0), (0, 5), (5, 0), (1, 1), (1, 7), (7, 1), (0, 1), (9, 9), (12, 12)]
    IJ = np.concatenate([np.array(edge), rng.integers(0, m, size=(count, 2))])
    return IJ.astype(np.int64)


@pytest.mark.parametrize("n", [5, 64, 100])
def test_exp_chunk_plain_matches_jax(n):
    X, C = _problem(n, seed=n)
    IJ = _pairs(len(X), 300, seed=n)
    n_iter = 40
    eng = tw.SinkhornExpEngine(C, n_iter=n_iter, device="cpu")
    jeng = jw.SinkhornExpEngine(C, n_iter=n_iter)
    want = np.asarray(jw._sinkhorn_exp_chunk(
        jeng._table(X), jeng._table(X), IJ[:, 0].astype(np.int32), IJ[:, 1].astype(np.int32),
        jeng._Kd, jeng._KCd, n_iter))
    before = K8.launches
    got = tw.sinkhorn_exp_chunk(eng._table(X), eng._table(X), torch.as_tensor(IJ[:, 0]),
                                torch.as_tensor(IJ[:, 1]), eng._K, eng._KC, n_iter)
    assert K8.launches == before  # a CPU tensor takes the plain version
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    assert got[0].item() == 0.0  # an all-zero pair costs nothing, as in JAX


@pytest.mark.parametrize("n", [5, 64, 100])
def test_batch_plain_matches_jax(n):
    X, C = _problem(n, seed=n + 1)
    IJ = _pairs(len(X), 150, seed=n + 1)
    Xn = tw.unit_mass(X)
    eps = float(np.float32(0.02 * C.max()))
    A, B = Xn[IJ[:, 0]], Xn[IJ[:, 1]]
    want = np.asarray(jw._sinkhorn_batch(A, B, C, np.float32(eps), 30))
    before = K8.launches
    got = tw.sinkhorn_batch(torch.from_numpy(A), torch.from_numpy(B), torch.from_numpy(C),
                            eps, 30).numpy()
    assert K8.launches == before
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_array_equal(
        got, tw.sinkhorn_batch_plain(torch.from_numpy(A), torch.from_numpy(B),
                                     torch.from_numpy(C), eps, 30).numpy())


def _model_case(n, n_iter, count, seed):
    X, C = _problem(n, seed=seed)
    eng = tw.SinkhornExpEngine(C, device="cpu")
    IJ = _pairs(len(X), count, seed=seed)
    Xd = eng._table(X)
    args = (Xd, Xd, torch.as_tensor(IJ[:, 0]), torch.as_tensor(IJ[:, 1]), eng._K, eng._KC,
            n_iter)
    return tw.sinkhorn_exp_chunk_plain(*args), args


@pytest.mark.parametrize("n_iter", [1, 2, 300])
def test_k8a_model_matches_plain_on_digits(n_iter):
    """K8a's arithmetic, in its order, against the plain version on the
    digits at the scout's n_iter: within rtol 2e-6, and here bit for bit
    (the CPU's float64 products sum each entry's exact terms in order)."""
    want, args = _model_case(64, n_iter, 247, seed=3)
    for rc in sc.EXP_MAX_THREADS:
        plan = sc.exp_plan(256, 64, rc)
        got = sc.exp_chunk_model(*args, tw.TINY, plan=plan)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL)
        share = float((got == want).double().mean())
        assert share == 1.0, "bit-equal share %.4f" % share


@pytest.mark.parametrize("n", [5, 100])
def test_k8a_model_matches_plain_on_random_costs(n):
    """Random asymmetric costs (the orientation of K and K^T shows) with
    zero rows, self pairs and a one-bin row."""
    want, args = _model_case(n, 25, 120, seed=n)
    got = sc.exp_chunk_model(*args, tw.TINY)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL)


def test_k8a_model_matches_plain_in_passes():
    """Above 2,048 bins a thread takes its columns in passes: the model of
    a two-pass plan (2,100 bins) against the plain version, with the zero
    and one-bin rows.  Where u and v live (shared or global memory, above
    7,136 bins) does not change the arithmetic; the card checks that
    plan (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2)."""
    want, args = _model_case(2100, 1, 2, seed=21)
    plan = sc.exp_plan(11, 2100)
    assert (plan["passes"], plan["rc"], plan["global_uv"]) == (2, 8, False)
    got = sc.exp_chunk_model(*args, tw.TINY, plan=plan)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL)


@pytest.mark.parametrize("B", [1, 256, 1797, 8192])
@pytest.mark.parametrize("n", [64, 300])
def test_exp_plan(B, n):
    plan = sc.exp_plan(B, n)
    assert (plan["B"], plan["n"], plan["passes"], plan["global_uv"]) == (B, n, 1, False)
    assert plan["npad"] >= n and plan["npad"] % plan["rc"] == 0
    assert plan["tx"] * plan["rc"] == plan["npad"]
    assert plan["P"] >= 2 and plan["P"] % 2 == 0
    assert plan["threads"] == plan["tx"] * plan["P"] // 2
    assert 1 <= plan["threads"] <= sc.EXP_MAX_THREADS[plan["rc"]]
    assert plan["blocks"] * plan["P"] >= B > (plan["blocks"] - 1) * plan["P"]
    assert plan["smem"] <= sc.SMEM_MAX
    assert plan["resident"] == (n == 64)  # K of 300 bins is read from global memory
    assert plan["rc"] == (4 if B >= sc.EXP_MEDIUM_MIN else 2)
    if B == 1797:
        assert plan["blocks"] >= sc.SMS  # an anchor column spreads over every SM
    if (B, n) == (8192, 64):
        assert (plan["rc"], plan["P"], plan["threads"], plan["blocks"]) == (4, 32, 256, 256)
    for rc in sc.EXP_MAX_THREADS:
        forced = sc.exp_plan(B, n, rc)
        assert forced["rc"] == rc
        assert forced["smem"] <= sc.SMEM_MAX
        assert forced["threads"] <= sc.EXP_MAX_THREADS[rc]


def test_exp_plan_any_n():
    """Every n gets a launch that fits a block: the 8-column tile takes
    over where a pair's columns would need too many threads (above 1,024
    bins), column passes above 2,048, u and v in global memory above
    7,136; no n raises."""
    for n in (1, 2, 7, 8, 9, 63, 65, 112, 113, 1024, 1025, 2048, 2049, 4096, 4097, 7136,
              7137, 10_000, 40_000):
        for B in (1, 1797, 8192):
            for rc in (None, *sc.EXP_MAX_THREADS):
                plan = sc.exp_plan(B, n, rc)
                assert plan["smem"] <= sc.SMEM_MAX
                assert plan["threads"] <= sc.EXP_MAX_THREADS[plan["rc"]]
                assert plan["npad"] == plan["tx"] * plan["rc"] * plan["passes"] >= n
                assert plan["npad"] % 8 == 0 and plan["npad"] - n < 8 * plan["passes"]
                assert plan["passes"] == 1 or plan["rc"] == 8
                assert not (plan["resident"] and plan["global_uv"])
                assert plan["blocks"] * plan["P"] >= B > (plan["blocks"] - 1) * plan["P"]
    assert sc.exp_plan(1, 112)["resident"] and not sc.exp_plan(1, 113)["resident"]
    assert sc.exp_plan(1, 1024)["rc"] == 2 and sc.exp_plan(1, 1025)["rc"] == 8
    assert sc.exp_plan(1, 2048)["passes"] == 1 and sc.exp_plan(1, 2049)["passes"] == 2
    assert not sc.exp_plan(1, 7136)["global_uv"] and sc.exp_plan(1, 7137)["global_uv"]
    with pytest.raises(ValueError, match="rc must be one of"):
        sc.exp_plan(1, 64, 16)


@pytest.mark.parametrize("B", [1, 256, 4096])
@pytest.mark.parametrize("n", [5, 64, 300])
def test_log_plan(B, n):
    plan = sc.log_plan(B, n)
    assert plan["G"] % 32 == 0 and plan["G"] >= min(n, 256)
    assert plan["threads"] == plan["G"] * plan["P"] <= sc.LOG_THREADS
    assert plan["blocks"] * plan["P"] >= B
    assert plan["smem"] <= sc.SMEM_MAX
    assert plan["resident"] == (n < 300) and not plan["global_v"]
    if B == 4096:
        assert plan["blocks"] >= 2 * sc.SMS
    # -C/eps leaves shared memory above 237 bins, the potentials above 14,400
    assert sc.log_plan(B, 237)["resident"] and not sc.log_plan(B, 238)["resident"]
    for top, global_v in ((14_400, False), (14_401, True), (40_000, True)):
        plan = sc.log_plan(B, top)
        assert plan["smem"] <= sc.SMEM_MAX and plan["global_v"] == global_v
        assert plan["P"] == 1 and not plan["resident"]


def test_engines_take_the_plain_versions_on_the_cpu():
    """Both engines on the CPU: no launch, the plain versions' values."""
    X, C = _problem(64, seed=11)
    IJ = _pairs(len(X), 40, seed=11)
    before = K8.launches, dict(K8.mode_launches)
    eng = tw.SinkhornExpEngine(C, n_iter=20, chunk=16, device="cpu")
    Xd = eng._table(X)
    want = torch.cat([tw.sinkhorn_exp_chunk_plain(
        Xd, Xd, torch.as_tensor(IJ[s:s + 16, 0]), torch.as_tensor(IJ[s:s + 16, 1]), eng._K,
        eng._KC, 20) for s in range(0, len(IJ), 16)])
    np.testing.assert_array_equal(eng(X, X, IJ), want.numpy().astype(np.float64))
    A, D = eng.fused_maxmin(X, 4, 3)
    assert A[0] == 3 and np.isfinite(D).all()
    log = tw.SinkhornEngine(C, n_iter=10, chunk=16, device="cpu")
    assert np.isfinite(log(X, X, IJ)).all()
    assert (K8.launches, K8.mode_launches) == before


def _exp_args(**change):
    n = 6
    args = dict(Xn=torch.rand(10, n), Zn=torch.rand(12, n), I=torch.zeros(4, dtype=torch.int64),
                J=torch.ones(4, dtype=torch.int64), K64=torch.rand(n, n, dtype=torch.float64),
                KC64=torch.rand(n, n, dtype=torch.float64), n_iter=3, tiny=tw.TINY)
    args.update(change)
    return args


@pytest.mark.parametrize("change,match", [
    ({"Xn": torch.rand(10, 6, dtype=torch.float64)}, "Xn must be torch.float32"),
    ({"Xn": torch.rand(10)}, "Xn must be 2-d"),
    ({"Zn": torch.rand(12, 5)}, "Zn has 5 bins"),
    ({"I": torch.zeros(4, dtype=torch.int32)}, "I must be torch.int64"),
    ({"J": torch.ones(3, dtype=torch.int64)}, r"J has shape \(3,\)"),
    ({"K64": torch.rand(6, 6)}, "K64 must be torch.float64"),
    ({"K64": torch.rand(5, 5, dtype=torch.float64)}, r"K64 has shape \(5, 5\)"),
    ({"KC64": torch.rand(6, 7, dtype=torch.float64)}, r"KC64 has shape \(6, 7\)"),
    ({"Xn": torch.rand(6, 10).t()}, "Xn must be contiguous"),
    ({"K64": torch.rand(6, 6, dtype=torch.float64).t()}, "K64 must be contiguous"),
    ({"_plan": sc.exp_plan(5, 6)}, "the plan is for 5 pairs of 6 bins"),
    ({}, "on a card"),
])
def test_exp_wrapper_refuses_before_building(change, match):
    """The wrapper raises a clear ValueError on a wrong dtype, shape or
    layout, or on a CPU tensor, before any build (a build without a CUDA
    compiler raises a RuntimeError instead)."""
    before = K8.launches
    with pytest.raises(ValueError, match=match):
        sc.sinkhorn_exp_cuda(**_exp_args(**change))
    assert K8.launches == before


@pytest.mark.parametrize("change,match", [
    ({"A": torch.rand(4, 6, dtype=torch.float64)}, "A must be torch.float32"),
    ({"B": torch.rand(4, 5)}, r"B has shape \(4, 5\)"),
    ({"C": torch.rand(5, 5)}, r"C has shape \(5, 5\)"),
    ({"C": torch.rand(6, 6).t()}, "C must be contiguous"),
    ({}, "on a card"),
])
def test_log_wrapper_refuses_before_building(change, match):
    args = dict(A=torch.rand(4, 6), B=torch.rand(4, 6), C=torch.rand(6, 6), eps=0.1, n_iter=3)
    args.update(change)
    before = K8.launches
    with pytest.raises(ValueError, match=match):
        sc.sinkhorn_log_cuda(**args)
    assert K8.launches == before


def test_module_imports_without_a_compiler(tmp_path):
    """Importing the wrapper builds nothing: the library is built at the
    first launch on a card, so a machine without nvcc imports it."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path), PYTHONPATH=root)
    code = ("import annchor_tpu_torch.ops.sinkhorn_cuda as m; "
            "assert m.K8._lib is None and set(m.K8.mode_launches) == {'exp', 'log'}; "
            "import annchor_tpu_torch.ops.wasserstein")
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
    assert sc.K8.source.endswith(os.path.join("csrc", "sinkhorn.cu"))
