"""K8, the Sinkhorn loop, on the CPU: the plain versions that CPU tensors
take (``sinkhorn_exp_chunk_plain``, ``sinkhorn_batch_plain``) held against
the JAX package's ``_sinkhorn_exp_chunk`` and ``_sinkhorn_batch``; a torch
model of K8a's own arithmetic (``sinkhorn_cuda.exp_chunk_model``: float64
products summed over k in order, as the FP64 tensor cores' chained mma
sums them, one rounding, the clamp, a float32 division, the cost's terms
summed in order) against the plain version and the JAX package; the
launch plans; the dispatch and the wrapper's checks.  The kernels themselves run on the card:
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
# K8b's float32 sums in another order than the plain version's, and its
# float64 closing sum: the card's tolerance (tests/test_torch_cuda.py)
K8B_RTOL = 1e-5


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
    got = sc.exp_chunk_model(*args, tw.TINY)
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


@pytest.mark.parametrize("n,n_iter", [(64, 300), (5, 40), (100, 40)])
def test_k8a_model_matches_jax(n, n_iter):
    """The model against the JAX package's ``_sinkhorn_exp_chunk`` on the
    digits and on random costs, to rtol 2e-6 (XLA:CPU sums each product
    in float32, the model a float64 sum rounded once)."""
    X, C = _problem(n, seed=n + 7)
    IJ = _pairs(len(X), 120, seed=n + 7)
    eng = tw.SinkhornExpEngine(C, n_iter=n_iter, device="cpu")
    jeng = jw.SinkhornExpEngine(C, n_iter=n_iter)
    want = np.asarray(jw._sinkhorn_exp_chunk(
        jeng._table(X), jeng._table(X), IJ[:, 0].astype(np.int32), IJ[:, 1].astype(np.int32),
        jeng._Kd, jeng._KCd, n_iter))
    Xd = eng._table(X)
    got = sc.exp_chunk_model(Xd, Xd, torch.as_tensor(IJ[:, 0]), torch.as_tensor(IJ[:, 1]),
                             eng._K, eng._KC, n_iter, tw.TINY)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_k8a_model_matches_plain_streamed():
    """Above the resident limit the kernel runs the streamed path with
    the same arithmetic: the model at 145 and 300 bins against the plain
    version, with the zero and one-bin rows."""
    for n in (145, 300):
        want, args = _model_case(n, 3, 20, seed=n)
        assert sc.exp_plan(29, n)["path"] == "streamed"
        got = sc.exp_chunk_model(*args, tw.TINY)
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL)


@pytest.mark.parametrize("B", [1, 256, 1797, 8192])
@pytest.mark.parametrize("n", [5, 64, 144])
def test_exp_plan(B, n):
    """Resident plans: 16 pairs a block, npad n rounded up to 16, a warp
    per 8 columns; a 1,797-pair anchor column fills 113 blocks."""
    plan = sc.exp_plan(B, n)
    assert (plan["B"], plan["n"], plan["path"], plan["P"]) == (B, n, "resident", 16)
    assert plan["cols"] == plan["npad"]
    assert plan["npad"] % 16 == 0 and n <= plan["npad"] < n + 16
    assert plan["threads"] == 32 * plan["npad"] // 8 <= 576
    assert plan["blocks"] * plan["P"] >= B > (plan["blocks"] - 1) * plan["P"]
    assert plan["smem"] == 8 * (plan["npad"] + 4) * (plan["npad"] + 32) <= sc.SMEM_MAX
    assert sc.exp_launches(plan, 300) == 1 and sc.exp_launches(sc.exp_plan(0, n), 300) == 0
    if B == 1797:
        assert plan["blocks"] == 113
    if (B, n) == (8192, 64):
        assert (plan["npad"], plan["threads"], plan["blocks"]) == (64, 256, 512)
    assert sc.exp_plan(B, n, "resident") == plan


@pytest.mark.parametrize("n", [1, 5, 64, 145, 300, 784, 2100, 7200, 14_401, 40_000])
def test_exp_plan_streamed(n):
    """Above 144 bins (or forced) the streamed plan: tiles of 64 pairs by
    64, 32 or 16 columns over the pairs and the columns, both rounded up
    to 64, 2 n_iter + 4 launches; the widest tile that gives every SM a
    block; every n gets one and none raises."""
    assert sc.exp_plan(1, n)["path"] == ("resident" if n <= 144 else "streamed")
    for B in (1, 64, 65, 130, 1797, 8192):
        plan = sc.exp_plan(B, n, "streamed")
        assert plan["npad"] % 64 == 0 and n <= plan["npad"] < n + 64
        assert plan["Bp"] % 64 == 0 and B <= plan["Bp"] < B + 64
        assert plan["blocks"] == plan["npad"] // plan["cols"] * (plan["Bp"] // 64)
        assert plan["threads"] == 128 and plan["smem"] <= 48 * 1024
        assert sc.exp_launches(plan, 20) == 44
        wider = [c for c in sc.STREAM_COLS if c > plan["cols"]]
        assert plan["cols"] == 16 or plan["blocks"] >= sc.SMS
        assert all(plan["npad"] // c * (plan["Bp"] // 64) < sc.SMS for c in wider)
        for cols in sc.STREAM_COLS:
            assert sc.exp_plan(B, n, "streamed", cols)["cols"] == cols


def test_exp_plan_refuses():
    # the cells timed by tools/time_k8.py: 64 pairs at 2,100 and 7,200
    # bins, 8,192 at 300 and 784
    assert sc.exp_plan(64, 2100)["cols"] == 16 and sc.exp_plan(64, 7200)["cols"] == 32
    assert sc.exp_plan(8192, 300)["cols"] == 64 and sc.exp_plan(8192, 784)["cols"] == 64
    assert sc.exp_plan(1, 144)["path"] == "resident"
    assert sc.exp_plan(1, 145)["path"] == "streamed"
    with pytest.raises(ValueError, match="path must be"):
        sc.exp_plan(1, 64, "tiles")
    with pytest.raises(ValueError, match="no resident plan"):
        sc.exp_plan(1, 160, "resident")
    with pytest.raises(ValueError, match="cols must be one of"):
        sc.exp_plan(1, 300, "streamed", 8)
    with pytest.raises(ValueError, match="n >= 1"):
        sc.exp_plan(1, 0)
    assert sc.exp_plan(64 * 65_535, 300)["Bp"] == 64 * 65_535
    with pytest.raises(ValueError, match="at most 4194240 pairs"):
        sc.exp_plan(64 * 65_535 + 1, 300)


@pytest.mark.parametrize("B", [1, 2, 256, 4096])
@pytest.mark.parametrize("n", [5, 64, 192, 224, 300, 784, 14_401])
def test_log_plan(B, n):
    """K8b's plan: resident up to 224 bins (npad n rounded up to 32, one
    launch), streamed beyond (tiles of P pairs by 64 outputs, npad n
    rounded up to 64, the workspace's rows Bp to P); the largest thread
    tile that still gives LOG_MIN_LANES threads (resident: not 4 x 4); at
    most 256 threads a block; resident: no block size in range loads the
    busiest SM less; streamed: no SM without a block where the pairs
    allow it; the shared memory fits."""
    plan = sc.log_plan(B, n)
    c, r = plan["C"], plan["R"]
    assert (c, r) in sc.LOG_TILES and plan["P"] % r == 0
    tiles = sc.LOG_TILES if plan["path"] == "streamed" else sc.LOG_TILES[1:]
    first = next((t for t in tiles if -(-B // t[1]) * -(-n // t[0]) >= sc.LOG_MIN_LANES),
                 (1, 1))
    assert (c, r) == first
    assert 0 < plan["threads"] <= sc.LOG_THREADS and plan["smem"] <= sc.SMEM_MAX
    if n <= sc.LOG_RES_MAX_BINS:
        assert plan["path"] == "resident" and plan["Bp"] == 0
        assert plan["npad"] % 32 == 0 and n <= plan["npad"] < n + 32
        TO = -(-n // c)
        assert plan["threads"] == plan["P"] // r * TO >= 32
        assert plan["blocks"] * plan["P"] >= B > (plan["blocks"] - 1) * plan["P"]
        assert plan["smem"] == 4 * (plan["npad"] ** 2 + 2 * plan["P"] * (2 * plan["npad"] + 4))
        cost = sc._res_cost(B, plan["P"], plan["threads"], plan["smem"])
        for tp in range(-(-32 // TO), sc.LOG_THREADS // TO + 1):
            smem = sc._log_res_smem(plan["npad"], tp * r)
            assert smem > sc.SMEM_MAX or sc._res_cost(B, tp * r, tp * TO, smem) >= cost
    else:
        assert plan["path"] == "streamed"
        assert plan["npad"] % 64 == 0 and n <= plan["npad"] < n + 64
        assert plan["Bp"] % plan["P"] == 0 and B <= plan["Bp"] < B + plan["P"]
        assert plan["threads"] == plan["P"] // r * 64 // c
        assert plan["blocks"] == plan["npad"] // 64 * (plan["Bp"] // plan["P"])
        assert plan["blocks"] >= sc.SMS or plan["P"] == r
        assert plan["P"] <= max(r, B)  # no pair tile wider than the batch
    if (B, n) == (4096, 64):  # the digits' chunk
        assert (c, r, plan["P"], plan["blocks"]) == (4, 2, 16, 256)
    if (B, n) == (2, 14_401):  # 2 pairs still spread over the card
        assert (c, r, plan["P"], plan["blocks"]) == (1, 1, 2, 226)
    forcible = sc.log_plans(B, n)
    assert forcible == ([("resident", t) for t in sc.LOG_RES_TILES]
                        if n <= sc.LOG_RES_MAX_BINS else []) + [
        ("streamed", t) for t in sc.LOG_TILES]
    for path, tile in forcible:
        forced = sc.log_plan(B, n, path, tile)
        assert (forced["path"], forced["C"], forced["R"]) == (path, *tile)
        assert forced["threads"] <= sc.LOG_THREADS and forced["smem"] <= sc.SMEM_MAX


def test_log_launches():
    """One launch resident, 2 n_iter + 2 streamed (the half steps, the
    cost's row sums, their sums), none for no pairs; the plan refuses a
    wrong path, tile or size."""
    assert sc.log_launches(sc.log_plan(4096, 64), 200) == 1
    assert sc.log_launches(sc.log_plan(4096, 64, "streamed"), 200) == 402
    assert sc.log_launches(sc.log_plan(2, 14_401), 1) == 4
    assert sc.log_launches(sc.log_plan(8192, 784), 0) == 2
    assert sc.log_launches(sc.log_plan(0, 784), 20) == 0
    assert sc.log_launches(sc.log_plan(0, 64), 20) == 0
    assert sc.log_plan(1, 224)["path"] == "resident"
    assert sc.log_plan(1, 225)["path"] == "streamed"
    with pytest.raises(ValueError, match="path must be"):
        sc.log_plan(1, 64, "global")
    assert sc.log_plan(4096, 224)["npad"] == 224
    with pytest.raises(ValueError, match="no resident plan"):
        sc.log_plan(1, 225, "resident")
    with pytest.raises(ValueError, match="tile must be one of"):
        sc.log_plan(1, 64, None, (2, 2))
    with pytest.raises(ValueError, match="tile must be one of"):
        sc.log_plan(1, 64, "resident", (4, 4))
    with pytest.raises(ValueError, match="n >= 1"):
        sc.log_plan(1, 0)
    assert sc.log_plan(64 * 65_535, 300)["Bp"] == 64 * 65_535
    with pytest.raises(ValueError, match="at most 4194240 pairs"):
        sc.log_plan(64 * 65_535 + 1, 300)


def _log_case(n, count, seed):
    X, C = _problem(n, seed=seed)
    IJ = _pairs(len(X), count, seed=seed)
    Xn = tw.unit_mass(X)
    # a power of two near 0.02 max C: the plain version's x / eps on the
    # CPU (a division) is then the kernel's x * (1 / eps) (the card's), which
    # the potentials of an all-zero histogram (-1e9 / eps, where a float32
    # ulp is hundreds) would otherwise tell apart
    eps = float(2.0 ** np.round(np.log2(0.02 * C.max())))
    return (torch.from_numpy(Xn[IJ[:, 0]]), torch.from_numpy(Xn[IJ[:, 1]]),
            torch.from_numpy(C), eps)


@pytest.mark.parametrize("n,n_iter", [(64, 0), (64, 1), (64, 2), (64, 200), (5, 30),
                                      (100, 30), (300, 3)])
def test_k8b_model_matches_plain(n, n_iter):
    """K8b's arithmetic, in its order (``log_batch_model``), against the
    plain version on the digits at the metric's n_iter and on random
    asymmetric costs (the orientation of -C/eps and its transpose shows),
    with the zero and one-bin rows and self pairs: within K8B_RTOL, the
    bound the card holds the kernel to (only the order of the float32 sums
    and the float64 closing sum differ)."""
    A, B, C, eps = _log_case(n, 60, seed=n + n_iter)
    want = tw.sinkhorn_batch_plain(A, B, C, eps, n_iter)
    got = sc.log_batch_model(A, B, C, eps, n_iter)
    assert got.dtype == torch.float32 and got.shape == want.shape
    # an all-zero histogram against a non-zero one costs inf in both
    np.testing.assert_array_equal(np.isfinite(got.numpy()), np.isfinite(want.numpy()))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=K8B_RTOL)


def test_k8b_model_matches_jax():
    """The model against the JAX package's ``_sinkhorn_batch`` on the
    digits at n_iter 60, to K8B_RTOL."""
    A, B, C, eps = _log_case(64, 40, seed=9)
    want = np.asarray(jw._sinkhorn_batch(A.numpy(), B.numpy(), C.numpy(), np.float32(eps), 60))
    got = sc.log_batch_model(A, B, C, eps, 60)
    np.testing.assert_allclose(got.numpy(), want, rtol=K8B_RTOL)


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
