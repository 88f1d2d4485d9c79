"""The hand-written CUDA kernels on the card, held against their plain
PyTorch versions.  Every test here needs an NVIDIA card (marker ``gpu``)
and skips without one.  This file imports no JAX, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest -q -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from annchor_tpu_torch import Annchor
from annchor_tpu_torch.datasets import make_strings
from annchor_tpu_torch.ops.device_pipeline import default_uniforms
from annchor_tpu_torch.ops.levenshtein import encode_strings, levenshtein_scalar
from annchor_tpu_torch.ops.levenshtein_cuda import K1, launch_plan, myers_pairs_cuda
from annchor_tpu_torch.ops.levenshtein_myers import (
    MyersEncoding,
    myers_pairs,
    myers_pairs_plain,
)

pytestmark = pytest.mark.gpu

# K8b against its plain version: both float32, summed in other orders;
# the cost exp(-C/eps + f/eps + g/eps) C takes the potentials' rounding
# whole, and f/eps, g/eps reach max(C)/eps = 50 (a float32 ulp of 3.8e-6)
K8B_RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _strings(rng, n, lo, hi, alphabet):
    chars = list(alphabet)
    return [
        "".join(rng.choice(chars, size=int(rng.integers(lo, hi + 1))))
        for _ in range(n)
    ]


@pytest.mark.parametrize(
    "alphabet,lo,hi",
    [("ab", 0, 70), ("ACGT", 426, 550), ("abcdefghijklmnopqrstuvwxyz", 0, 140),
     ("ACGT", 2100, 2300)],
)
def test_k1_bit_equal_to_plain(cuda, alphabet, lo, hi):
    rng = np.random.default_rng(len(alphabet) + hi)
    strs = _strings(rng, 64, lo, hi, alphabet)
    strs[0] = ""
    strs[1] = "a" * 33
    enc = MyersEncoding.from_codes(*encode_strings(strs), cuda)
    I = torch.as_tensor(rng.integers(0, 64, size=3000), device=cuda)
    J = torch.as_tensor(rng.integers(0, 64, size=3000), device=cuda)
    before = K1.launches
    got = myers_pairs(enc, I, J)
    torch.cuda.synchronize()
    assert K1.launches > before
    assert torch.equal(got, myers_pairs_plain(enc, I, J))
    Ih, Jh = I[:16].tolist(), J[:16].tolist()
    want = [levenshtein_scalar(strs[i], strs[j]) for i, j in zip(Ih, Jh)]
    assert got[:16].tolist() == want


GREEK = "".join(chr(0x100 + i) for i in range(192))


def _mode_case(rng, case):
    """(strings, I, J) of one named case: patterns of 1, 31-33, 40-48,
    63-64 and 63-65 words and of more than 64, alphabets of 2, 4, 26 and
    192 symbols, a one-pair batch, a 1,600-pair column, and a skewed set
    whose few long strings send their pairs down the overflow lists."""
    if case == "one pair":
        strs = _strings(rng, 2, 400, 500, "ACGT")
        return strs, [0], [1]
    if case == "column":
        strs = list(make_strings()[0])
        return strs, [1126] * len(strs), list(range(len(strs)))
    if case == "skewed":
        # 400 short strings, then 2 of 35-44 words and 2 of 66-72: under
        # 1 % of the set, so the main launch holds only the short ones
        strs = (_strings(rng, 400, 0, 300, "ACGT") + _strings(rng, 2, 1100, 1400, "ACGT")
                + _strings(rng, 2, 2100, 2300, "ACGT"))
        tail = np.arange(400, 404)
        I = np.concatenate([rng.integers(0, 404, size=2000), np.repeat(tail, 4),
                            rng.choice(tail, 200)])
        J = np.concatenate([rng.integers(0, 404, size=2000), np.tile(tail, 4),
                            rng.integers(0, 404, size=200)])
        return strs, I, J
    alphabet, lo, hi = {
        "words 1": ("ACGT", 0, 32),
        "words 31-33": ("ab", 961, 1056),
        "words 40-48": ("ACGT", 1249, 1536),
        "words 63-64": ("ACGT", 1985, 2048),
        "words 63-65": ("ACGT", 1985, 2080),
        "words >64": ("ACGT", 2100, 2300),
        "alphabet 26": ("abcdefghijklmnopqrstuvwxyz", 0, 140),
        "alphabet 192": (GREEK, 150, 400),
    }[case]
    strs = _strings(rng, 48, lo, hi, alphabet)
    if alphabet == GREEK:
        strs[2] = GREEK  # every symbol present: the encoding has 192
    if case == "words 63-65":
        strs[3] = "A" * 2080  # 65 words
    I = rng.integers(0, len(strs), size=2000)
    J = rng.integers(0, len(strs), size=2000)
    I[: len(strs)] = np.arange(len(strs))
    return strs, I, J


@pytest.mark.parametrize(
    "case",
    ["words 1", "words 31-33", "words 40-48", "words 63-64", "words 63-65", "words >64",
     "alphabet 26", "alphabet 192", "one pair", "column", "skewed"],
)
@pytest.mark.parametrize("mode", ["thread", "group"])
def test_k1_mode_bit_equal_to_plain(cuda, mode, case):
    rng = np.random.default_rng(sum(map(ord, case)))
    strs, I, J = _mode_case(rng, case)
    enc = MyersEncoding.from_codes(*encode_strings(strs), cuda)
    if case == "alphabet 192":
        assert enc.alphabet == 192
    I = torch.as_tensor(np.asarray(I), device=cuda)
    J = torch.as_tensor(np.asarray(J), device=cuda)
    plans = launch_plan(len(I), enc.wbulk, enc.wmax, enc.alphabet, mode)
    if enc.wbulk <= 64:
        assert plans[0].mode == mode
    if case == "skewed":  # the main launch, then thread and long mode on lists
        assert [p.mode for p in plans] == [mode, "thread", "long"]
    before = dict(K1.mode_launches)
    got = myers_pairs_cuda(enc.peq, enc.ids, enc.lengths, I, J, enc.wmax, mode,
                           wbulk=enc.wbulk)
    torch.cuda.synchronize()
    for m in K1.mode_launches:
        assert K1.mode_launches[m] - before[m] == sum(p.mode == m for p in plans)
    assert torch.equal(got, myers_pairs_plain(enc, I, J))
    Ih, Jh = I[:12].tolist(), J[:12].tolist()
    assert got[:12].tolist() == [levenshtein_scalar(strs[i], strs[j]) for i, j in zip(Ih, Jh)]


@pytest.mark.parametrize("data", ["uniform", "skewed"])
@pytest.mark.parametrize("mode", ["auto", "thread", "group"])
def test_k1_call_does_not_sync(cuda, mode, data):
    """No K1 call waits for the card: not the launch plan, not the
    expanded (stride 0) id of an anchor column, not the overflow lists
    that a skewed set's long strings take."""
    strs = list(make_strings(n=200, length=300, seed=3)[0])
    if data == "skewed":
        strs[7] = strs[7] * 7  # the anchor: 2,100 characters or so
    enc = MyersEncoding.from_codes(*encode_strings(strs), cuda)
    I = torch.tensor(7, device=cuda).expand(len(strs))
    J = torch.arange(len(strs), device=cuda, dtype=torch.int32)
    want = myers_pairs_plain(enc, I, J)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = myers_pairs_cuda(enc.peq, enc.ids, enc.lengths, I, J, enc.wmax, mode,
                               wbulk=enc.wbulk)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)


def test_k1_wrapper_checks_inputs(cuda):
    enc = MyersEncoding.from_codes(*encode_strings(["ab", "abc"]), cuda)
    I = torch.zeros(2, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        myers_pairs_cuda(enc.peq.float(), enc.ids, enc.lengths, I, I)
    with pytest.raises(ValueError):
        myers_pairs_cuda(enc.peq, enc.ids, enc.lengths, I.cpu(), I)
    with pytest.raises(ValueError):
        myers_pairs_cuda(enc.peq, enc.ids[:, ::2], enc.lengths, I, I)


@pytest.mark.parametrize("case", ["acgt", "astral_nul", "symbols_193", "sequences"])
def test_encoding_built_on_card_equals_host_build(cuda, case):
    """``MyersEncoding.on_device`` on the card gives the host build's
    tables (``from_codes``, uploaded) and host sizes bit for bit: 1,600
    ACGT strings, BMP and astral code points with NUL, 193 symbols (the
    row DP's encoding) and integer sequences past 2^22."""
    from annchor_tpu_torch.ops.levenshtein import RowDPEncoding, encode_sequences

    rng = np.random.default_rng(11)
    if case == "acgt":
        X = list(make_strings()[0])
    elif case == "sequences":
        X = [list(rng.choice([3, 7, (1 << 22) + 1, 1 << 30], int(k)))
             for k in rng.integers(0, 300, 64)]
    else:
        syms = (["a", "\x00", "\u00e9", "\U0001F600", "\U0010FFFF"] if case == "astral_nul"
                else [chr(0x4E00 + i) for i in range(100)] + [chr(0x20000 + i)
                                                              for i in range(93)])
        X = ["".join(syms[i] for i in rng.integers(0, len(syms), int(k)))
             for k in rng.integers(0, 700, 64)] + ["".join(syms)]
    codes = encode_strings(X) if isinstance(X[0], str) else encode_sequences(X)
    want = MyersEncoding.from_codes(*codes, cuda)
    got = MyersEncoding.on_device(X, cuda)
    assert type(got) is type(want)
    assert isinstance(got, RowDPEncoding) == (case == "symbols_193")
    for slot in type(want).__slots__:
        a, b = getattr(got, slot), getattr(want, slot)
        if isinstance(b, torch.Tensor):
            assert a.device == b.device and a.dtype == b.dtype and torch.equal(a, b), slot
        else:
            assert a == b, slot


def test_fit_on_card_equals_fit_on_cpu(cuda):
    """The same small fit, with the same uniforms, on the card (K1) and
    on the CPU (plain versions): same anchors, evals and graph."""
    X, _ = make_strings(n=300, length=60, seed=7)
    kw = dict(n_anchors=12, n_neighbors=10, n_samples=800, p_work=0.3)

    def uniforms(seed, loop, m, device):
        return default_uniforms(seed, loop, m, "cpu").to(device)

    a = Annchor(list(X), "levenshtein", device="cpu", uniforms=uniforms, **kw)
    a.fit()
    b = Annchor(list(X), "levenshtein", device=cuda, uniforms=uniforms, **kw)
    b.fit()
    np.testing.assert_array_equal(a.A, b.A)
    assert a.evals == b.evals
    np.testing.assert_array_equal(a.neighbor_graph[0], b.neighbor_graph[0])
    np.testing.assert_array_equal(a.neighbor_graph[1], b.neighbor_graph[1])


def test_exact_oracles_on_card_equal_cpu(cuda):
    """exact_knn, exact_rows and exact_query_rows through K1 on the card
    equal their plain versions on the CPU, tie order included."""
    import annchor_tpu_torch as att

    X, _ = make_strings(n=200, length=60, seed=5)
    X = list(X)
    for dev_out, cpu_out in (
        (att.exact_knn(X, "levenshtein", k=9, block=16, device="cuda"),
         att.exact_knn(X, "levenshtein", k=9, block=16, device="cpu")),
        ((att.exact_rows(X, "levenshtein", rows=[3, 77], device="cuda"),),
         (att.exact_rows(X, "levenshtein", rows=[3, 77], device="cpu"),)),
        ((att.exact_query_rows(X[:150], X[150:], "levenshtein", device="cuda"),),
         (att.exact_query_rows(X[:150], X[150:], "levenshtein", device="cpu"),)),
    ):
        for a, b in zip(dev_out, cpu_out):
            np.testing.assert_array_equal(a, b)


def test_sinkhorn_scout_on_card_matches_cpu(cuda):
    """The exp-domain Sinkhorn scout rounds each float64 product once to
    float32 on both devices; the sums run in other orders, so values agree
    to a few float32 ulps, and the max-min anchors are the same."""
    from annchor_tpu_torch.datasets import digit_images, grid_cost_matrix
    from annchor_tpu_torch.ops.wasserstein import SinkhornExpEngine

    X, _ = digit_images()
    X = X[:400]
    M = grid_cost_matrix()
    IJ = np.random.default_rng(3).integers(0, len(X), size=(3000, 2))
    card = SinkhornExpEngine(M, n_iter=100, chunk=1024, device="cuda")
    cpu = SinkhornExpEngine(M, n_iter=100, chunk=1024, device="cpu")
    np.testing.assert_allclose(card(X, X, IJ), cpu(X, X, IJ), rtol=2e-6)
    np.testing.assert_array_equal(card.fused_maxmin(X, 10, 2)[0], cpu.fused_maxmin(X, 10, 2)[0])


@pytest.mark.parametrize("size,lo,hi", [(193, 0, 70), (256, 426, 550), (1000, 0, 2100)])
def test_k10_bit_equal_to_plain(cuda, size, lo, hi):
    """K10 over more than 192 symbols against its plain version, both
    argument orders (int64 and int32 ids), with no host sync in the
    wrapper, and a few pairs against the pure-Python DP."""
    from annchor_tpu_torch.ops.levenshtein import RowDPEncoding, lev_pairs_plain
    from annchor_tpu_torch.ops.levenshtein_rowdp_cuda import K10, plan_for, rowdp_pairs_cuda

    rng = np.random.default_rng(size + hi)
    strs = _strings(rng, 60, lo, hi, [chr(0x100 + i) for i in range(size)])
    strs[:3] = ["", chr(0x100), chr(0x101) * 2]
    enc = MyersEncoding.from_codes(*encode_strings(strs), cuda)
    assert isinstance(enc, RowDPEncoding)
    I = torch.as_tensor(rng.integers(0, 60, size=2500), device=cuda)
    J = torch.as_tensor(rng.integers(0, 60, size=2500), device=cuda)
    before = K10.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = myers_pairs(enc, I, J)
        swapped = rowdp_pairs_cuda(enc, J.int(), I.int())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert K10.launches == before + 2 * len(plan_for(enc, 2500))
    want = lev_pairs_plain(enc, I, J)
    assert torch.equal(got, want) and torch.equal(swapped, want)
    Ih, Jh = I[:12].tolist(), J[:12].tolist()
    assert got[:12].tolist() == [levenshtein_scalar(strs[i], strs[j]) for i, j in zip(Ih, Jh)]


def _k10_case(rng, case):
    """Strings of one K10 mode case: "short" (193 symbols, lengths 0-70:
    group mode stages the tables in shared memory), "strings-1600" (256
    symbols, 426-550) and "cjk" (20,000 CJK and astral code points,
    lengths 0-600, one string of 5,000 and one of 2,600 characters whose
    pair runs down the overflow lists into long mode, and the empty
    string)."""
    if case == "short":
        return _strings(rng, 120, 0, 70, [chr(0x100 + i) for i in range(193)])
    if case == "strings-1600":
        return _strings(rng, 80, 426, 550, [chr(0x100 + i) for i in range(256)])
    cjk = [chr(0x4E00 + i) for i in range(16_000)] + [chr(0x20000 + i) for i in range(4000)]
    # 200 strings: the two long ones are the 1 % past the bulk
    return ["", *_strings(rng, 1, 5000, 5000, cjk), *_strings(rng, 1, 2600, 2600, cjk),
            *_strings(rng, 197, 0, 600, cjk)]


@pytest.mark.parametrize("case", ["short", "strings-1600", "cjk"])
@pytest.mark.parametrize("mode", ["thread", "group"])
def test_k10_mode_bit_equal_to_plain(cuda, mode, case):
    """Each first-launch mode of K10 against the plain version, with self
    pairs and both argument orders; each launch of the plan counted in
    its mode."""
    from annchor_tpu_torch.ops.levenshtein import lev_pairs_plain
    from annchor_tpu_torch.ops.levenshtein_rowdp_cuda import K10, plan_for, rowdp_pairs_cuda

    rng = np.random.default_rng(sum(map(ord, case)))
    strs = _k10_case(rng, case)
    enc = MyersEncoding.from_codes(*encode_strings(strs), cuda)
    n = len(strs)
    I = np.concatenate([rng.integers(0, n, 1500), np.arange(n)])
    J = np.concatenate([rng.integers(0, n, 1500), np.arange(n)])
    if case == "cjk":  # the two long strings, either way, and against ""
        I = np.concatenate([I, [1, 2, 0, 1]])
        J = np.concatenate([J, [2, 1, 1, 5]])
    I = torch.as_tensor(I, device=cuda)
    J = torch.as_tensor(J, device=cuda)
    plans = plan_for(enc, len(I), mode)
    assert plans[0].mode == mode and plans[0].smem == (case == "short" and mode == "group")
    if case == "cjk":
        assert [p.mode for p in plans] == [mode, "thread", "long"]
    before = dict(K10.mode_launches)
    got = rowdp_pairs_cuda(enc, I, J, mode)
    swapped = rowdp_pairs_cuda(enc, J, I, mode)
    torch.cuda.synchronize()
    for m in K10.mode_launches:
        assert K10.mode_launches[m] - before[m] == 2 * sum(p.mode == m for p in plans)
    # small chunks: a chunk's rows run as long as its longest pattern
    want = lev_pairs_plain(enc, I, J, chunk=256)
    assert torch.equal(got, want) and torch.equal(swapped, want)


@pytest.mark.parametrize("card", [0, 1], ids=["cuda0", "cuda1"])
def test_sharded_levenshtein_engine_on_card(cuda, card, monkeypatch):
    """The Levenshtein engine on a 4-shard mesh over one card (repeats of
    it) is bit-equal to the unsharded engine on 20,000 random pairs of
    strings-1600, and every shard launches K1.  ``cuda1`` needs a second
    card."""
    from annchor_tpu_torch import parallel
    from annchor_tpu_torch.metrics import get_function_from_input

    if card >= torch.cuda.device_count():
        pytest.skip("needs a card cuda:%d" % card)
    dev = torch.device("cuda", card)
    X = list(make_strings()[0])
    rng = np.random.default_rng(card)
    I = torch.as_tensor(rng.integers(0, len(X), 20_000), device=dev)
    J = torch.as_tensor(rng.integers(0, len(X), 20_000), device=dev)
    monkeypatch.setenv("ANNCHOR_TPU_DISABLE_SHARDING", "1")
    want = get_function_from_input("levenshtein", device=dev).batch.batch_dev(X, I, J)
    monkeypatch.setattr(parallel, "auto_mesh",
                        lambda device: parallel.mesh_for(4, devices=[dev]))
    eng = get_function_from_input("levenshtein", device=dev).batch
    K1.reset_counts()
    got = eng.batch_dev(X, I, J)
    torch.cuda.synchronize()
    shards = dict(K1.shard_launches)
    assert got.device == dev and torch.equal(got, want)
    assert sorted(shards) == [0, 1, 2, 3] and min(shards.values()) >= 1


# K4, the dense tropical tighten, and K9a, the band build's linf score

# (nx, share of the i < j pairs tracked, share computed, rows with no
# computed entry, column ranges: the whole, a sub-range, and two
# sub-ranges that together make the whole)
K4_CASES = {
    "nx1": (1, 1.0, 1.0, 0),
    "nx17": (17, 0.8, 0.5, 0),
    "nx1000": (1000, 0.2, 0.5, 0),  # not a multiple of the 64-point tile
    "nx1600": (1600, 0.09, 0.6, 0),
    "nx4096": (4096, 0.02, 0.5, 0),
    "empty-rows": (300, 0.5, 0.5, 40),
    "full": (257, 1.0, 1.0, 0),
}


def _k4_matrix(case, dev):
    """(E, V, Einf) as ``tighten_full`` builds them from a random state:
    integer and arbitrary float32 distances."""
    from annchor_tpu_torch.ops.bounds_update import _build_E

    nx, density, computed, empty = K4_CASES[case]
    rng = np.random.default_rng(nx)
    iu, ju = np.triu_indices(nx, 1)
    keep = rng.random(iu.size) < density
    IJ = torch.as_tensor(np.stack([iu[keep], ju[keep]], axis=1), device=dev)
    m = IJ.shape[0]
    RA = np.where(rng.random(m) < 0.5, rng.integers(0, 400, m), rng.random(m) * 400)
    done = (rng.random(m) < computed) & (iu[keep] >= empty) & (ju[keep] >= empty)
    E, V = _build_E(IJ, torch.as_tensor(RA.astype(np.float32), device=dev),
                    torch.as_tensor(done, device=dev), nx)
    return E, V, torch.where(V, E, torch.full_like(E, float("inf")))


@pytest.mark.parametrize("case", list(K4_CASES))
def test_k4_bit_equal_to_plain(cuda, case):
    from annchor_tpu_torch.ops import device_pipeline as dp
    from annchor_tpu_torch.ops.tropical_cuda import K4

    E, V, Einf = _k4_matrix(case, cuda)
    nx = E.shape[0]
    a, b = nx // 3, (2 * nx) // 3 + 1
    got = {}
    for y0, y1 in ((0, nx), (a, b), (0, a), (a, nx)):
        before = K4.launches
        got[y0, y1] = dp.tropical_product(E, V, Einf, y0, y1)
        torch.cuda.synchronize()
        assert K4.launches == before + 1
        want = dp.tropical_product_plain(E, V, Einf, y0, y1)
        assert torch.equal(got[y0, y1][0], want[0]) and torch.equal(got[y0, y1][1], want[1])
    lo, hi = got[0, a], got[a, nx]
    assert torch.equal(torch.maximum(lo[0], hi[0]), got[0, nx][0])
    assert torch.equal(torch.minimum(lo[1], hi[1]), got[0, nx][1])


def test_k4_call_does_not_sync(cuda):
    from annchor_tpu_torch.ops import device_pipeline as dp

    E, V, Einf = _k4_matrix("nx1000", cuda)
    want = dp.tropical_product(E, V, Einf, 0, 1000)  # builds the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = dp.tropical_product(E, V, Einf, 0, 1000)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _k9a_problem(na, dev, nx=300, nxp=384, zero_thr=True):
    """The band build's padded operands (``candidate_pairs_device_budgeted``):
    D32p, Sp, effp (+inf on padding, some rows 0: F6), inv_bin, and a
    pass-2 threshold vector with zeros and +inf."""
    from annchor_tpu_torch.ops.features import anchor_membership

    rng = np.random.default_rng(na)
    D = np.where(rng.random((nx, na)) < 0.5, rng.integers(0, 60, (nx, na)),
                 rng.random((nx, na)) * 60).astype(np.float32)
    S, _ = anchor_membership(D, min(5, na), dev)
    eff = rng.integers(1, 4, nx).astype(np.float32)
    if zero_thr:
        eff[rng.random(nx) < 0.1] = 0.0
    pad = nxp - nx
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    thr = rng.choice(np.array([0.0, 5.0, 12.5, 20.0, 40.0, np.inf], dtype=np.float32), nxp)
    return dict(nx=nx, D32p=torch.nn.functional.pad(t(D), (0, 0, 0, pad)),
                Sp=torch.nn.functional.pad(S, (0, 0, 0, pad)),
                effp=torch.nn.functional.pad(t(eff), (0, pad), value=float("inf")),
                inv_bin=t(np.float32(256 / (2.0 * D.max() + 1e-6))), thr=t(thr))


@pytest.mark.parametrize("na", [5, 32, 48, 96, 160])
@pytest.mark.parametrize("mode", ["hist", "keep"])
def test_k9a_bit_equal_to_plain(cuda, na, mode):
    """Every 128-row band of 300 points padded to 384 (padding rows and
    columns, zero thresholds, the diagonal, +inf thresholds), then a
    column count that is not a multiple of 4 (the unpacked stores); in
    hist mode the thresholds from the histogram equal the plain bins'
    bisection.  At 160 anchors a point's bits take 5 words, past the
    ones held in registers."""
    from annchor_tpu_torch.ops import band_linf_cuda, locality
    from annchor_tpu_torch.ops.band_linf_cuda import K9A

    P = _k9a_problem(na, cuda)
    D32p, Sp, effp, inv, thr = P["D32p"], P["Sp"], P["effp"], P["inv_bin"], P["thr"]
    bin_w = 1.0 / inv
    for ncols in (384, 301):
        cols = band_linf_cuda.operands(D32p[:ncols], Sp[:ncols])
        for r0 in range(0, ncols, 128):
            r1 = r0 + 128
            args = (D32p[:ncols], Sp[:ncols], Sp[r0:r1], D32p[r0:r1], effp[r0:r1],
                    effp[:ncols])
            before = K9A.mode_launches[mode]
            if mode == "hist":
                got = locality._band_hist_sym(*args, r0, P["nx"], inv, 256, ncols, cols=cols)
                want = locality._band_hist_sym_plain(*args, r0, P["nx"], inv, 256, ncols)
                for cap in (1, 7, 40):
                    bins = locality._band_bins_sym_plain(*args, r0, P["nx"], inv, 256, ncols)
                    assert torch.equal(locality._band_thr_from_hist(got, cap, bin_w),
                                       locality._band_thr_from_bins(bins, cap, bin_w, 256))
            else:
                got = locality._band_keep2_dense(*args, thr, r0, P["nx"], ncols, cols=cols)[0]
                want = locality._band_keep2_plain(*args, thr, r0, P["nx"], ncols)
            torch.cuda.synchronize()
            assert K9A.mode_launches[mode] == before + 1
            assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["hist", "keep"])
@pytest.mark.parametrize("skip", ["none", "most"])
def test_k9a_tile_skip(cuda, mode, skip):
    """The tile admit test: with every effective threshold 0 every tile
    holds an admitted pair (no tile skips its score); with thresholds
    above any shared count except for points 64-127, only the tiles that
    hold one of them as a row or a column score.  Both bit-equal to the
    plain version."""
    from annchor_tpu_torch.ops import band_linf_cuda, locality

    P = _k9a_problem(96, cuda)
    D32p, Sp, inv, thr = P["D32p"], P["Sp"], P["inv_bin"], P["thr"]
    effp = torch.zeros_like(P["effp"]) if skip == "none" else torch.full_like(P["effp"], 99.0)
    if skip == "most":
        effp[64:128] = 2.0
    effp[P["nx"]:] = float("inf")
    cols = band_linf_cuda.operands(D32p, Sp)
    for r0 in (0, 128, 256):
        args = (D32p, Sp, Sp[r0:r0 + 128], D32p[r0:r0 + 128], effp[r0:r0 + 128], effp)
        if mode == "hist":
            got = locality._band_hist_sym(*args, r0, P["nx"], inv, 256, 384, cols=cols)
            want = locality._band_hist_sym_plain(*args, r0, P["nx"], inv, 256, 384)
        else:
            got = locality._band_keep2_dense(*args, thr, r0, P["nx"], 384, cols=cols)[0]
            want = locality._band_keep2_plain(*args, thr, r0, P["nx"], 384)
        assert torch.equal(got, want)
        if skip == "none" and mode == "hist":
            assert int(got.sum()) > 0


def test_k9a_call_does_not_sync(cuda):
    from annchor_tpu_torch.ops import band_linf_cuda, locality

    P = _k9a_problem(96, cuda)
    D32p, Sp, effp = P["D32p"], P["Sp"], P["effp"]
    cols = band_linf_cuda.operands(D32p, Sp)
    args = (D32p, Sp, Sp[128:256], D32p[128:256], effp[128:256], effp)
    want = locality._band_hist_sym(*args, 128, P["nx"], P["inv_bin"], 256, 384,
                                   cols=cols)  # builds the kernel
    bin_w = 1.0 / P["inv_bin"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        thr = locality._band_thresholds(*args, 128, P["nx"], P["inv_bin"], bin_w, 256, 5, 384,
                                        "linf", cols)
        keep = locality._band_keep2_dense(*args, P["thr"], 128, P["nx"], 384, cols=cols)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(thr, locality._band_thr_from_hist(want, 5, bin_w))
    assert torch.equal(keep[0], locality._band_keep2_plain(*args, P["thr"], 128, P["nx"], 384))


def _k8_problem(n, m, seed):
    """(X float32 (m, n), C float32 (n, n)): the digits and their grid cost
    at n 64, else random histograms (30 % zero bins) and an asymmetric
    cost; rows 0-7 all zero, rows 8-15 one bin each."""
    from annchor_tpu_torch.datasets import digit_images, grid_cost_matrix

    rng = np.random.default_rng(seed)
    if n == 64:
        X = digit_images()[0][:m].astype(np.float32)
        C = grid_cost_matrix().astype(np.float32)
    else:
        X = (rng.random((m, n)) * (rng.random((m, n)) < 0.7)).astype(np.float32)
        C = (rng.random((n, n)) * 10).astype(np.float32)
    X[:16] = 0
    X[np.arange(8, 16), (np.arange(8) * 7) % n] = 5
    return X, C


def _k8_ids(m, B, seed, dev):
    IJ = np.random.default_rng(seed).integers(0, m, size=(B, 2))
    IJ[: min(B, 6)] = np.array([(0, 0), (0, 20), (20, 0), (8, 8), (8, 9), (40, 40)])[:B]
    t = torch.as_tensor(IJ, device=dev)
    return t[:, 0], t[:, 1]


@pytest.mark.parametrize("B", [1, 256, 1797, 8192])
@pytest.mark.parametrize("n", [5, 64, 100, 300])
def test_k8a_matches_plain(cuda, n, B):
    """K8a against its plain version to rtol 2e-6 (cuBLAS sums the float64
    products in another order) and against its torch model bit for bit,
    with all-zero rows, one-bin rows and self pairs; at n 300 the streamed
    path (2 n_iter + 4 launches); B 1,797 is an anchor column (one id
    expanded)."""
    from annchor_tpu_torch.ops import sinkhorn_cuda as sc
    from annchor_tpu_torch.ops import wasserstein as w

    X, C = _k8_problem(n, 1797, n + B)
    eng = w.SinkhornExpEngine(C, device=cuda)
    Xd = eng._table(X)
    if B == 1797:
        I, J = torch.tensor(1126, device=cuda).expand(B), torch.arange(B, device=cuda)
    else:
        I, J = _k8_ids(len(X), B, B, cuda)
    n_iter = 300 if n == 64 else 20
    plan = sc.exp_plan(B, n)
    assert plan["path"] == ("streamed" if n == 300 else "resident")
    before = sc.K8.mode_launches["exp"]
    got = w.sinkhorn_exp_chunk(Xd, Xd, I, J, eng._K, eng._KC, n_iter)
    torch.cuda.synchronize()
    assert sc.K8.mode_launches["exp"] == before + sc.exp_launches(plan, n_iter)
    want = w.sinkhorn_exp_chunk_plain(Xd, Xd, I, J, eng._K, eng._KC, n_iter)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-6)
    model = sc.exp_chunk_model(Xd, Xd, I, J, eng._K, eng._KC, n_iter, w.TINY)
    assert torch.equal(got, model)


@pytest.mark.parametrize("forced", [("resident", None), ("streamed", 64), ("streamed", 32),
                                    ("streamed", 16)])
@pytest.mark.parametrize("n", [5, 64, 144])
def test_k8a_forced_tile_matches_plain(cuda, forced, n):
    """K8a on each forced plan (the resident block, or the streamed tiles
    of 64, 32 and 16 columns) at 8,191 pairs, so the last block is part
    padding (and the streamed tile's padding columns show below 64 bins):
    against its plain version and its model."""
    from annchor_tpu_torch.ops import sinkhorn_cuda as sc
    from annchor_tpu_torch.ops import wasserstein as w

    X, C = _k8_problem(n, 1797, n)
    eng = w.SinkhornExpEngine(C, device=cuda)
    Xd = eng._table(X)
    I, J = _k8_ids(len(X), 8191, 8191, cuda)
    plan = sc.exp_plan(8191, n, *forced)
    got = sc.sinkhorn_exp_cuda(Xd, Xd, I, J, eng._K, eng._KC, 20, w.TINY, _plan=plan)
    want = w.sinkhorn_exp_chunk_plain(Xd, Xd, I, J, eng._K, eng._KC, 20)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-6)
    assert torch.equal(got, sc.exp_chunk_model(Xd, Xd, I, J, eng._K, eng._KC, 20, w.TINY))


@pytest.mark.parametrize("n,B", [(145, 70), (784, 130), (2100, 4), (7200, 5)])
def test_k8a_large_n_matches_plain(cuda, n, B):
    """K8a streamed: above the resident limit, at 28 x 28 images, and at
    2,100 and 7,200 bins (K read from device memory by column tiles):
    against its plain version and its model."""
    from annchor_tpu_torch.ops import sinkhorn_cuda as sc
    from annchor_tpu_torch.ops import wasserstein as w

    X, C = _k8_problem(n, 64, n)
    eng = w.SinkhornExpEngine(C, device=cuda)
    Xd = eng._table(X)
    I, J = _k8_ids(len(X), B, B, cuda)
    plan = sc.exp_plan(B, n)
    assert plan["path"] == "streamed" and plan["npad"] % 64 == 0 and plan["Bp"] >= B
    got = w.sinkhorn_exp_chunk(Xd, Xd, I, J, eng._K, eng._KC, 2)
    want = w.sinkhorn_exp_chunk_plain(Xd, Xd, I, J, eng._K, eng._KC, 2)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-6)
    assert torch.equal(got, sc.exp_chunk_model(Xd, Xd, I, J, eng._K, eng._KC, 2, w.TINY))


def test_k8b_large_n_matches_plain(cuda):
    """K8b above 14,400 bins on 2 pairs: the streamed path, its pair tile
    shrunk to the batch so the output tiles spread over the card; against
    its plain version and its model."""
    from annchor_tpu_torch.ops import sinkhorn_cuda as sc
    from annchor_tpu_torch.ops import wasserstein as w

    n = 14_401
    X, C = _k8_problem(n, 32, n)
    plan = sc.log_plan(2, n)
    assert plan["path"] == "streamed" and plan["blocks"] >= sc.SMS
    Xu = torch.as_tensor(w.unit_mass(X), device=cuda)
    I, J = _k8_ids(len(X), 2, 3, cuda)
    A, Bh = Xu[I].contiguous(), Xu[J].contiguous()
    Cd = torch.as_tensor(C, device=cuda)
    eps = float(np.float32(0.02 * C.max()))
    before = sc.K8.mode_launches["log"]
    got = w.sinkhorn_batch(A, Bh, Cd, eps, 1)
    torch.cuda.synchronize()
    assert sc.K8.mode_launches["log"] == before + sc.log_launches(plan, 1)
    want = w.sinkhorn_batch_plain(A, Bh, Cd, eps, 1)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=K8B_RTOL)
    assert torch.equal(got, sc.log_batch_model(A, Bh, Cd, eps, 1))


def _k8b_case(n, B, seed, cuda):
    from annchor_tpu_torch.ops import wasserstein as w

    X, C = _k8_problem(n, 1797, seed)
    Xu = torch.as_tensor(w.unit_mass(X), device=cuda)
    I, J = _k8_ids(len(X), B, seed, cuda)
    return (Xu[I].contiguous(), Xu[J].contiguous(), torch.as_tensor(C, device=cuda),
            float(np.float32(0.02 * C.max())))


@pytest.mark.parametrize("B", [1, 256, 4096])
@pytest.mark.parametrize("n", [5, 64, 100, 224, 300, 784])
def test_k8b_matches_plain(cuda, n, B):
    """K8b against its plain version on the card, both float32: only the
    order of the sums differs; and against its torch model bit for bit.
    Resident to 224 bins (one launch), streamed at 300 and 784 (28 x 28
    images; 2 n_iter + 2 launches)."""
    from annchor_tpu_torch.ops import sinkhorn_cuda as sc
    from annchor_tpu_torch.ops import wasserstein as w

    A, Bh, Cd, eps = _k8b_case(n, B, n + B + 1, cuda)
    n_iter = 200 if n == 64 else 30
    plan = sc.log_plan(B, n)
    assert plan["path"] == ("streamed" if n > sc.LOG_RES_MAX_BINS else "resident")
    before = sc.K8.mode_launches["log"]
    got = w.sinkhorn_batch(A, Bh, Cd, eps, n_iter)
    torch.cuda.synchronize()
    assert sc.K8.mode_launches["log"] == before + sc.log_launches(plan, n_iter)
    want = w.sinkhorn_batch_plain(A, Bh, Cd, eps, n_iter)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=K8B_RTOL)
    del want
    assert torch.equal(got, sc.log_batch_model(A, Bh, Cd, eps, n_iter))


@pytest.mark.parametrize("path,tile", [("resident", (4, 2)), ("resident", (4, 1)),
                                       ("resident", (1, 1)), ("streamed", (4, 4)),
                                       ("streamed", (4, 2)), ("streamed", (4, 1)),
                                       ("streamed", (1, 1))])
@pytest.mark.parametrize("n", [5, 64, 101])
def test_k8b_forced_tile_matches_plain(cuda, path, tile, n):
    """K8b in each thread tile on each path, forced, at 1,001 pairs (the
    last block part padding) and at 5, 64 and 101 bins (outputs and k past
    n in the last group, step and slab): against its plain version and
    its model."""
    from annchor_tpu_torch.ops import sinkhorn_cuda as sc
    from annchor_tpu_torch.ops import wasserstein as w

    A, Bh, Cd, eps = _k8b_case(n, 1001, n, cuda)
    plan = sc.log_plan(1001, n, path, tile)
    before = sc.K8.mode_launches["log"]
    got = sc.sinkhorn_log_cuda(A, Bh, Cd, eps, 20, _plan=plan)
    torch.cuda.synchronize()
    assert sc.K8.mode_launches["log"] == before + sc.log_launches(plan, 20)
    want = w.sinkhorn_batch_plain(A, Bh, Cd, eps, 20)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=K8B_RTOL)
    assert torch.equal(got, sc.log_batch_model(A, Bh, Cd, eps, 20))


def test_k8_call_does_not_sync(cuda):
    """The hybrid's certify dispatch (two K8a launches: 8,192 + 808
    pairs), the max-min anchors' column, a streamed K8a call (300 bins)
    and a K8b call queue on the card without a host sync."""
    from annchor_tpu_torch.ops import sinkhorn_cuda as sc
    from annchor_tpu_torch.ops import wasserstein as w

    X, C = _k8_problem(64, 1797, 0)
    eng = w.SinkhornExpEngine(C, device=cuda)
    IJ = np.random.default_rng(1).integers(0, len(X), size=(9000, 2))
    want, _ = eng.dispatch(X, X, IJ)  # builds the kernel, uploads the table
    Xd = eng._table(X)
    Xu = torch.as_tensor(w.unit_mass(X[:300]), device=cuda)
    Cd = torch.as_tensor(C, device=cuda)
    log_want = w.sinkhorn_batch(Xu, Xu.flip(0).contiguous(), Cd, 0.5, 20)
    I = torch.tensor(7, device=cuda).expand(len(X))  # a blocking copy: outside the check
    J = torch.arange(len(X), device=cuda)
    col = w.sinkhorn_exp_chunk(Xd, Xd, I, J, eng._K, eng._KC, 300)
    Xr, Cr = _k8_problem(300, 64, 1)
    er = w.SinkhornExpEngine(Cr, device=cuda)
    Xrd = er._table(Xr)
    Ir, Jr = _k8_ids(len(Xr), 100, 2, cuda)
    big = w.sinkhorn_exp_chunk(Xrd, Xrd, Ir, Jr, er._K, er._KC, 3)
    torch.cuda.synchronize()
    before = dict(sc.K8.mode_launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, m = eng.dispatch(X, X, IJ)
        log_got = w.sinkhorn_batch(Xu, Xu.flip(0).contiguous(), Cd, 0.5, 20)
        col_got = w.sinkhorn_exp_chunk(Xd, Xd, I, J, eng._K, eng._KC, 300)
        big_got = w.sinkhorn_exp_chunk(Xrd, Xrd, Ir, Jr, er._K, er._KC, 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert m == 9000
    assert sc.K8.mode_launches == {"exp": before["exp"] + 3 + 10, "log": before["log"] + 1}
    assert torch.equal(got, want) and torch.equal(log_got, log_want) and torch.equal(col_got, col)
    assert torch.equal(big_got, big)


def test_lexsort_stable_on_card_matches_numpy(cuda):
    """The card's stable sort is a radix sort on the keys' bits: the
    helper still gives np.lexsort's order with -0.0 and +0.0 mixed, NaN
    of either sign, +-inf and int64 keys above 2**31 (ROADMAP H7)."""
    from annchor_tpu_torch.ops.pairs import lexsort_stable

    rng = np.random.default_rng(9)
    n = 100_000
    pool = np.array([-0.0, 0.0, -np.inf, np.inf, np.nan, np.copysign(np.nan, -1.0), 1.5])
    f = rng.choice(pool, size=n)
    g = rng.integers(-2, 3, size=n) * 0.0 + rng.integers(0, 2, size=n)
    i = rng.integers(0, 5, size=n) * (1 << 40) + rng.integers(0, 3, size=n)
    for cols in ([f], [g, f], [f, i], [g, f, i], [i, g]):
        got = lexsort_stable([torch.as_tensor(c, device=cuda) for c in cols])
        np.testing.assert_array_equal(got.cpu().numpy(), np.lexsort(cols))


@pytest.mark.parametrize("case", ["predicted", "integer", "zero_margins"])
def test_query_walk_on_card_equals_cpu(cuda, case):
    """The query walk with its state on the card against the same walk on
    the CPU (held to the JAX package's numpy walk by the CPU tests): the
    same metric calls, pair for pair, and bit-equal results; at most two
    downloads a metric call, plus two."""
    import copy

    from annchor_tpu_torch import metrics, query
    from annchor_tpu_torch.ops.locality import query_candidates

    X, _ = make_strings(n=400, length=60, seed=7)
    X = list(X)
    ann = Annchor(X[:300], "levenshtein", n_anchors=12, n_neighbors=10, n_samples=800,
                  p_work=0.3, device="cpu")
    ann.fit()
    on_card = copy.copy(ann)
    on_card.device = cuda
    Q = X[300:]
    geq = metrics.make_get_exact_query_ijs(ann.metric)
    QD = query.get_query_anchor_dists(ann, Q, geq)
    check = query_candidates(ann._S_raw, QD, ann.locality, ann.loc_thresh, device="cpu")
    IJs, P_idx, P_cnt, F, Qncm = query.get_query_features(ann, Q, QD, check)
    F, Qncm = F.cpu().numpy(), Qncm.cpu().numpy()
    QRA = ann.regression.predict(F, ann.feature_names)
    if case == "integer":
        QRA = np.round(QRA)
    elif case == "zero_margins":
        QRA = np.where(np.random.default_rng(5).random(QRA.shape[0]) < 0.5, -0.0, 0.0)
    Qerrors = ann.error_predictor.predict(F, ann.feature_names)

    class Counts:
        def count(self, **kw):
            self.__dict__.update(kw)

    outs, calls, counts = [], [], Counts()
    for index, span in ((ann, None), (on_card, counts)):
        log = []

        def run(f, Xa, Z, IJ, log=log):
            log.append(np.array(IJ))
            return geq(f, Xa, Z, IJ)

        outs.append(query.select_refine_candidate_query_pairs(
            index, IJs.copy(), Q, P_idx, P_cnt, QRA.copy(), Qncm.copy(), Qerrors, 0.3, 15,
            run, span=span))
        calls.append(log)
    for got, want in zip(outs[1], outs[0]):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert len(calls[1]) == len(calls[0]) > 1
    for got, want in zip(calls[1], calls[0]):
        np.testing.assert_array_equal(got, want)
    assert counts.syncs <= 2 * len(calls[1]) + 2


@pytest.mark.parametrize("which", ["strings", "wasserstein"])
def test_query_predict_on_card_equals_host_numpy(cuda, which):
    """The query path's tensor predict on the card against the strategies'
    numpy predict (and ``np.clip`` in metric spaces) of the same candidate features brought
    down: bit-equal estimates and equal error tags; the card's features
    equal the CPU's."""
    import copy

    from annchor_tpu_torch import query
    from annchor_tpu_torch.datasets import digit_images, grid_cost_matrix
    from annchor_tpu_torch.ops.locality import query_candidates

    if which == "strings":
        X, _ = make_strings(n=400, length=60, seed=7)
        X, Q = list(X[:300]), list(X[300:])
        ann = Annchor(X, "levenshtein", n_anchors=12, n_neighbors=10, n_samples=800,
                      p_work=0.3, device=cuda)
    else:
        X, _ = digit_images()
        X, Q = X[:400], X[400:500]
        ann = Annchor(X, "wasserstein", func_kwargs={"cost_matrix": grid_cost_matrix(),
                                                     "scout": "sinkhorn"},
                      n_anchors=12, n_neighbors=10, n_samples=1000, p_work=0.2, device=cuda)
    ann.fit()
    geq = ann._get_exact_query_ijs_for(ann.f)
    QD = query.get_query_anchor_dists(ann, Q, geq)
    check = query_candidates(ann._S_raw, QD, ann.locality, ann.loc_thresh, device=cuda)
    F = query.get_query_features(ann, Q, QD, check)[3]
    assert F.is_cuda and F.dtype == torch.float64
    on_cpu = copy.copy(ann)
    on_cpu.device = torch.device("cpu")
    F_cpu = query.get_query_features(on_cpu, Q, QD, check)[3]
    assert F.cpu().numpy().tobytes() == F_cpu.numpy().tobytes()
    pred, err, on_card = query.predict_query_pairs(ann, F)
    assert on_card and pred.is_cuda and err.is_cuda
    Fh = F.cpu().numpy()
    names = ann.feature_names
    want = ann.regression.predict(Fh, names)
    if ann.is_metric:
        want = np.clip(want, Fh[:, 0], Fh[:, 1])
    assert pred.cpu().numpy().tobytes() == want.tobytes()
    np.testing.assert_array_equal(err.cpu().numpy(), ann.error_predictor.predict(Fh, names))


def _certify_index(device, cap=None):
    """A stand-in index for ``Annchor._certify``: 2,000 points with an
    exact metric (distances in a random 6-d embedding) and a scout that
    misranks it by up to 2 %, so the expansion admits pairs."""
    from types import SimpleNamespace

    emb = np.random.default_rng(3).normal(size=(2000, 6))

    def exact(IJ):
        IJ = np.asarray(IJ)
        return np.linalg.norm(emb[IJ[:, 0]] - emb[IJ[:, 1]], axis=1)

    def scout(IJ):
        IJ = np.asarray(IJ)
        return exact(IJ) * (1 + 0.02 * np.sin(7.0 * IJ[:, 0] + IJ[:, 1]))

    return SimpleNamespace(n_neighbors=16, metric=SimpleNamespace(scout=object()),
                           _exact_pairs=exact, _eval_pairs=scout, certify_expand_cap=cap,
                           certify_expand_rounds=2, scout_evals=0, X=None, device=device)


@pytest.mark.parametrize("cap", [None, 500])
def test_certify_on_card_equals_cpu(cuda, cap):
    """The hybrid's certify with its set operations and row ranking on
    the card against the same on the CPU (held to the JAX package's
    numpy by the CPU tests): bit-equal rows, the same pairs evaluated."""
    rng = np.random.default_rng(4)
    emb = np.random.default_rng(3).normal(size=(2000, 6))
    noisy = emb + 0.3 * rng.normal(size=emb.shape)
    d2 = ((noisy[:, None, :] - noisy[None, :, :]) ** 2).sum(-1)
    ngi = np.argsort(d2, axis=1, kind="stable")[:, 1:24]
    outs, evals = [], []
    for dev in (torch.device("cpu"), cuda):
        idx = _certify_index(dev, cap)
        log = []
        exact = idx._exact_pairs
        idx._exact_pairs = lambda IJ, exact=exact, log=log: log.append(np.array(IJ)) or exact(IJ)
        outs.append(Annchor._certify(idx, ngi, np.zeros(ngi.shape)))
        evals.append(log)
    for got, want in zip(outs[1], outs[0]):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert len(evals[1]) == len(evals[0]) >= 2
    for got, want in zip(evals[1], evals[0]):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- K12 ----


def _hybrid_digits_fit(device, card_engine):
    """The digits-1797 hybrid fit (examples/wasserstein_digits.py's
    arguments) with its exact engine on the card (K12) or on the host
    solver; returns the fit and the exact pair batches it evaluated."""
    from annchor_tpu_torch.datasets import digit_images, grid_cost_matrix

    X, _ = digit_images()
    ann = Annchor(X, "wasserstein", func_kwargs={"cost_matrix": grid_cost_matrix(),
                                                 "scout": "sinkhorn"},
                  n_anchors=25, n_neighbors=25, n_samples=5000, p_work=0.16,
                  random_seed=42, device=device)
    assert ann.metric.batch.on_card
    ann.metric.batch.on_card = card_engine
    log = []
    exact = ann._exact_eval
    ann._exact_eval = lambda f, X, IJ: log.append(np.array(IJ)) or exact(f, X, IJ)
    ann.fit()
    return ann, log


@pytest.fixture(scope="module")
def hybrid_fits():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    from annchor_tpu_torch.ops.emd_cuda import K12

    before = K12.launches
    card = _hybrid_digits_fit("cuda", True)
    launches = K12.launches - before
    return card, _hybrid_digits_fit("cuda", False), launches


def test_k12_hybrid_fit_equals_host_engine(hybrid_fits):
    """The hybrid fit with K12 certifying gives the host engine's graph,
    distances, evals and scout evals, one K12 launch an exact batch."""
    (card, card_log), (host, host_log), launches = hybrid_fits
    assert launches == len(card_log) >= 2
    assert card.evals == host.evals and card.scout_evals == host.scout_evals
    for got, want in zip(card.neighbor_graph, host.neighbor_graph):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert len(card_log) == len(host_log)
    for got, want in zip(card_log, host_log):
        np.testing.assert_array_equal(got, want)


def test_k12_bit_equal_to_host_on_certify_pairs(hybrid_fits):
    """K12 against native.emd_batch on every exact pair of the fit's
    certify."""
    from annchor_tpu_torch import native
    from annchor_tpu_torch.datasets import digit_images, grid_cost_matrix

    (card, log), _, _ = hybrid_fits
    X, _ = digit_images()
    M = grid_cost_matrix()
    IJ = np.concatenate(log)
    got = card.metric.batch(X, X, IJ)
    want = native.emd_batch(X, X, M, IJ[:, 0], IJ[:, 1])
    assert got.dtype == np.float64 and got.tobytes() == want.tobytes()


def test_k12_bit_equal_to_host_on_digits_large(cuda):
    """K12 against native.emd_batch on 50,000 pairs of the digits-5620
    stand-in: 25,000 of near neighbours by pixel distance, 25,000 random."""
    from annchor_tpu_torch import native
    from annchor_tpu_torch.datasets import grid_cost_matrix, make_digits_large
    from annchor_tpu_torch.metrics import _EMDEngine

    X, _ = make_digits_large()
    M = grid_cost_matrix()
    rng = np.random.default_rng(8)
    rows = rng.choice(len(X), 5000, replace=False)
    Xd = torch.as_tensor(X, device=cuda)
    d2 = torch.cdist(Xd[torch.as_tensor(rows, device=cuda)], Xd)
    d2[torch.arange(5000, device=cuda), torch.as_tensor(rows, device=cuda)] = float("inf")
    near = torch.topk(d2, 5, largest=False).indices.cpu().numpy()
    IJ = np.concatenate([np.stack([np.repeat(rows, 5), near.ravel()], axis=1),
                         rng.integers(0, len(X), size=(25_000, 2))])
    eng = _EMDEngine(M, device=cuda)
    got = eng(X, X, IJ)
    want = native.emd_batch(X, X, M, IJ[:, 0], IJ[:, 1])
    assert got.tobytes() == want.tobytes()


def test_k12_call_does_not_sync(cuda):
    """The engine's K12 batch is one launch and queues on the card with no
    host sync: ids through pinned memory, the tables cached."""
    from annchor_tpu_torch.datasets import digit_images, grid_cost_matrix
    from annchor_tpu_torch.metrics import _EMDEngine
    from annchor_tpu_torch.ops.emd_cuda import K12

    X, _ = digit_images()
    eng = _EMDEngine(grid_cost_matrix(), device=cuda)
    IJ = np.random.default_rng(2).integers(0, len(X), size=(9000, 2))
    Q = X[::4]
    QJ = np.stack([IJ[:, 0] % len(Q), IJ[:, 1]], axis=1)
    want = eng.dispatch(X, X, IJ), eng.dispatch(Q, X, QJ)  # build, tables up
    torch.cuda.synchronize()
    before = K12.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = eng.dispatch(X, X, IJ), eng.dispatch(Q, X, QJ)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert K12.launches == before + 2
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_k12_wrapper_checks_inputs(cuda):
    from annchor_tpu_torch.datasets import grid_cost_matrix
    from annchor_tpu_torch.ops.emd_cuda import cell_order, emd_simplex_cuda

    M = grid_cost_matrix()
    X = torch.rand((10, 64), dtype=torch.float64, device=cuda)
    I = torch.zeros(4, dtype=torch.int64, device=cuda)
    C = torch.as_tensor(M, device=cuda)
    order = torch.as_tensor(cell_order(M), device=cuda)
    emd_simplex_cuda(X, X, I, I, C, order)
    bad = [
        (X.cpu(), X, I, I, C, order),  # device
        (X.float(), X.float(), I, I, C, order),  # dtype
        (X, X, I.int(), I.int(), C, order),
        (torch.rand((10, 81), dtype=torch.float64, device=cuda),) * 2 + (
            I, I, torch.as_tensor(grid_cost_matrix(9, 9), device=cuda),
            torch.zeros(81 * 81, dtype=torch.int16, device=cuda)),  # width
        (X, X[:, :32].contiguous(), I, I, C, order),  # shapes
        (X, X, I, I[:3], C, order),
        (X, X, I, I, C[:32], order),
        (X, X, I, I, C, order[:100]),
        (X.t(), X, I, I, C, order),  # contiguity
    ]
    for args in bad:
        with pytest.raises(ValueError):
            emd_simplex_cuda(*args)
