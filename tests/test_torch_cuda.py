"""The hand-written CUDA kernel on the card, held against its plain
PyTorch version.  Every test here needs an NVIDIA card (marker ``gpu``)
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
