"""The port's edit-distance path held against the JAX package.

The plain PyTorch version of the pair kernel (``myers_pairs_plain``,
what every CPU tensor runs) must be bit-equal, int32 for int32, to the
JAX Pallas kernel in interpret mode, to the JAX XLA Myers kernel and to
the pure-Python DP oracle.  The CUDA kernel itself is held against the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from annchor_tpu.ops import levenshtein_myers as jax_myers
from annchor_tpu.ops.levenshtein import encode_sequences as jax_encode_sequences
from annchor_tpu.ops.levenshtein import encode_strings as jax_encode
from annchor_tpu.ops.levenshtein_pallas import pallas_myers_pairs
from annchor_tpu_torch.metrics import get_function_from_input
from annchor_tpu_torch.ops.levenshtein import (
    RowDPEncoding,
    encode_sequences,
    encode_strings,
    levenshtein_scalar,
)
from annchor_tpu_torch.ops.levenshtein_myers import (
    MyersEncoding,
    myers_maxmin,
    myers_pairs,
    myers_pairs_plain,
)

torch.set_num_threads(2)

ALPHABET = "abcdefghijklmnopqrstuvwxyz"


def _strings(rng, n, max_len, k, min_len=0):
    """n random strings over the first k letters, with the word-boundary
    cases: "", "a"*33 and lengths 31, 32, 33, 64 and 65."""
    chars = list(ALPHABET[:k])
    out = [
        "".join(rng.choice(chars, size=int(rng.integers(min_len, max_len + 1))))
        for _ in range(n)
    ]
    out[0] = ""
    out[1] = "a" * 33
    for slot, length in enumerate((31, 32, 33, 64, 65), start=2):
        out[slot] = "".join(rng.choice(chars, size=length))
    return out


def _encodings(strs):
    """(JAX MyersEncoding, port MyersEncoding on the CPU) of one set."""
    codes, lengths = jax_encode(strs)
    jenc = jax_myers.MyersEncoding.from_codes(codes, lengths)
    tenc = MyersEncoding(jenc.ids, jenc.lengths, jenc.peq, jenc.alphabet, "cpu")
    return jenc, tenc


def _plain(tenc, I, J):
    return myers_pairs_plain(tenc, torch.as_tensor(I), torch.as_tensor(J)).numpy()


@pytest.mark.parametrize("k", [2, 4, 13, 26])
def test_plain_matches_pallas_xla_and_oracle(k):
    rng = np.random.default_rng(100 + k)
    strs = _strings(rng, 36, 90, k)
    jenc, tenc = _encodings(strs)
    I = rng.integers(0, len(strs), size=256)
    J = rng.integers(0, len(strs), size=256)
    I[:8] = np.arange(8)  # every edge-case string against something
    got = _plain(tenc, I, J)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, pallas_myers_pairs(jenc, I, J, block_size=1024))
    np.testing.assert_array_equal(got, jax_myers.myers_pairs(jenc, I, J))
    want = [levenshtein_scalar(strs[i], strs[j]) for i, j in zip(I[:64], J[:64])]
    np.testing.assert_array_equal(got[:64], want)


def test_plain_wide_patterns_match_xla():
    """Patterns of more than 64 words (the CUDA kernel's scratch-state
    path) against the XLA Myers kernel."""
    rng = np.random.default_rng(7)
    strs = _strings(rng, 10, 2300, 4, min_len=2100)
    jenc, tenc = _encodings(strs)
    assert jenc.W > 64
    I = np.array([7, 8, 7, 9, 1, 6, 0])
    J = np.array([8, 9, 9, 7, 8, 9, 7])
    np.testing.assert_array_equal(
        _plain(tenc, I, J), jax_myers.myers_pairs(jenc, I, J, block_size=8)
    )


def test_encoding_matches_jax():
    rng = np.random.default_rng(3)
    strs = _strings(rng, 30, 70, 6)
    jenc, _ = _encodings(strs)
    enc = MyersEncoding.from_codes(*encode_strings(strs), "cpu")
    np.testing.assert_array_equal(enc.ids.numpy(), jenc.ids)
    np.testing.assert_array_equal(enc.lengths.numpy(), jenc.lengths)
    np.testing.assert_array_equal(enc.peq.numpy().view(np.uint32), jenc.peq)
    assert enc.alphabet == jenc.alphabet


def _symbols(k):
    """k distinct code points, BMP and astral."""
    return [chr(0x4E00 + i) for i in range(k // 2)] + [chr(0x20000 + i)
                                                      for i in range(k - k // 2)]


def _over(symbols, lengths, seed):
    rng = np.random.default_rng(seed)
    return ["".join(symbols[i] for i in rng.integers(0, len(symbols), k)) for k in lengths]


_ENCODE_CASES = {
    "empty_string": ["", "ab", "ba"],
    "only_empty": ["", "", ""],
    "word_lengths": _over("acgt", [31, 32, 33, 127, 128, 129], 1),
    "astral": _over(["a", "\u00e9", "\U0001F600", "\U00010000", "\U0010FFFF"],
                    [0, 5, 40, 200], 2),
    "nul": ["a\x00b", "ab\x00", "\x00", "\x00\x00a\x00"],
    "numpy_unicode": np.array(["abc", "a\x00b\x00", "\U0001F600x", ""]),
    "list_of_str": ["abc", "a\x00b\x00", "\U0001F600x", ""],
    "list_of_np_str": list(np.array(["abc", "a\x00b", "\U0001F600x", ""])),
    "sequences": [[1, 2, 3], [3, 2, 1, 1], [], [7] * 40],
    "symbols_192": _over(_symbols(192), [300] * 8, 3) + ["".join(_symbols(192))],
    "symbols_193": _over(_symbols(193), [300] * 8, 4) + ["".join(_symbols(193))],
    "past_2_22": [[(1 << 22) + 5, 3, 1 << 30], [1 << 30, 3], [3]],
}


@pytest.mark.parametrize("case", sorted(_ENCODE_CASES))
def test_device_build_matches_host_and_jax(case):
    """``MyersEncoding.on_device`` (what a card runs) on CPU tensors gives
    the host build's tables and sizes bit for bit, and the JAX package's
    ids, lengths, Peq, alphabet and W; past 192 symbols both give the row
    DP's encoding of the same code points (the JAX encoder gives None)."""
    X = _ENCODE_CASES[case]
    seq = list(X)
    strings = isinstance(seq[0], str)
    codes, lengths = (encode_strings if strings else encode_sequences)(seq)
    host = MyersEncoding.from_codes(codes, lengths, "cpu")
    got = MyersEncoding.on_device(X, "cpu")
    assert type(got) is type(host)
    for slot in type(host).__slots__:
        a, b = getattr(got, slot), getattr(host, slot)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), slot
        else:
            assert a == b, slot
    jenc = jax_myers.MyersEncoding.from_codes(
        *(jax_encode if strings else jax_encode_sequences)(seq))
    if isinstance(got, RowDPEncoding):
        assert jenc is None and case == "symbols_193"
        np.testing.assert_array_equal(got.ids.numpy(), codes)
        return
    assert got.alphabet == jenc.alphabet
    assert case != "symbols_192" or got.alphabet == 192
    assert got.W == jenc.W
    np.testing.assert_array_equal(got.ids.numpy(), jenc.ids)
    np.testing.assert_array_equal(got.lengths.numpy(), jenc.lengths)
    np.testing.assert_array_equal(got.peq.numpy().view(np.uint32), jenc.peq)


def test_alphabet_limit_raises():
    """Past MAX_ALPHABET symbols no Peq table is built: the encoding is
    the row DP's (K10), which keeps the codepoints."""
    from annchor_tpu_torch.ops.levenshtein import RowDPEncoding

    codes = np.arange(400, dtype=np.int32).reshape(2, 200)
    enc = MyersEncoding.from_codes(codes, np.array([200, 200], np.int32), "cpu")
    assert isinstance(enc, RowDPEncoding) and enc.lmax == 200
    np.testing.assert_array_equal(enc.ids.numpy(), codes)


def test_myers_pairs_dispatch():
    """CPU tensors run the plain version; pair ids on another device
    than the encoding are refused."""
    rng = np.random.default_rng(5)
    strs = _strings(rng, 12, 40, 3)
    _, tenc = _encodings(strs)
    I = torch.as_tensor(rng.integers(0, 12, size=20))
    J = torch.as_tensor(rng.integers(0, 12, size=20))
    np.testing.assert_array_equal(
        myers_pairs(tenc, I, J).numpy(), myers_pairs_plain(tenc, I, J).numpy()
    )
    with pytest.raises(ValueError):
        myers_pairs(tenc, I.to("meta"), J)


def test_cuda_wrapper_refuses_cpu_tensors():
    from annchor_tpu_torch.ops.levenshtein_cuda import K1, myers_pairs_cuda

    _, tenc = _encodings(["ab", "abc"])
    before = K1.launches
    with pytest.raises(ValueError, match="CUDA"):
        myers_pairs_cuda(
            tenc.peq, tenc.ids, tenc.lengths, torch.zeros(1, dtype=torch.int64),
            torch.ones(1, dtype=torch.int64),
        )
    assert K1.launches == before


@pytest.mark.parametrize("seed,first", [(1, 0), (3, 50)])
def test_myers_maxmin_matches_jax(seed, first):
    """Anchors and anchor columns bit-equal to the JAX fused loop,
    including the repeat that the reference's D[1:] quirk produces."""
    from annchor_tpu_torch.datasets import make_strings

    na = 8
    X, _ = make_strings(n=120, length=30, seed=seed)
    jenc, tenc = _encodings(list(X))
    A_j, D_j = jax_myers.myers_maxmin(jenc, na, first)
    A_t, D_t = myers_maxmin(tenc, na, first)
    np.testing.assert_array_equal(A_t, A_j)
    np.testing.assert_array_equal(D_t, D_j)
    assert len(set(A_t.tolist())) < na  # the quirk's repeated anchor


def test_engine_matches_jax_engine():
    """In-sample and query (X + Z encoding) evaluation through the
    metric engine, against the JAX engine."""
    from annchor_tpu.metrics import get_function_from_input as jax_metric

    rng = np.random.default_rng(9)
    X = _strings(rng, 20, 50, 4)
    Z = _strings(rng, 8, 50, 5)
    IJ = rng.integers(0, 6, size=(40, 2))
    mt = get_function_from_input("levenshtein", device="cpu")
    mj = jax_metric("levenshtein")
    np.testing.assert_array_equal(mt.batch(X, X, IJ), mj.batch(X, X, IJ))
    np.testing.assert_array_equal(mt.batch(X, Z, IJ), mj.batch(X, Z, IJ))
    assert mt("kitten", "sitting") == 3.0


def test_unported_metrics_name_their_queue_item():
    """Every built-in metric resolves now: the optimal-transport ones ask
    for their cost matrix, as the JAX package's do."""
    with pytest.raises(AssertionError, match="cost_matrix"):
        get_function_from_input("wasserstein", device="cpu")
    with pytest.raises(AssertionError, match="cost_matrix"):
        get_function_from_input("wasserstein_sinkhorn", device="cpu")
    assert get_function_from_input(
        "wasserstein", {"cost_matrix": np.eye(3)}, device="cpu").name == "wasserstein"
    assert get_function_from_input("euclidean", device="cpu").name == "euclidean"
    assert get_function_from_input(lambda x, y: 0.0, device="cpu").batch is None
    with pytest.raises(AssertionError):
        get_function_from_input("hamming", device="cpu")


def test_port_imports_no_jax():
    code = (
        "import sys, annchor_tpu_torch, annchor_tpu_torch.datasets, "
        "annchor_tpu_torch.convert, annchor_tpu_torch.ops.levenshtein_cuda, "
        "annchor_tpu_torch.distances, annchor_tpu_torch.ops.pairs, "
        "annchor_tpu_torch.ops.bounds_update, annchor_tpu_torch.ops.features, "
        "annchor_tpu_torch.exact, annchor_tpu_torch.graph_sp, annchor_tpu_torch.native, "
        "annchor_tpu_torch.ops.wasserstein\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'annchor_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
