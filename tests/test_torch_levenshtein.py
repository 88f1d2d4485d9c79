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
from annchor_tpu.ops.levenshtein import encode_strings as jax_encode
from annchor_tpu.ops.levenshtein_pallas import pallas_myers_pairs
from annchor_tpu_torch.metrics import get_function_from_input
from annchor_tpu_torch.ops.levenshtein import encode_strings, levenshtein_scalar
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


def test_alphabet_limit_raises():
    codes = np.arange(400, dtype=np.int32).reshape(2, 200)
    with pytest.raises(NotImplementedError, match="K10"):
        MyersEncoding.from_codes(codes, np.array([200, 200], np.int32), "cpu")


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
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        get_function_from_input("euclidean", device="cpu")
    with pytest.raises(NotImplementedError, match="K8"):
        get_function_from_input("wasserstein_sinkhorn", device="cpu")
    with pytest.raises(NotImplementedError):
        get_function_from_input(lambda x, y: 0.0, device="cpu")
    with pytest.raises(AssertionError):
        get_function_from_input("hamming", device="cpu")


def test_port_imports_no_jax():
    code = (
        "import sys, annchor_tpu_torch, annchor_tpu_torch.datasets, "
        "annchor_tpu_torch.convert, annchor_tpu_torch.ops.levenshtein_cuda\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'annchor_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
