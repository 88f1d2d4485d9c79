"""The row-DP edit distance of the port (K10), which serves strings over
more than ``MAX_ALPHABET`` distinct symbols, held against the JAX
package's row DP (``_lev_batch``, ``levenshtein_pairs``) and the
pure-Python oracle on the CPU, bit for bit; and the Levenshtein entry
points (the fit's evals, the max-min anchors, the exact oracles and
``query``) run through it, with ``MAX_ALPHABET`` lowered to 16 in both
packages as ``tests/test_distances.py::test_myers_alphabet_fallback``
does.  Edit distances are integers, so a fit on the row DP must equal
the same fit on the bit-parallel kernel.
"""

import numpy as np
import pytest
import torch

import annchor_tpu as at
import annchor_tpu_torch as att
from annchor_tpu.ops import levenshtein as jlev
from annchor_tpu.ops import levenshtein_myers as jlm
from annchor_tpu_torch.datasets import make_strings
from annchor_tpu_torch.ops import levenshtein as tlev
from annchor_tpu_torch.ops import levenshtein_myers as tlm
from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms

torch.set_num_threads(2)

LETTERS = "abcdefghijklmnopqrstuvwxyz"


def _strings(rng, n, hi, alphabet):
    return ["".join(rng.choice(list(alphabet), size=int(rng.integers(0, hi + 1))))
            for _ in range(n)]


@pytest.mark.parametrize("size,hi", [(200, 40), (1000, 90), (26, 130)])
def test_plain_row_dp_bit_equal_to_jax(size, hi):
    rng = np.random.default_rng(size + hi)
    alphabet = [chr(0x100 + i) for i in range(size)]
    strs = _strings(rng, 40, hi, alphabet) + ["", "x", alphabet[0] * 2]
    codes, lengths = tlev.encode_strings(strs)
    enc = tlm.MyersEncoding.from_codes(codes, lengths, "cpu")
    assert isinstance(enc, tlev.RowDPEncoding) == (size > tlm.MAX_ALPHABET)
    enc = tlev.RowDPEncoding(codes, lengths, "cpu")
    n = len(strs)
    I = rng.integers(0, n, 600)
    J = rng.integers(0, n, 600)
    got = tlev.lev_pairs_plain(enc, torch.as_tensor(I), torch.as_tensor(J)).numpy()
    want = jlev.levenshtein_pairs(codes, lengths, I, J, block_size=128)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    swapped = tlev.lev_pairs_plain(enc, torch.as_tensor(J), torch.as_tensor(I)).numpy()
    np.testing.assert_array_equal(swapped, got)
    oracle = [tlev.levenshtein_scalar(strs[i], strs[j]) for i, j in zip(I[:80], J[:80])]
    np.testing.assert_array_equal(got[:80], oracle)


def test_lev_batch_kernel_swapped_args():
    """Port of tests/test_distances.py::test_lev_batch_kernel_swapped_args:
    d(a, b) == d(b, a), against the JAX package's ``_lev_batch``."""
    strs = ["kitten", "sitting", "flaw", "lawn", "", "a"]
    codes, lengths = tlev.encode_strings(strs)
    enc = tlev.RowDPEncoding(codes, lengths, "cpu")
    I, J = torch.tensor([0, 2, 4, 5, 0]), torch.tensor([1, 3, 1, 4, 0])
    d1 = tlev.lev_pairs_plain(enc, I, J).numpy()
    d2 = tlev.lev_pairs_plain(enc, J, I).numpy()
    np.testing.assert_array_equal(d1, [3, 2, 7, 1, 0])
    np.testing.assert_array_equal(d1, d2)
    jd = np.asarray(jlev._lev_batch(codes[[0, 2]], codes[[1, 3]], lengths[[0, 2]],
                                    lengths[[1, 3]]))
    np.testing.assert_array_equal(d1[:2], jd)


def test_rowdp_dispatch():
    """CPU tensors run the plain version; ids on another device than the
    encoding are refused; the Myers entry point takes a RowDPEncoding."""
    strs = [chr(0x100 + i) * (i % 5) + chr(0x300 + i) for i in range(200)]
    enc = tlm.MyersEncoding.from_codes(*tlev.encode_strings(strs), "cpu")
    assert isinstance(enc, tlev.RowDPEncoding) and enc.n == 200 and enc.lmax == 5
    I, J = torch.arange(200), torch.arange(199, -1, -1)
    np.testing.assert_array_equal(tlm.myers_pairs(enc, I, J).numpy(),
                                  tlev.lev_pairs_plain(enc, I, J).numpy())
    with pytest.raises(ValueError, match="encoding on"):
        tlev.rowdp_pairs(enc, I.to("meta"), J)


@pytest.fixture
def small_alphabet(monkeypatch):
    """MAX_ALPHABET lowered to 16 in both packages, so 26 letters take the
    row DP."""
    monkeypatch.setattr(jlm, "MAX_ALPHABET", 16)
    monkeypatch.setattr(tlm, "MAX_ALPHABET", 16)


def test_fit_on_row_dp_equals_jax_and_myers(small_alphabet, monkeypatch):
    """A small fit over 26 symbols with the limit at 16: the port (row DP
    on every entry) spends the JAX package's evals and finds its graph;
    the same fit with the limit restored (the bit-parallel kernel) is
    identical, distances being the same integers."""
    X, _ = make_strings(n=300, n_clusters=6, length=40, mutation_rate=0.1,
                        alphabet=LETTERS, seed=2)
    X = list(X)
    kw = dict(n_anchors=10, n_neighbors=10, n_samples=600, p_work=0.2, random_seed=42)
    ref = at.Annchor(X, "levenshtein", **kw)
    ref.fit()
    assert ref.metric.batch._encode(X)[2] is None  # the JAX package's row DP
    port = att.Annchor(X, "levenshtein", device="cpu", uniforms=jax_threefry_uniforms, **kw)
    port.fit()
    assert isinstance(port.metric.batch._encode(X), tlev.RowDPEncoding)
    assert port.evals == ref.evals
    np.testing.assert_array_equal(port.A, ref.A)
    np.testing.assert_array_equal(port.neighbor_graph[0], ref.neighbor_graph[0])
    np.testing.assert_array_equal(port.neighbor_graph[1], ref.neighbor_graph[1])

    Q = [s[:-3] + "zzz" for s in X[:20]]
    got = port.query(Q, nn=5, p_work=0.3)
    monkeypatch.setattr(tlm, "MAX_ALPHABET", 192)
    myers = att.Annchor(X, "levenshtein", device="cpu", uniforms=jax_threefry_uniforms, **kw)
    myers.fit()
    assert isinstance(myers.metric.batch._encode(X), tlm.MyersEncoding)
    assert myers.evals == port.evals
    np.testing.assert_array_equal(myers.neighbor_graph[0], port.neighbor_graph[0])
    want = myers.query(Q, nn=5, p_work=0.3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_exact_oracles_on_row_dp(small_alphabet, monkeypatch):
    """exact_knn, exact_rows and exact_query_rows over 26 symbols with the
    limit at 16 run the row DP: distances equal the JAX package's (its
    host branch), and indices and distances equal the port's own
    bit-parallel oracles (ties by the lower column in both)."""
    rng = np.random.default_rng(8)
    X = _strings(rng, 120, 30, LETTERS)
    Q = _strings(rng, 7, 30, LETTERS)
    rows = np.array([0, 5, 77, 119])
    got = (att.exact_knn(X, "levenshtein", k=9, device="cpu"),
           att.exact_rows(X, "levenshtein", rows=rows, device="cpu"),
           att.exact_query_rows(X, Q, "levenshtein", device="cpu"))
    jk = at.exact_knn(X, "levenshtein", k=9)
    np.testing.assert_array_equal(got[0][1], jk[1])
    np.testing.assert_array_equal(got[1], at.exact_rows(X, "levenshtein", rows=rows))
    np.testing.assert_array_equal(got[2], at.exact_query_rows(X, Q, "levenshtein"))
    monkeypatch.setattr(tlm, "MAX_ALPHABET", 192)
    want = (att.exact_knn(X, "levenshtein", k=9, device="cpu"),
            att.exact_rows(X, "levenshtein", rows=rows, device="cpu"),
            att.exact_query_rows(X, Q, "levenshtein", device="cpu"))
    np.testing.assert_array_equal(got[0][0], want[0][0])
    np.testing.assert_array_equal(got[0][1], want[0][1])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
