"""The edit distance of the port over more than ``MAX_ALPHABET`` distinct
symbols (K10), held against the JAX package's row DP (``_lev_batch``,
``levenshtein_pairs``) and the pure-Python oracle on the CPU, bit for
bit: the plain version (the row DP) and the kernel's CPU twin
(``sparse_myers_pairs_plain``: the bit-parallel step over the sparse Peq
table and the kernel's search), the sparse table against the dense
``build_peq``, K10's launch plan, and the Levenshtein entry points (the
fit's evals, the max-min anchors, the exact oracles and ``query``) run
through it, with ``MAX_ALPHABET`` lowered to 16 in both packages as
``tests/test_distances.py::test_myers_alphabet_fallback`` does.  Edit
distances are integers, so a fit on the row DP must equal the same fit
on the bit-parallel kernel.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import annchor_tpu as at
import annchor_tpu_torch as att
from annchor_tpu.ops import levenshtein as jlev
from annchor_tpu.ops import levenshtein_myers as jlm
from annchor_tpu_torch._backend import Kernel
from annchor_tpu_torch.datasets import make_strings
from annchor_tpu_torch.ops import levenshtein as tlev
from annchor_tpu_torch.ops import levenshtein_myers as tlm
from annchor_tpu_torch.ops import levenshtein_rowdp_cuda as k10
from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms

torch.set_num_threads(2)

LETTERS = "abcdefghijklmnopqrstuvwxyz"


def _strings(rng, n, hi, alphabet):
    return ["".join(rng.choice(list(alphabet), size=int(rng.integers(0, hi + 1))))
            for _ in range(n)]


def _alphabet(size):
    """``size`` code points from U+0100; 20,000 and more are CJK
    ideographs and 4,000 astral ones above U+FFFF."""
    if size < 20_000:
        return [chr(0x100 + i) for i in range(size)]
    return ([chr(0x4E00 + i) for i in range(size - 4000)]
            + [chr(0x20000 + i) for i in range(4000)])


# strings on both sides of a word, of a 4-word row quad and of 32 words,
# added to the cases that came with the sparse table
BOUNDARY_LENGTHS = {(20_000, 300): (31, 32, 33, 127, 128, 129),
                    (300, 130): (31, 32, 33, 127, 128, 129, 1023, 1024, 1025)}


@pytest.mark.parametrize("size,hi", [(200, 40), (1000, 90), (26, 130), (20_000, 300),
                                     (300, 130)])
def test_plain_row_dp_bit_equal_to_jax(size, hi):
    """The row DP and the kernel's twin against the JAX package, both
    argument orders and every self pair."""
    rng = np.random.default_rng(size + hi)
    alphabet = _alphabet(size)
    strs = _strings(rng, 40, hi, alphabet) + ["", "x", alphabet[0] * 2]
    strs += ["".join(rng.choice(alphabet, size=k)) for k in BOUNDARY_LENGTHS.get((size, hi), ())]
    codes, lengths = tlev.encode_strings(strs)
    enc = tlm.MyersEncoding.from_codes(codes, lengths, "cpu")
    assert isinstance(enc, tlev.RowDPEncoding) == (size > tlm.MAX_ALPHABET)
    enc = tlev.RowDPEncoding(codes, lengths, "cpu")
    n = len(strs)
    I = np.concatenate([rng.integers(0, n, 600), np.arange(n)])
    J = np.concatenate([rng.integers(0, n, 600), np.arange(n)])
    # small chunks: a chunk's rows run as long as its longest pattern
    got = tlev.lev_pairs_plain(enc, torch.as_tensor(I), torch.as_tensor(J), chunk=64).numpy()
    want = jlev.levenshtein_pairs(codes, lengths, I, J, block_size=128)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    swapped = tlev.lev_pairs_plain(enc, torch.as_tensor(J), torch.as_tensor(I),
                                   chunk=64).numpy()
    np.testing.assert_array_equal(swapped, got)
    for a, b in ((I, J), (J, I.astype(np.int32))):
        twin = tlev.sparse_myers_pairs_plain(enc, torch.as_tensor(a), torch.as_tensor(b))
        assert twin.dtype == torch.int32
        np.testing.assert_array_equal(twin.numpy(), want)
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


def test_k10_launch_plan_and_work_counts():
    """K10's launch plan (K1's modes and overflow lists, K10's crossover
    and shared-memory rule) and the work counts of its bound."""
    plan = k10.launch_plan
    lanes = k10.GROUP_LANES_MAX
    # strings-1600 over 256 symbols: an anchor column in group mode, its
    # tables too large for shared memory; the refine batch in thread mode
    assert plan(1600, 17, 18, 4935) == (k10.k1.Plan("group", 200, g=16, wpl=2),)
    assert plan(lanes // 16 + 1, 17, 18, 4935)[0].mode == "thread"
    assert plan(lanes // 16, 17, 18, 4935)[0].mode == "group"
    assert plan(58_707, 17, 18, 4935, "group")[0].mode == "group"
    # short strings: 16 groups of 8 lanes hold 310-word tables in 19,840 B
    assert plan(4000, 3, 3, 310) == (k10.k1.Plan("group", 250, g=8, wpl=1, smem=True),)
    assert not plan(4000, 3, 3, 769)[0].smem  # 49,216 B > 48 KB
    # long strings past the bulk: the overflow lists, thread then long mode
    assert [(p.mode, p.wb, p.listed) for p in plan(7000, 19, 157, 5000, "thread")] == [
        ("thread", 20, False), ("thread", 64, True), ("long", 0, True)]
    assert [p.mode for p in plan(7000, 19, 157, 5000)] == ["group", "thread", "long"]
    assert [p.mode for p in plan(4000, 66, 66, 9000, "group")] == ["long"]
    with pytest.raises(ValueError, match="mode"):
        plan(10, 1, 1, 1, "long")

    strs = ["abc", "aaaa", "", "abcd" * 10]
    enc = tlev.RowDPEncoding(*tlev.encode_strings(strs), "cpu")
    I, J = torch.tensor([0, 1, 1, 2, 3]), torch.tensor([1, 0, 1, 0, 3])
    # (abc, aaaa) either way: pattern abc, 3 symbols, 2 + 1 probes a
    # character of aaaa; self pairs and the empty pattern none
    assert k10.search_probes(enc, I, J) == 24
    assert k10.word_steps(enc.lengths, I, J) == 4 + 4
    assert k10.cells(enc.lengths, I, J) == 12 + 12


def test_sparse_table_equals_dense_peq(small_alphabet):
    """On 20 letters with the limit at 16 (the row DP's encoding): for
    every string and every symbol the row that the kernel's search finds
    holds the JAX package's dense ``build_peq`` row, its padding to 4
    words is zero, and a symbol the string lacks, or no string has, finds
    no row (the zero row).  The offsets are 4-word aligned, and
    ``RowDPEncoding.to`` carries every table."""
    rng = np.random.default_rng(11)
    strs = _strings(rng, 50, 300, LETTERS[:20]) + ["", "z", "y" * 129, "a" * 32 + "b"]
    codes, lengths = tlev.encode_strings(strs)
    enc = tlm.MyersEncoding.from_codes(codes, lengths, "cpu")
    assert isinstance(enc, tlev.RowDPEncoding)
    uniq = np.unique(codes[codes >= 0])
    ids = np.where(codes < 0, -1, np.searchsorted(uniq, codes)).astype(np.int32)
    peq = jlm.build_peq(ids, lengths, len(uniq))
    words = (lengths.astype(np.int64) + 31) // 32
    wp = (words + 3) // 4 * 4
    soff, moff = enc.soff.numpy(), enc.moff.numpy()
    nsym = np.diff(soff)
    np.testing.assert_array_equal(np.diff(moff), nsym * wp)
    assert (moff % 4 == 0).all() and moff[-1] == enc.mask.shape[0]
    # 99 % of 54 strings is all of them
    assert (enc.wbulk, enc.wmax, enc.lmax) == (words.max(), words.max(), lengths.max())
    probe = np.concatenate([uniq, [ord("A"), 0x1F600, -5]])
    S = torch.arange(len(strs)).repeat_interleave(len(probe))
    C = torch.as_tensor(np.tile(probe, len(strs)))
    rows = tlev.find_rows(F.pad(enc.sym.long(), (0, 1)), enc.soff[S],
                          enc.soff[S + 1] - enc.soff[S], C).numpy()
    mask = enc.mask.numpy().view(np.uint32)
    for k, (s, c) in enumerate(zip(S.tolist(), C.tolist())):
        sym = enc.sym[soff[s]:soff[s + 1]].tolist()
        assert sym == sorted(set(codes[s, : lengths[s]].tolist()))
        dense = (peq[s, np.searchsorted(uniq, c), : words[s]] if c in uniq
                 else np.zeros(words[s], np.uint32))
        assert (rows[k] >= 0) == (c in sym)
        row = (mask[moff[s] + rows[k] * wp[s]: moff[s] + (rows[k] + 1) * wp[s]]
               if rows[k] >= 0 else np.zeros(wp[s], np.uint32))
        np.testing.assert_array_equal(row[: words[s]], dense)
        assert not row[words[s]:].any()
    moved = enc.to("meta")
    for name in tlev.RowDPEncoding.__slots__:
        v = getattr(enc, name)
        if isinstance(v, torch.Tensor):
            assert getattr(moved, name).device.type == "meta"
            assert getattr(moved, name).shape == v.shape
        else:
            assert getattr(moved, name) == v


def test_build_key_covers_included_headers(tmp_path):
    """A kernel's cache key hashes its source, every header the source
    includes by a quoted name (nested too) and the flags: an edited
    header builds anew.  K1 and K10 share ``csrc/myers_step.cuh``."""
    src, head, nested = (tmp_path / f for f in ("k.cu", "step.cuh", "inner.cuh"))
    src.write_text('#include <cstdint>\n#include "step.cuh"\nint f() { return 1; }\n')
    head.write_text('#include "inner.cuh"\n// v1\n')
    nested.write_text("// a\n")
    kern = Kernel("k", "k.cu", {})
    kern.source = str(src)
    assert kern.sources() == [str(src), str(head), str(nested)]
    key = kern.library_path()
    head.write_text('#include "inner.cuh"\n// v2\n')
    assert kern.library_path() != key
    head.write_text('#include "inner.cuh"\n// v1\n')
    assert kern.library_path() == key
    nested.write_text("// b\n")
    assert kern.library_path() != key
    from annchor_tpu_torch.ops.levenshtein_cuda import K1

    for kernel in (K1, k10.K10):
        assert [os.path.basename(p) for p in kernel.sources()][1:] == ["myers_step.cuh"]


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
