"""K1's launch plan and the arithmetic of its group mode, on the CPU.

The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  What surrounds it is plain Python and is held here: the
launch plan's first launch covers every pair with a layout that holds
the bulk's patterns, and its overflow launches run each longer pair
exactly once; the encoding records the word counts the plan reads; the
cross-lane carry of group mode, (G + (G | P)) ^ P over the warp's
ballots, equals the plain version's Kogge-Stone add in every group; a
numpy model of a whole group-mode run (ballot carries, lane-to-lane
shifts, the popcount score at the end) equals the plain version; and
``word_steps``, the work unit of K1's bound, equals a loop.
"""

import itertools

import numpy as np
import pytest
import torch

from annchor_tpu_torch.ops.levenshtein import encode_strings, levenshtein_scalar
from annchor_tpu_torch.ops.levenshtein_cuda import (
    GROUP_LANES_MAX,
    GROUP_SIZES,
    LIST_BLOCKS,
    LONG_BLOCKS,
    SMEM_WORDS,
    THREAD_BUCKETS,
    THREADS,
    group_layout,
    launch_plan,
    word_steps,
)
from annchor_tpu_torch.ops.levenshtein_myers import (
    MyersEncoding,
    _add_with_carry,
    myers_pairs_plain,
)

MASK = 0xFFFFFFFF
BATCHES = (1, 1_600, 5_000, 58_707, 1_279_200)


def _ballot_add(x, y, group=None):
    """x + y over the last axis of little-endian uint32 words, one word
    per lane of a warp of at most 32 lanes cut into groups of ``group``
    lanes (default: one group), each group's words one number, carried
    the way group mode carries: each lane's generate bit (its sum carries
    out) and propagate bit (its sum is all ones), with each group's top
    lane reporting neither, packed into G and P, and lane i's carry in is
    bit i of (G + (G | P)) ^ P.  numpy in and out."""
    x = np.asarray(x, dtype=np.uint64)
    y = np.asarray(y, dtype=np.uint64)
    W = x.shape[-1]
    group = W if group is None else group
    assert W <= 32 and W % group == 0, "a warp holds at most 32 lanes, in whole groups"
    lane = np.arange(W, dtype=np.uint64)
    reports = (lane % np.uint64(group)) != np.uint64(group - 1)
    s = x + y
    bit = np.uint64(1) << lane
    g = ((s >> np.uint64(32)) & np.uint64(1)).astype(bool) & reports
    s &= np.uint64(0xFFFFFFFF)
    p = (s == np.uint64(0xFFFFFFFF)) & reports
    Gb = (g * bit).sum(-1, dtype=np.uint64)
    Pb = (p * bit).sum(-1, dtype=np.uint64)
    carry = (Gb + (Gb | Pb)) ^ Pb
    cin = (carry[..., None] >> lane) & np.uint64(1)
    return (s + cin) & np.uint64(0xFFFFFFFF)


def _pairs_covered(plan, B):
    """How many times the kernel's index mapping visits each pair, or
    None where emulating it would take too much memory."""
    lanes = plan.grid * THREADS
    if plan.mode == "long":
        slots = lanes
        rounds = -(-B // slots)
        k = (np.arange(slots)[:, None] + slots * np.arange(rounds)[None, :]).ravel()
        return np.bincount(k[k < B], minlength=B)
    if lanes > 1 << 22:
        return None
    per = plan.g if plan.mode == "group" else 1
    k = np.arange(lanes) // per
    return np.bincount(k[k < B], minlength=B) // per


def _first_launch_ok(plan, B, wbulk, alphabet):
    """The first launch holds the bulk's patterns and covers every pair."""
    assert not plan.listed
    if plan.mode == "thread":
        assert plan.wb in THREAD_BUCKETS and wbulk <= plan.wb < wbulk + 16
        assert (plan.grid - 1) * THREADS < B <= plan.grid * THREADS
    elif plan.mode == "group":
        assert (plan.g, plan.wpl) == group_layout(wbulk)
        assert plan.g in GROUP_SIZES and plan.wpl in (1, 2)
        assert plan.g * plan.wpl >= wbulk
        assert plan.smem == (alphabet * plan.wpl <= SMEM_WORDS)
        # the last block holds at least one live group
        assert (plan.grid - 1) * THREADS < B * plan.g <= plan.grid * THREADS
    else:
        assert wbulk > 64 and plan.grid <= LONG_BLOCKS
    covered = _pairs_covered(plan, B)
    if covered is not None:
        assert (covered == 1).all()


@pytest.mark.parametrize("mode", ["auto", "thread", "group"])
@pytest.mark.parametrize("B", BATCHES)
def test_launch_plan_covers_every_pair(B, mode):
    for wmax, alphabet in itertools.product(range(1, 71), (4, 192)):
        for wbulk in sorted({wmax, max(1, wmax // 3)}):
            plans = launch_plan(B, wbulk, wmax, alphabet, mode)
            assert all(0 < p.grid < 2**31 for p in plans)
            first = plans[0]
            if wbulk > 64:
                assert [p.mode for p in plans] == ["long"]
            elif mode != "auto":
                assert first.mode == mode
            else:  # group mode exactly while B x G lanes are few
                assert (first.mode == "group") == (
                    B * group_layout(wbulk)[0] <= GROUP_LANES_MAX)
            _first_launch_ok(first, B, wbulk, alphabet)
            # each later launch runs the list of the one before, holds
            # longer patterns, and the last holds the longest string
            for p in plans[1:]:
                assert p.listed and p.mode in ("thread", "long")
                assert p.grid == min(-(-B // THREADS), LIST_BLOCKS)
                if p.mode == "thread":
                    assert p.wb == next(b for b in THREAD_BUCKETS if b >= min(wmax, 64))
            words = [p.words for p in plans]
            assert words == sorted(set(words)) and words[-1] >= wmax
            assert len(plans) == 1 or words[0] < wmax


def _route(plans, words):
    """How many launches of ``plans`` compute each pair whose pattern
    has ``words`` words, emulating the overflow lists: the first launch
    sees every pair, each later one its predecessor's list."""
    done = np.zeros(words.shape[0], dtype=np.int64)
    todo = np.arange(words.shape[0])
    for p in plans:
        fits = words[todo] <= p.words
        done[todo[fits]] += 1
        todo = todo[~fits]
    return done, todo


@pytest.mark.parametrize("wbulk,wmax", [(17, 18), (17, 66), (5, 40), (14, 64), (33, 90),
                                        (70, 80)])
@pytest.mark.parametrize("mode", ["auto", "thread", "group"])
def test_overflow_lists_run_each_pair_once(mode, wbulk, wmax):
    rng = np.random.default_rng(wbulk * 100 + wmax)
    words = rng.integers(0, wbulk + 1, size=5_000)
    words[:500] = rng.integers(wbulk, wmax + 1, size=500)  # two long strings
    words[:2] = (wmax, 0)  # the longest pattern and a self pair
    for B in (1, 1_600, 5_000):
        plans = launch_plan(B, wbulk, wmax, 4, mode)
        done, left = _route(plans, words[:B])
        assert (done == 1).all() and left.size == 0


def test_launch_plan_refuses_unknown_mode():
    with pytest.raises(ValueError):
        launch_plan(10, 3, 3, 4, "warp")


def _carry_cases(rng, kind):
    """Word pairs of a whole warp (32 lanes)."""
    n = 2_000
    x = rng.integers(0, MASK + 1, size=(n, 32), dtype=np.uint64)
    y = rng.integers(0, MASK + 1, size=(n, 32), dtype=np.uint64)
    if kind == "ones_chains":
        # propagate words (x + y == MASK), generate words and kills at
        # random places, so carries ripple across many words
        kind_of = rng.integers(0, 4, size=(n, 32))
        y = np.where(kind_of == 0, MASK - x, y).astype(np.uint64)
        y = np.where(kind_of == 1, MASK, y).astype(np.uint64)
        x = np.where(kind_of == 3, 0, x).astype(np.uint64)
        x[:8] = MASK  # one chain over the whole warp
        y[:8] = 0
        y[:8, 0] = np.arange(8) % 2
    return x, y


@pytest.mark.parametrize("kind", ["random", "ones_chains"])
@pytest.mark.parametrize("G", GROUP_SIZES)
def test_ballot_carry_equals_kogge_stone(G, kind):
    """Every group of the warp adds as one number, and no carry crosses
    from one group into the next."""
    rng = np.random.default_rng(G * 7 + len(kind))
    x, y = _carry_cases(rng, kind)
    got = _ballot_add(x, y, G).astype(np.int64)
    for g0 in range(0, 32, G):
        want = _add_with_carry(
            torch.as_tensor(x[:, g0:g0 + G].astype(np.int64)),
            torch.as_tensor(y[:, g0:g0 + G].astype(np.int64)),
        ).numpy()
        np.testing.assert_array_equal(got[:, g0:g0 + G], want)
    # and against Python's big integers
    for r in range(0, x.shape[0], 97):
        for g0 in range(0, 32, G):
            words = range(g0, g0 + G)
            big = sum((int(x[r, w]) + int(y[r, w])) << (32 * (w - g0)) for w in words)
            out = sum(int(got[r, w]) << (32 * (w - g0)) for w in words)
            assert out == big % (1 << (32 * G))


def _shift1(x, fill):
    return ((x << np.uint64(1)) & np.uint64(MASK)) | np.concatenate(
        [np.full_like(x[:, :1], fill), x[:, :-1] >> np.uint64(31)], axis=1
    )


def _group_model(enc, I, J, G):
    """Group mode of K1 in numpy, one row of G words per pair, one word
    per lane: the add carried by ``_ballot_add``, the shifts lane to lane,
    the state frozen after the pair's last character and the distance
    read as lb + popc(VP) - popc(VN) over the pattern bits."""
    lengths = enc.lengths.numpy().astype(np.int64)
    ids = enc.ids.numpy()
    peq = enc.peq.numpy().view(np.uint32).astype(np.uint64)
    wtab = peq.shape[2]
    la, lb = lengths[I], lengths[J]
    swap = la > lb
    P, T = np.where(swap, J, I), np.where(swap, I, J)
    la, lb = np.minimum(la, lb), np.maximum(la, lb)
    w = np.arange(G)
    nbits = np.clip(la[:, None] - 32 * w, 0, 32)
    first = np.where(nbits >= 32, MASK, (1 << nbits) - 1).astype(np.uint64)
    VP, VN = first.copy(), np.zeros_like(first)
    M = np.uint64(MASK)
    for j in range(int(lb.max())):
        live = (j < lb)[:, None]
        c = np.where(j < lb, ids[T, np.minimum(j, ids.shape[1] - 1)], 0)
        eq = np.where(w < wtab, peq[P[:, None], c[:, None], np.minimum(w, wtab - 1)], 0)
        eq = eq.astype(np.uint64)
        s = _ballot_add(eq & VP, VP)
        d0 = (s ^ VP) | eq | VN
        hp = VN | (~(d0 | VP) & M)
        hn = VP & d0
        x, y = _shift1(hp, 1), _shift1(hn, 0)
        VP = np.where(live, y | (~(d0 | x) & M), VP)
        VN = np.where(live, x & d0, VN)
    popc = np.bitwise_count
    return lb + (popc(VP & first).astype(np.int64) - popc(VN & first)).sum(1)


@pytest.mark.parametrize("alphabet,G", [("ab", 8), ("ACGT", 16), ("abcdefghijklmnopqrstuvwxyz", 32)])
def test_group_mode_model_equals_plain(alphabet, G):
    rng = np.random.default_rng(len(alphabet))
    hi = 32 * G - 20
    strs = [
        "".join(rng.choice(list(alphabet), size=int(rng.integers(0, hi + 1))))
        for _ in range(40)
    ]
    strs[:4] = ["", "a" * 33, alphabet[0] * (32 * G), alphabet[-1] * 31]
    enc = MyersEncoding.from_codes(*encode_strings(strs), "cpu")
    assert enc.wmax <= G
    I = rng.integers(0, len(strs), size=300)
    J = rng.integers(0, len(strs), size=300)
    I[:4] = np.arange(4)
    got = _group_model(enc, I, J, G)
    want = myers_pairs_plain(enc, torch.as_tensor(I), torch.as_tensor(J)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:12].tolist() == [
        levenshtein_scalar(strs[i], strs[j]) for i, j in zip(I[:12], J[:12])
    ]


def test_word_steps_matches_loop():
    rng = np.random.default_rng(4)
    lengths = rng.integers(0, 700, size=50).astype(np.int32)
    lengths[:3] = (0, 32, 33)
    I = rng.integers(0, 50, size=400)
    J = rng.integers(0, 50, size=400)
    I[:3] = (0, 1, 2)
    I[3] = J[3] = 7  # a string against itself costs nothing
    want = 0
    for i, j in zip(I, J):
        if i == j:
            continue
        la, lb = sorted((int(lengths[i]), int(lengths[j])))
        want += -(-la // 32) * lb
    got = word_steps(torch.as_tensor(lengths), torch.as_tensor(I), torch.as_tensor(J))
    assert got == want


def test_encoding_records_greatest_word_count():
    enc = MyersEncoding.from_codes(*encode_strings(["", "a" * 33, "ab"]), "cpu")
    assert enc.wmax == 2 and enc.W == 4  # the table is padded to 128 columns
    assert MyersEncoding.from_codes(*encode_strings([""]), "cpu").wmax == 0


def test_encoding_records_bulk_word_count():
    """``wbulk`` is the word count 99 % of the strings do not exceed: one
    long string among 150 leaves it at the others' width."""
    strs = ["ab" * 20] * 150 + ["a" * 2100]
    enc = MyersEncoding.from_codes(*encode_strings(strs), "cpu")
    assert (enc.wmax, enc.wbulk) == (66, 2)
    enc = MyersEncoding.from_codes(*encode_strings(strs[:60] + strs[-1:]), "cpu")
    assert (enc.wmax, enc.wbulk) == (66, 66)  # one string of 61 is the top 2 %
    assert MyersEncoding.from_codes(*encode_strings([""]), "cpu").wbulk == 0
