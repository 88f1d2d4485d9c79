"""Wrapper of the hand-written CUDA edit-distance kernel (K1).

The kernel, ``csrc/levenshtein_myers.cu``, replaces ``_kernel`` of
``annchor_tpu/ops/levenshtein_pallas.py`` and the XLA Myers tier.  It
takes the pair ids in input order, puts the shorter string of each pair
on the pattern side itself and writes each distance to its own slot, so
the wrapper only checks the inputs, picks a launch plan and launches on
PyTorch's current stream: no sort, no scatter and no host sync.
``myers_pairs_plain`` in ``ops/levenshtein_myers.py`` is its plain
PyTorch version.

The launch plan (``launch_plan``) is a plain function of numbers the
host knows: the batch size B, two word counts recorded by
``MyersEncoding`` when it is built (``wbulk``, which 99 % of the strings
do not exceed, and ``wmax``, the longest string's) and the alphabet.  Its
first launch is sized for ``wbulk`` and runs every pair, in group mode (G
lanes of a warp per pair) for batches too small to fill the card with one
thread per pair, thread mode otherwise, or long mode where even the bulk
of the strings has more than 64 words.  A pair whose pattern outgrows a
launch goes onto an overflow list on the card, which the plan's next
launch runs: thread mode up to 64 words, then long mode.  So a few long
strings cost only their own pairs, and the card never reports a count
back to the host.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from annchor_tpu_torch._backend import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int

MODES = ("thread", "group", "long")

# every launcher: 10 pointers (tables, ids, output, input list and its
# length, overflow list and its counter), 8 ints (count, alphabet, wtab,
# L, si, sj, idx64, blocks), its own values, the stream
_COMMON = [_P] * 10 + [_I] * 8
K1 = Kernel(
    "levenshtein_myers",
    "levenshtein_myers.cu",
    {
        "annchor_k1_thread": _COMMON + [_I, _P],
        "annchor_k1_group": _COMMON + [_I] * 3 + [_P],
        "annchor_k1_long": _COMMON + [_P, _P],
    },
    modes=MODES,
)

THREADS = 128  # threads per block, every mode
# thread mode: register-state word buckets (the kernel's template values)
THREAD_BUCKETS = (4, 8, 12, 16, 20, 24, 28, 32, 48, 64)
GROUP_SIZES = (8, 16, 32)  # group mode: lanes per pair
# group mode keeps a lane's Peq words in shared memory when alphabet x
# words-per-lane is at most this (16 KB for a block of 128 lanes)
SMEM_WORDS = 32
LONG_BLOCKS = 132 * 8  # long mode over every pair: grid-stride blocks
LIST_BLOCKS = 132 * 2  # a launch over an overflow list: grid-stride blocks
# Auto dispatch, from chip_smoke.py phase 5's crossover sweep (H100 80GB
# HBM3, 700 W; PERF.md).  Thread mode spends the fewest
# instructions per word step, but a thread's chain is the whole pair, so
# it wins only once the batch gives the card enough warps.  strings-1600
# (W 18, G 16) crossed over between 20,000 pairs (group 0.42 ms, thread
# 0.50 ms) and 30,000 (group 0.63, thread 0.52), i.e. 320k-480k lanes;
# the 100k corpus (W 15, G 8) between 50,000 (group 0.46, thread 0.51)
# and 100,000 (group 0.89, thread 0.77), i.e. 400k-800k lanes.  Group
# mode while B x G is at most this many lanes:
GROUP_LANES_MAX = 7 << 16
_INT_MAX = (1 << 31) - 1


@dataclass(frozen=True)
class Plan:
    """One launch of K1: ``mode`` with its template values and grid.

    thread: ``wb`` register words per thread.  group: ``g`` lanes per
    pair, ``wpl`` words per lane, Peq words in shared memory when
    ``smem``; pair k is lanes [k*g, (k+1)*g).  long: state in scratch.
    ``listed``: the launch runs the previous launch's overflow list with
    grid-stride threads; else it runs every pair."""

    mode: str
    grid: int
    wb: int = 0
    g: int = 0
    wpl: int = 0
    smem: bool = False
    listed: bool = False

    @property
    def words(self) -> int:
        """The most pattern words a pair of this launch may have; a
        longer pattern goes onto the overflow list."""
        if self.mode == "thread":
            return self.wb
        if self.mode == "group":
            return self.g * self.wpl
        return 1 << 30


def group_layout(words: int):
    """(G, words per lane) of group mode for patterns of at most
    ``words`` words: the fewest lanes, two words each where one is not
    enough (a sweep recorded in PERF.md: 8x2 beat 16x1 by 25-35 % at W
    15, 16x2 beat 32x1 by 12-30 % at W 18)."""
    g = next(g for g in GROUP_SIZES if 2 * g >= words)
    return g, 1 if g >= words else 2


def _bucket(words: int) -> int:
    return next(b for b in THREAD_BUCKETS if b >= words)


def launch_plan(B: int, wbulk: int, wmax: int, alphabet: int,
                mode: str = "auto") -> tuple:
    """The launches of K1, in order, for B pairs of a dataset whose
    strings have at most ``wmax`` 32-bit words, 99 % of them at most
    ``wbulk``.  ``mode`` ("auto", "thread" or "group") picks the first
    launch; where the bulk has more than 64 words it is long mode
    whatever ``mode`` says.  Each later launch runs the overflow list of
    the one before it."""
    if mode not in ("auto", "thread", "group"):
        raise ValueError("mode must be 'auto', 'thread' or 'group', got %r" % mode)
    wmax = max(int(wmax), 1)
    wbulk = min(max(int(wbulk), 1), wmax)
    list_grid = min(-(-B // THREADS), LIST_BLOCKS)
    if wbulk > THREAD_BUCKETS[-1]:
        return (Plan("long", min(-(-B // THREADS), LONG_BLOCKS)),)
    g, wpl = group_layout(wbulk)
    if mode == "auto":
        mode = "group" if B * g <= GROUP_LANES_MAX else "thread"
    if mode == "group":
        if B * g > _INT_MAX:
            raise ValueError("%d pairs x %d lanes overflow the grid" % (B, g))
        plans = [Plan("group", -(-B * g // THREADS), g=g, wpl=wpl,
                      smem=alphabet * wpl <= SMEM_WORDS)]
    else:
        plans = [Plan("thread", -(-B // THREADS), wb=_bucket(wbulk))]
    if plans[-1].words < min(wmax, THREAD_BUCKETS[-1]):
        plans.append(Plan("thread", list_grid, wb=_bucket(min(wmax, THREAD_BUCKETS[-1])),
                          listed=True))
    if plans[-1].words < wmax:
        plans.append(Plan("long", list_grid, listed=True))
    return tuple(plans)


def _check(name, t, dtype, ndim, device):
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            "%s must be a contiguous %d-d %s tensor, got %s %s"
            % (name, ndim, dtype, t.dtype, tuple(t.shape))
        )


def myers_pairs_cuda(peq, ids, lengths, I, J, wmax=None, mode="auto", wbulk=None):
    """Edit distances of the pairs (I[k], J[k]) on the card.

    peq: (n, alphabet, W) int32 (uint32 bit patterns); ids: (n, L)
    int32 dense symbol ids; lengths: (n,) int32; I, J: (B,) int32 or
    int64 ids, any stride (an ``expand``ed id is read in place).
    ``wmax`` bounds the word count of every string (default: the
    table's W) and ``wbulk`` that of 99 % of them (default: ``wmax``);
    ``mode`` forces the first launch's mode (see ``launch_plan``).
    Returns int32 (B,).  Nothing here waits for the card."""
    dev = peq.device
    if dev.type != "cuda":
        raise ValueError("myers_pairs_cuda takes CUDA tensors, got %s" % dev)
    _check("peq", peq, torch.int32, 3, dev)
    _check("ids", ids, torch.int32, 2, dev)
    _check("lengths", lengths, torch.int32, 1, dev)
    n, alphabet, wtab = peq.shape
    if ids.shape[0] != n or lengths.shape[0] != n:
        raise ValueError("peq, ids and lengths disagree on the row count")
    for name, t in (("I", I), ("J", J)):
        if t.device != dev or t.dim() != 1 or t.dtype not in (
            torch.int32, torch.int64
        ):
            raise ValueError("%s must be a 1-d integer tensor on %s" % (name, dev))
    if I.shape != J.shape:
        raise ValueError("I and J differ in length")
    if I.dtype != J.dtype:
        I, J = I.long(), J.long()
    B = int(I.shape[0])
    if B > _INT_MAX:
        raise ValueError("%d pairs: split the batch below 2^31" % B)
    wmax = wtab if wmax is None else int(wmax)
    if wmax > wtab:
        raise ValueError("wmax %d exceeds the table's %d words" % (wmax, wtab))
    wbulk = wmax if wbulk is None else int(wbulk)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        launch(launch_plan(B, wbulk, wmax, alphabet, mode), peq, ids, lengths, I, J, out)
    return out


def launch(plans, peq, ids, lengths, I, J, out):
    """Launch K1 by ``plans`` (``launch_plan``'s tuple) on checked
    inputs; counts each launch.  Launch s > 0 reads overflow list s - 1,
    which launch s - 1 filled, and its length from the card."""
    _, alphabet, wtab = peq.shape
    B = int(out.shape[0])
    lib = K1.lib()
    dev = peq.device
    nlists = len(plans) - 1
    if nlists:
        counts = torch.zeros(nlists, dtype=torch.int32, device=dev)
        lists = torch.empty((nlists, B), dtype=torch.int32, device=dev)
    dims = (B, alphabet, wtab, int(ids.shape[1]),
            I.stride(0), J.stride(0), int(I.dtype == torch.int64))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s, plan in enumerate(plans):
            inp = ((lists[s - 1].data_ptr(), counts[s - 1].data_ptr()) if plan.listed
                   else (None, None))
            ovf = (lists[s].data_ptr(), counts[s].data_ptr()) if s < nlists else (None, None)
            ptrs = (peq.data_ptr(), ids.data_ptr(), lengths.data_ptr(),
                    I.data_ptr(), J.data_ptr(), out.data_ptr(), *inp, *ovf)
            if plan.mode == "thread":
                fn = "annchor_k1_thread"
                code = lib.annchor_k1_thread(*ptrs, *dims, plan.grid, plan.wb, stream)
            elif plan.mode == "group":
                fn = "annchor_k1_group"
                code = lib.annchor_k1_group(
                    *ptrs, *dims, plan.grid, plan.g, plan.wpl, int(plan.smem), stream)
            else:
                fn = "annchor_k1_long"
                # freed on return: the caching allocator orders its reuse
                # after this launch on the same stream
                scratch = torch.empty(
                    2 * wtab * plan.grid * THREADS, dtype=torch.int32, device=dev)
                code = lib.annchor_k1_long(
                    *ptrs, *dims, plan.grid, scratch.data_ptr(), stream)
            K1.count(plan.mode)
            K1.check(fn, code)


def word_steps(lengths, I, J) -> int:
    """The word steps of the pairs (I[k], J[k]): ceil(la / 32) x lb with
    la the shorter length, none for a string against itself; the work
    unit of K1's bound."""
    la = lengths[I].long()
    lb = lengths[J].long()
    steps = (torch.minimum(la, lb) + 31) // 32 * torch.maximum(la, lb)
    return int(torch.where(I == J, 0, steps).sum())
