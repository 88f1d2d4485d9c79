"""Wrapper of the hand-written CUDA edit-distance kernel for alphabets of
more than 192 symbols (K10).

The kernel, ``csrc/levenshtein_rowdp.cu``, replaces the JAX package's XLA
program ``_lev_batch`` (``annchor_tpu/ops/levenshtein.py``), which runs
every edit distance of a dataset over more than 192 distinct symbols.  It
runs K1's bit-parallel word step over the sparse Peq table that
``RowDPEncoding`` builds (each string's rows of only the symbols it
contains), in K1's three modes: thread, group and long.  The launch plan
is K1's (``ops/levenshtein_cuda.launch_plan``: the first launch sized for
the strings' bulk, overflow lists on the card for the longer patterns)
with K10's own thread/group crossover and shared-memory rule.  One call
launches on PyTorch's current stream with no sort and no host sync.
``lev_pairs_plain`` in ``ops/levenshtein.py`` is its plain PyTorch
version.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from annchor_tpu_torch._backend import Kernel
from annchor_tpu_torch.ops import levenshtein_cuda as k1

_P = ctypes.c_void_p
_I = ctypes.c_int

MODES = ("thread", "group", "long")

# every launcher: 13 pointers (the sparse table's four, ids, lengths, I, J,
# output, input list and its length, overflow list and its counter), 6
# ints (count, L, si, sj, idx64, blocks), its own values, the stream
_COMMON = [_P] * 13 + [_I] * 6
K10 = Kernel(
    "levenshtein_rowdp",
    "levenshtein_rowdp.cu",
    {
        "annchor_k10_thread": _COMMON + [_I, _P],
        "annchor_k10_group": _COMMON + [_I] * 3 + [_P],
        "annchor_k10_long": _COMMON + [_I, _P, _P],
    },
    modes=MODES,
)

THREADS = k1.THREADS
# group mode stages a pattern's table (symbols and rows) in shared memory
# when the bulk of the strings' tables (``tbulk`` words) fits a block's
# groups in this many bytes, the most a block takes without an opt-in
SMEM_BYTES = 48 * 1024
# Auto dispatch, from chip_smoke.py phase 12(c)'s crossover sweep (H100
# 80GB HBM3, 700.00 W; PERF.md): on strings-1600 over 256 symbols (W
# 17-18, G 16) group mode won at 40,000 pairs (group 1.38 ms, thread
# 1.67 ms) and thread mode at 50,000 (thread 1.69, group 1.72), so they
# cross near 48,000 pairs, 770k lanes (K1 crosses at 458,752: K10's
# thread mode spends more per character on its search).  Group mode
# while B x G is at most this many lanes:
GROUP_LANES_MAX = 12 << 16
_INT_MAX = (1 << 31) - 1


def launch_plan(B: int, wbulk: int, wmax: int, tbulk: int, mode: str = "auto") -> tuple:
    """The launches of K10, in order, for B pairs of a dataset whose
    strings have at most ``wmax`` 32-bit words, 99 % of them at most
    ``wbulk``, and 99 % of whose sparse tables hold at most ``tbulk``
    words.  ``mode`` ("auto", "thread" or "group") picks the first
    launch; where the bulk has more than 64 words it is long mode
    whatever ``mode`` says.  A group launch's ``smem`` gives each group
    ``tbulk`` words of shared memory, where a pattern's table that fits
    is staged."""
    if mode not in ("auto", "thread", "group"):
        raise ValueError("mode must be 'auto', 'thread' or 'group', got %r" % mode)
    words = min(max(int(wbulk), 1), max(int(wmax), 1))
    if mode == "auto":
        group = (words <= k1.THREAD_BUCKETS[-1]
                 and B * k1.group_layout(words)[0] <= GROUP_LANES_MAX)
        mode = "group" if group else "thread"
    plans = k1.launch_plan(B, wbulk, wmax, alphabet=1 << 30, mode=mode)
    return tuple(
        dataclasses.replace(p, smem=0 < tbulk * (THREADS // p.g) * 4 <= SMEM_BYTES)
        if p.mode == "group" else p
        for p in plans
    )


def plan_for(enc, B: int, mode: str = "auto") -> tuple:
    """``launch_plan`` for B pairs of the encoding ``enc``."""
    return launch_plan(B, enc.wbulk, enc.wmax, enc.tbulk, mode)


def _check(name, t, dtype, device):
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError("%s must be a contiguous %s tensor, got %s %s"
                         % (name, dtype, t.dtype, tuple(t.shape)))


def rowdp_pairs_cuda(enc, I, J, mode="auto"):
    """Edit distances of the pairs (I[k], J[k]) of a ``RowDPEncoding`` on
    the card.

    I, J: (B,) int32 or int64 ids on the encoding's device, any stride
    (an ``expand``ed id is read in place).  ``mode`` forces the first
    launch's mode (see ``launch_plan``).  Returns int32 (B,).  Nothing
    here waits for the card."""
    dev = enc.device
    if dev.type != "cuda":
        raise ValueError("rowdp_pairs_cuda takes an encoding on a card, got %s" % dev)
    n = enc.n
    for name, dtype in (("ids", torch.int32), ("lengths", torch.int32),
                        ("sym", torch.int32), ("soff", torch.int64),
                        ("mask", torch.int32), ("moff", torch.int64)):
        _check(name, getattr(enc, name), dtype, dev)
    if (enc.ids.dim() != 2 or enc.lengths.shape != (n,) or enc.soff.shape != (n + 1,)
            or enc.moff.shape != (n + 1,)):
        raise ValueError("the encoding's tables disagree on the row count")
    for name, t in (("I", I), ("J", J)):
        if t.device != dev or t.dim() != 1 or t.dtype not in (torch.int32, torch.int64):
            raise ValueError("%s must be a 1-d integer tensor on %s" % (name, dev))
    if I.shape != J.shape:
        raise ValueError("I and J differ in length")
    if I.dtype != J.dtype:
        I, J = I.long(), J.long()
    B = int(I.shape[0])
    if B > _INT_MAX:
        raise ValueError("%d pairs: split the batch below 2^31" % B)
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        launch(plan_for(enc, B, mode), enc, I, J, out)
    return out


def launch(plans, enc, I, J, out):
    """Launch K10 by ``plans`` (``launch_plan``'s tuple) on checked
    inputs; counts each launch.  Launch s > 0 reads overflow list s - 1,
    which launch s - 1 filled, and its length from the card."""
    B = int(out.shape[0])
    lib = K10.lib()
    dev = enc.device
    nlists = len(plans) - 1
    if nlists:
        counts = torch.zeros(nlists, dtype=torch.int32, device=dev)
        lists = torch.empty((nlists, B), dtype=torch.int32, device=dev)
    dims = (B, int(enc.ids.shape[1]), I.stride(0), J.stride(0), int(I.dtype == torch.int64))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for s, plan in enumerate(plans):
            inp = ((lists[s - 1].data_ptr(), counts[s - 1].data_ptr()) if plan.listed
                   else (None, None))
            ovf = (lists[s].data_ptr(), counts[s].data_ptr()) if s < nlists else (None, None)
            ptrs = (enc.sym.data_ptr(), enc.soff.data_ptr(), enc.mask.data_ptr(),
                    enc.moff.data_ptr(), enc.ids.data_ptr(), enc.lengths.data_ptr(),
                    I.data_ptr(), J.data_ptr(), out.data_ptr(), *inp, *ovf)
            if plan.mode == "thread":
                fn = "annchor_k10_thread"
                code = lib.annchor_k10_thread(*ptrs, *dims, plan.grid, plan.wb, stream)
            elif plan.mode == "group":
                fn = "annchor_k10_group"
                code = lib.annchor_k10_group(*ptrs, *dims, plan.grid, plan.g, plan.wpl,
                                             enc.tbulk if plan.smem else 0, stream)
            else:
                fn = "annchor_k10_long"
                wtab = max(enc.wmax, 1)
                # freed on return: the caching allocator orders its reuse
                # after this launch on the same stream
                scratch = torch.empty(2 * wtab * plan.grid * THREADS, dtype=torch.int32,
                                      device=dev)
                code = lib.annchor_k10_long(*ptrs, *dims, plan.grid, wtab,
                                            scratch.data_ptr(), stream)
            K10.count(plan.mode)
            K10.check(fn, code)


def word_steps(lengths, I, J) -> int:
    """The word steps of the pairs (I[k], J[k]), K1's unit
    (``levenshtein_cuda.word_steps``): with ``search_probes``, the work
    of K10's bound."""
    return k1.word_steps(lengths, I, J)


def cells(lengths, I, J) -> int:
    """The DP cells of the pairs (I[k], J[k]): la x lb, none for a string
    against itself; the work unit of the row DP that K10 replaced."""
    la = lengths[I].long()
    lb = lengths[J].long()
    return int(torch.where(I == J, 0, la * lb).sum())


def search_probes(enc, I, J) -> int:
    """The search's probes of the pairs (I[k], J[k]): each text character
    of a pair costs ceil(log2 n) + 1 of them, n the pattern's distinct
    symbols; none for a string against itself or an empty pattern."""
    lengths = enc.lengths.long()
    la = lengths[I.long()]
    lb = lengths[J.long()]
    P = torch.where(la > lb, J.long(), I.long())
    n = enc.soff[P + 1] - enc.soff[P]
    depth = torch.ceil(torch.log2(n.clamp(min=1).double())).long()
    probes = torch.where(n > 0, depth + 1, 0) * torch.maximum(la, lb)
    return int(torch.where(I.long() == J.long(), 0, probes).sum())
