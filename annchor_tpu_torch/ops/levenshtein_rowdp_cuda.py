"""Wrapper of the hand-written CUDA row-DP edit-distance kernel (K10).

The kernel, ``csrc/levenshtein_rowdp.cu``, replaces the JAX package's XLA
program ``_lev_batch`` (``annchor_tpu/ops/levenshtein.py``), which runs
every edit distance of a dataset over more than 192 distinct symbols.
One thread owns a pair and keeps the DP between strips of 16 columns in
its own slice of a scratch buffer that the wrapper allocates: one launch
per call, on PyTorch's current stream, with no sort and no host sync.
``lev_pairs_plain`` in ``ops/levenshtein.py`` is its plain PyTorch
version.
"""

from __future__ import annotations

import ctypes

import torch

from annchor_tpu_torch._backend import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int

K10 = Kernel(
    "levenshtein_rowdp",
    "levenshtein_rowdp.cu",
    {"annchor_k10_rowdp": [_P] * 6 + [_I] * 6 + [_P]},
    modes=("thread",),
)

THREADS = 128  # threads per block
# grid-stride blocks at most: 8 blocks of 128 threads on each of the 132
# SMs, which bounds the scratch at 135,168 x (the longest string + 1) ints
MAX_BLOCKS = 132 * 8
_INT_MAX = (1 << 31) - 1


def _check(name, t, ndim, device):
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != torch.int32 or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            "%s must be a contiguous %d-d int32 tensor, got %s %s"
            % (name, ndim, t.dtype, tuple(t.shape))
        )


def rowdp_pairs_cuda(ids, lengths, I, J, lmax=None):
    """Edit distances of the pairs (I[k], J[k]) on the card.

    ids: (n, L) int32 codepoints, -1 past each string's end; lengths:
    (n,) int32; I, J: (B,) int32 or int64 ids, any stride.  ``lmax``
    bounds every string's length (default: L) and sizes the scratch.
    Returns int32 (B,).  Nothing here waits for the card."""
    dev = ids.device
    if dev.type != "cuda":
        raise ValueError("rowdp_pairs_cuda takes CUDA tensors, got %s" % dev)
    _check("ids", ids, 2, dev)
    _check("lengths", lengths, 1, dev)
    n, L = ids.shape
    if lengths.shape[0] != n:
        raise ValueError("ids and lengths disagree on the row count")
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
    lmax = L if lmax is None else int(lmax)
    if lmax > L:
        raise ValueError("lmax %d exceeds the table's %d columns" % (lmax, L))
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        launch(ids, lengths, I, J, out, lmax)
    return out


def launch(ids, lengths, I, J, out, lmax):
    """One launch of K10 on checked inputs; counts it."""
    B = int(out.shape[0])
    blocks = min(-(-B // THREADS), MAX_BLOCKS)
    dev = ids.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # freed on return: the caching allocator orders its reuse after
        # this launch on the same stream
        col = torch.empty(blocks * THREADS * (lmax + 1), dtype=torch.int32, device=dev)
        code = K10.lib().annchor_k10_rowdp(
            ids.data_ptr(), lengths.data_ptr(), I.data_ptr(), J.data_ptr(),
            out.data_ptr(), col.data_ptr(), B, int(ids.shape[1]), I.stride(0),
            J.stride(0), int(I.dtype == torch.int64), blocks, stream)
        K10.count("thread")
        K10.check("annchor_k10_rowdp", code)


def cells(lengths, I, J) -> int:
    """The DP cells of the pairs (I[k], J[k]): la x lb, none for a string
    against itself; the work unit of K10's bound."""
    la = lengths[I].long()
    lb = lengths[J].long()
    return int(torch.where(I == J, 0, la * lb).sum())
