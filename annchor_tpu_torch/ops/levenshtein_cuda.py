"""Wrapper of the hand-written CUDA edit-distance kernel (K1).

The kernel, ``csrc/levenshtein_myers.cu``, replaces ``_kernel`` of
``annchor_tpu/ops/levenshtein_pallas.py`` and the XLA Myers tier.  This
module checks the inputs, puts the shorter string of each pair on the
pattern side (as ``_pallas_pairs_dev`` does), sorts the pairs by the
pattern's word count (stable) so each word bucket is one contiguous
launch, launches on PyTorch's current stream and scatters the
distances back to input order.  ``myers_pairs_plain`` in
``ops/levenshtein_myers.py`` is its plain PyTorch version.
"""

from __future__ import annotations

import ctypes

import torch

from annchor_tpu_torch._backend import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int

K1 = Kernel(
    "levenshtein_myers",
    "levenshtein_myers.cu",
    {"annchor_myers_pairs": [_P] * 7 + [_I] * 5 + [_P]},
)

# register-state word buckets; past the last one the state goes to a
# scratch buffer (bucket 0 in the C interface)
BUCKETS = (1, 2, 4, 8, 16, 32, 64)


def _check(name, t, dtype, ndim, device):
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            "%s must be a contiguous %d-d %s tensor, got %s %s"
            % (name, ndim, dtype, t.dtype, tuple(t.shape))
        )


def myers_pairs_cuda(peq, ids, lengths, I, J):
    """Edit distances of the pairs (I[k], J[k]) on the card.

    peq: (n, alphabet, W) int32 (uint32 bit patterns); ids: (n, L)
    int32 dense symbol ids; lengths: (n,) int32; I, J: (B,) integer
    ids.  Returns int32 (B,)."""
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
    B = int(I.shape[0])
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    I = I.long()
    J = J.long()
    la = lengths[I]
    lb = lengths[J]
    swap = la > lb
    pat = torch.where(swap, J, I)
    txt = torch.where(swap, I, J)
    words = (torch.minimum(la, lb) + 31) // 32
    order = torch.argsort(words, stable=True)
    pat = pat[order].to(torch.int32)
    txt = txt[order].to(torch.int32)
    bucket_of = torch.bucketize(
        words, torch.tensor(BUCKETS, dtype=words.dtype, device=dev)
    )
    counts = torch.bincount(bucket_of, minlength=len(BUCKETS) + 1).tolist()

    lib = K1.lib()
    res = torch.empty(B, dtype=torch.int32, device=dev)
    start = 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for b, cnt in enumerate(counts):
            if cnt == 0:
                continue
            bucket = BUCKETS[b] if b < len(BUCKETS) else 0
            scratch = None
            if bucket == 0:
                scratch = torch.empty(2 * wtab * cnt, dtype=torch.int32, device=dev)
            code = lib.annchor_myers_pairs(
                peq.data_ptr(),
                ids.data_ptr(),
                lengths.data_ptr(),
                pat.data_ptr() + 4 * start,
                txt.data_ptr() + 4 * start,
                res.data_ptr() + 4 * start,
                None if scratch is None else scratch.data_ptr(),
                cnt, alphabet, wtab, int(ids.shape[1]), bucket,
                stream,
            )
            K1.launches += 1
            K1.check("annchor_myers_pairs", code)
            start += cnt
    out[order] = res
    return out
