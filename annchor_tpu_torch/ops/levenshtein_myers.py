"""Bit-parallel (Myers/Hyyrö) edit distance: encoding, pair evaluation
and the greedy max-min anchor loop.

Strings are encoded against a dataset-wide dense alphabet and each
string gets a Peq table (alphabet x W uint32 words; bit k of word w of
``peq[s, c]`` is set iff character 32w+k of string s is c).  The edit
distance of a pair runs the Myers bit-vector recurrence of the shorter
string (the pattern) over the characters of the longer one (the text);
see ``csrc/levenshtein_myers.cu`` for the recurrence.

``myers_pairs`` is the one entry point for pair batches: CUDA tensors
go to the hand-written kernel (``ops/levenshtein_cuda.py``), CPU tensors
to ``myers_pairs_plain``, the same recurrence written in PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

UINT1 = np.uint32(1)

# Peq tables past this many distinct symbols are the row-DP kernel's
# domain, which is not ported yet
MAX_ALPHABET = 192

_MASK = 0xFFFFFFFF  # a 32-bit word held in an int64 lane


def encode_alphabet(codes: np.ndarray, lengths: np.ndarray):
    """Map a padded codepoint matrix (pad = -1) to dense alphabet ids.

    Returns (ids int32 (n, L) with -1 pads, alphabet_size) or None when
    the alphabet is too large for the bit-parallel path.
    """
    codes = np.asarray(codes)
    uniq = np.unique(codes)
    uniq = uniq[uniq >= 0]
    if uniq.shape[0] > MAX_ALPHABET:
        return None
    lut_size = int(uniq.max()) + 1 if uniq.shape[0] else 1
    if lut_size > (1 << 22):  # degenerate sparse codepoints: use search
        ids = np.searchsorted(uniq, np.where(codes < 0, uniq[0], codes))
        ids = np.where(codes < 0, -1, ids).astype(np.int32)
        return ids, int(uniq.shape[0])
    lut = np.full(lut_size + 1, -1, dtype=np.int32)
    lut[uniq] = np.arange(uniq.shape[0], dtype=np.int32)
    ids = np.where(codes < 0, -1, lut[np.clip(codes, 0, lut_size)])
    return ids.astype(np.int32), int(uniq.shape[0])


def build_peq(ids: np.ndarray, lengths: np.ndarray, alphabet: int):
    """Per-string Peq bitmask tables.

    ids: (n, L) dense alphabet ids (-1 pad).  Returns uint32
    (n, alphabet, W) with W = ceil(L/32); bit k of word w of Peq[s, c]
    is set iff ids[s, 32w + k] == c.
    """
    n, L = ids.shape
    W = (L + 31) // 32
    padL = W * 32
    idp = np.full((n, padL), -1, dtype=np.int64)
    idp[:, :L] = ids
    idp = idp.reshape(n, W, 32)
    weights = (UINT1 << np.arange(32, dtype=np.uint32)).astype(np.uint32)
    peq = np.zeros((n, alphabet, W), dtype=np.uint32)
    # one pass per symbol: vectorised bit-packing
    for c in range(alphabet):
        mask = idp == c  # (n, W, 32)
        peq[:, c, :] = (mask * weights[None, None, :]).sum(
            axis=2, dtype=np.uint64
        ).astype(np.uint32)
    return peq


class MyersEncoding:
    """Per-dataset tables on one device.

    ids (n, L) int32 dense alphabet ids, -1 past each string's end;
    lengths (n,) int32; peq (n, alphabet, W) uint32 words stored as
    int32 bit patterns (CPU PyTorch has no uint32 bit operations)."""

    __slots__ = ("ids", "lengths", "peq", "alphabet", "W")

    def __init__(self, ids, lengths, peq, alphabet, device):
        dev = torch.device(device)
        self.ids = torch.from_numpy(
            np.ascontiguousarray(ids, dtype=np.int32)
        ).to(dev)
        self.lengths = torch.from_numpy(
            np.ascontiguousarray(lengths, dtype=np.int32)
        ).to(dev)
        self.peq = torch.from_numpy(
            np.ascontiguousarray(peq, dtype=np.uint32).view(np.int32)
        ).to(dev)
        self.alphabet = int(alphabet)
        self.W = int(self.peq.shape[2])

    @property
    def device(self) -> torch.device:
        return self.peq.device

    @property
    def n(self) -> int:
        return int(self.peq.shape[0])

    @classmethod
    def from_codes(cls, codes, lengths, device):
        enc = encode_alphabet(codes, lengths)
        if enc is None:
            raise NotImplementedError(
                "more than %d distinct symbols: the row-DP edit-distance "
                "kernel (ROADMAP Queue 2, K10) is not ported yet"
                % MAX_ALPHABET
            )
        ids, alphabet = enc
        peq = build_peq(ids, lengths, alphabet)
        return cls(ids, lengths, peq, alphabet, device)


def myers_pairs(enc: MyersEncoding, I, J):
    """Edit distances of the pairs (I[k], J[k]) as an int32 tensor.

    I and J are integer tensors on the encoding's device.  A CUDA
    device launches the hand-written kernel; the plain PyTorch version
    runs only for tensors on the CPU."""
    if I.device != enc.device or J.device != enc.device:
        raise ValueError(
            "pair ids on %s/%s, encoding on %s"
            % (I.device, J.device, enc.device)
        )
    if enc.device.type == "cuda":
        from annchor_tpu_torch.ops.levenshtein_cuda import myers_pairs_cuda

        return myers_pairs_cuda(enc.peq, enc.ids, enc.lengths, I, J)
    if enc.device.type == "cpu":
        return myers_pairs_plain(enc, I, J)
    raise NotImplementedError("no edit-distance kernel for %s" % enc.device)


def _shift1(x, fill: int):
    """One-bit left shift across the word axis (dim 1), `fill` into
    word 0's bit 0."""
    carry = torch.cat(
        [torch.full_like(x[:, :1], fill), x[:, :-1] >> 31], dim=1
    )
    return ((x << 1) & _MASK) | carry


def _add_with_carry(x, y):
    """Multi-word unsigned x + y over the word axis: a log-step
    (Kogge-Stone) prefix scan of the generate/propagate bits."""
    s = x + y
    G = s >> 32
    s = s & _MASK
    P = (s == _MASK).to(s.dtype)
    W = s.shape[1]
    k = 1
    while k < W:
        G = G | (P & F.pad(G[:, :-k], (k, 0)))
        P = P & F.pad(P[:, :-k], (k, 0), value=1)
        k *= 2
    return (s + F.pad(G[:, :-1], (1, 0))) & _MASK


def myers_pairs_plain(enc: MyersEncoding, I, J, chunk: int = 1 << 18):
    """The plain PyTorch version of the pair kernel: the same
    recurrence vectorised over pairs and words, with each 32-bit word
    in an int64 lane masked to 32 bits.  Returns int32 (B,)."""
    I = I.long()
    J = J.long()
    lengths = enc.lengths.long()
    la = lengths[I]
    lb = lengths[J]
    swap = la > lb
    P = torch.where(swap, J, I)
    T = torch.where(swap, I, J)
    la, lb = torch.minimum(la, lb), torch.maximum(la, lb)
    out = torch.empty(I.shape[0], dtype=torch.int32, device=I.device)
    peq = enc.peq.long().reshape(-1) & _MASK
    for s in range(0, I.shape[0], chunk):
        e = s + chunk
        out[s:e] = _plain_block(enc, peq, P[s:e], T[s:e], la[s:e], lb[s:e])
    return out


def _plain_block(enc, peq_flat, P, T, la, lb):
    dev = P.device
    wtab, L = enc.W, int(enc.ids.shape[1])
    W = max(1, (int(la.max()) + 31) // 32)
    wr = torch.arange(W, device=dev)
    nbits = (la[:, None] - 32 * wr).clamp(0, 32)
    one = torch.ones_like(nbits)
    VP = torch.where(nbits >= 32, _MASK, (one << nbits) - 1)
    VN = torch.zeros_like(VP)
    m1 = (la - 1).clamp(min=0)
    tap = torch.where(
        wr[None, :] == (m1 >> 5)[:, None],
        one[:, :1] << (m1 & 31)[:, None],
        0,
    )
    score = la.clone()
    eq_base = P * (enc.alphabet * wtab)
    text_base = T * L
    ids_flat = enc.ids.reshape(-1)
    for j in range(int(lb.max())):
        c = ids_flat[text_base + j].long()
        row = eq_base + c.clamp(min=0) * wtab
        Eq = torch.where(
            (c >= 0)[:, None], peq_flat[row[:, None] + wr], 0
        )
        D0 = (_add_with_carry(Eq & VP, VP) ^ VP) | Eq | VN
        HP = VN | (~(D0 | VP) & _MASK)
        HN = VP & D0
        inc = ((HP & tap) != 0).any(1).long() - ((HN & tap) != 0).any(1).long()
        score += torch.where(j < lb, inc, 0)
        X = _shift1(HP, 1)
        VP = _shift1(HN, 0) | (~(D0 | X) & _MASK)
        VN = X & D0
    return torch.where(la == 0, lb, score).to(torch.int32)


def myers_maxmin(enc: MyersEncoding, na: int, first_ix: int):
    """Greedy max-min anchors: ``na`` one-vs-all columns, each one
    launch of the pair kernel on (ix, 0..n-1), with the running minimum
    and its argmax kept on the device.

    Keeps the reference's quirk (reference pickers.py:43-50) that the
    running minimum excludes the FIRST anchor's column (``D[1:]``);
    argmax takes the first index of the maximum.  Edit distance is
    symmetric and exact, so each column equals the one-vs-all column.
    Returns (A int64 (na,), D float64 (n, na)) as numpy arrays."""
    n = enc.n
    dev = enc.device
    J = torch.arange(n, device=dev)
    D = torch.zeros((na, n), dtype=torch.int32, device=dev)
    A = torch.zeros(na, dtype=torch.int64, device=dev)
    ix = torch.tensor(int(first_ix), dtype=torch.int64, device=dev)
    for i in range(na):
        col = myers_pairs(enc, ix.expand(n), J)
        D[i] = col
        A[i] = ix
        if i == 0:
            ix = torch.argmax(col)
        else:
            ix = torch.argmax(D[1 : i + 1].amin(dim=0))
    return A.cpu().numpy(), D.cpu().numpy().astype(np.float64).T
