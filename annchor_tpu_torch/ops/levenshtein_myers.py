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
to ``myers_pairs_plain``, the same recurrence written in PyTorch.  The
exact oracles ``myers_knn`` and ``myers_rows`` (``exact.py``) evaluate a
block of sources against every column as one ``myers_pairs`` call.

Over more than ``MAX_ALPHABET`` distinct symbols ``MyersEncoding.from_codes``
gives a ``RowDPEncoding`` instead, and ``myers_pairs`` (so the max-min
loop and the oracles too) runs the row DP (K10, ``ops/levenshtein.py``).

``from_codes`` builds the tables in host numpy (``encode_alphabet``,
``build_peq``) and uploads them; ``MyersEncoding.on_device`` builds the
same tables bit for bit with torch ops on the encoding's device from the
strings' code points, which is what the metric engine does on a card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from annchor_tpu_torch.ops.levenshtein import (
    RowDPEncoding,
    bulk_and_max,
    encode_sequences,
    joined_codes,
    pad_codes,
    rowdp_pairs,
    upload_int32,
)
from annchor_tpu_torch.ops.pairs import row_smallest_k
from annchor_tpu_torch.progress import progress

UINT1 = np.uint32(1)

# Peq tables past this many distinct symbols are the row-DP kernel's
# domain (K10)
MAX_ALPHABET = 192

_MASK = 0xFFFFFFFF  # a 32-bit word held in an int64 lane

# pairs per myers_pairs call of the exact oracles: a block of sources
# times its columns, capped so the (I, J) id tensors stay near 128 MB
EXACT_BLOCK_PAIRS = 1 << 23


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
    int32 bit patterns (CPU PyTorch has no uint32 bit operations).
    ``wmax`` is the greatest string's word count and ``wbulk`` the word
    count that ``BULK_PERCENT`` % of the strings do not exceed, both kept
    on the host so that a kernel's launch plan needs no read from the
    device: the plan sizes its main launch for ``wbulk`` and leaves the
    pairs of two longer strings to an overflow launch."""

    __slots__ = ("ids", "lengths", "peq", "alphabet", "W", "wmax", "wbulk")

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
        self.wbulk, self.wmax = bulk_and_max((np.asarray(lengths, dtype=np.int64) + 31) // 32)

    @property
    def device(self) -> torch.device:
        return self.peq.device

    @property
    def n(self) -> int:
        return int(self.peq.shape[0])

    def to(self, device) -> "MyersEncoding":
        """A copy of the tables on ``device`` (a mesh shard's)."""
        out = object.__new__(MyersEncoding)
        for name in self.__slots__:
            v = getattr(self, name)
            setattr(out, name, v.to(device) if isinstance(v, torch.Tensor) else v)
        return out

    @classmethod
    def from_codes(cls, codes, lengths, device):
        """The encoding of a padded codepoint matrix: a MyersEncoding, or
        over more than ``MAX_ALPHABET`` distinct symbols a
        ``RowDPEncoding`` of the codepoints (the JAX package's encoder
        returns None there and its engine falls back to the row DP)."""
        enc = encode_alphabet(codes, lengths)
        if enc is None:
            return RowDPEncoding(codes, lengths, device)
        ids, alphabet = enc
        peq = build_peq(ids, lengths, alphabet)
        return cls(ids, lengths, peq, alphabet, device)

    @classmethod
    def on_device(cls, X, device):
        """``from_codes`` of ``encode_strings(X)`` (``encode_sequences``
        for sequences of integers), bit for bit, built by torch ops on
        ``device``.  The host only takes the code points: those of strings
        in one join (``joined_codes``), padded on the device
        (``pad_codes``); of other sequences their padded host matrix.

        The alphabet is ``torch.unique`` of the codes with -1 put first
        (a negative code is a pad, as in ``encode_alphabet``); its size
        is the build's one read from the device, and past ``MAX_ALPHABET``
        the codes go to a ``RowDPEncoding`` as they are.  A code's id is
        its rank among the symbols (``searchsorted``: every code is in
        the alphabet, so the rank is the lookup table's id).  Each
        character adds its bit into its Peq word in one ``index_add_``
        over int32 words: the bits of a word are distinct powers of two
        (bit 31 as -2^31), so every partial sum is in range and the sum
        is their OR."""
        dev = torch.device(device)
        seq = list(X)
        if len(seq) and not isinstance(seq[0], str):
            codes, lengths = encode_sequences(seq)
            codes = upload_int32(codes, dev)
        else:
            flat, lengths = joined_codes(seq)
            codes = pad_codes(upload_int32(flat, dev), lengths)
        n, L = codes.shape
        alpha = torch.unique(torch.cat([codes.reshape(-1).clamp(min=-1),
                                        codes.new_full((1,), -1)]))
        alphabet = alpha.numel() - 1
        if alphabet > MAX_ALPHABET:
            return RowDPEncoding(codes, lengths, dev)
        ids = torch.searchsorted(alpha, codes, out_int32=True).sub_(1)
        W = (L + 31) // 32
        peq = torch.zeros(n * alphabet * W, dtype=torch.int32, device=dev)
        if peq.numel():
            pos = torch.arange(L, device=dev)
            bit = torch.where((pos & 31) == 31, -(1 << 31), 1 << (pos & 31)).to(torch.int32)
            at = ids.clamp(min=0).long()
            at += torch.arange(0, n * alphabet, alphabet, device=dev)[:, None]
            at *= W
            at += pos >> 5
            peq.index_add_(0, at.view(-1), torch.where(ids >= 0, bit, 0).view(-1))
        out = object.__new__(cls)
        out.ids = ids
        out.lengths = upload_int32(lengths, dev)
        out.peq = peq.view(n, alphabet, W)
        out.alphabet = alphabet
        out.W = W
        out.wbulk, out.wmax = bulk_and_max((np.asarray(lengths, dtype=np.int64) + 31) // 32)
        return out


def myers_pairs(enc: MyersEncoding, I, J):
    """Edit distances of the pairs (I[k], J[k]) as an int32 tensor.

    I and J are integer tensors on the encoding's device.  A CUDA
    device launches the hand-written kernel; the plain PyTorch version
    runs only for tensors on the CPU.  A ``RowDPEncoding`` runs the row
    DP (``rowdp_pairs``) the same way."""
    if isinstance(enc, RowDPEncoding):
        return rowdp_pairs(enc, I, J)
    if I.device != enc.device or J.device != enc.device:
        raise ValueError(
            "pair ids on %s/%s, encoding on %s"
            % (I.device, J.device, enc.device)
        )
    if enc.device.type == "cuda":
        from annchor_tpu_torch.ops.levenshtein_cuda import myers_pairs_cuda

        return myers_pairs_cuda(enc.peq, enc.ids, enc.lengths, I, J,
                                wmax=enc.wmax, wbulk=enc.wbulk)
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


def _source_blocks(rows, n_keep: int, block: int):
    """Slices of ``rows`` of at most ``block`` sources and at most
    EXACT_BLOCK_PAIRS pairs against ``n_keep`` columns each."""
    step = max(1, min(int(block), EXACT_BLOCK_PAIRS // max(int(n_keep), 1)))
    return [rows[s : s + step] for s in range(0, rows.shape[0], step)]


def _block_columns(enc: MyersEncoding, blk, n_keep: int):
    """Edit distances int32 (S, n_keep) from the sources ``blk`` to the
    first ``n_keep`` strings of the encoding, as one pair batch."""
    dev = enc.device
    src = torch.as_tensor(np.asarray(blk, dtype=np.int64), device=dev)
    cols = torch.arange(n_keep, device=dev)
    d = myers_pairs(enc, src.repeat_interleave(n_keep), cols.repeat(src.shape[0]))
    return d.view(src.shape[0], n_keep)


def myers_knn(enc: MyersEncoding, k: int, rows=None, block: int = 64,
              n_keep=None, verbose: bool = False):
    """Exact k smallest edit distances per source row, blocked one-vs-all
    (the JAX package's ``myers_knn``).

    Each block of ``block`` sources runs as one pair batch against the
    first ``n_keep`` strings (default: all), then a stable top-k on the
    device (ties by the lower column, as ``lax.top_k``), so only
    (block, k) comes back to the host and nothing O(n^2) is resident.
    ``rows=None`` means every string.  Returns (idx int64 (R, k), dist
    float64 (R, k)), ascending."""
    n = enc.n
    n_keep = n if n_keep is None else int(n_keep)
    rows = np.arange(n, dtype=np.int64) if rows is None else np.asarray(rows, dtype=np.int64)
    idx_out = np.empty((rows.shape[0], k), dtype=np.int64)
    dist_out = np.empty((rows.shape[0], k), dtype=np.float64)
    s = 0
    for blk in progress(_source_blocks(rows, n_keep, block), "exact rows", verbose):
        dist, idx = row_smallest_k(_block_columns(enc, blk, n_keep), k)
        dist_out[s : s + blk.shape[0]] = dist.cpu().numpy()
        idx_out[s : s + blk.shape[0]] = idx.cpu().numpy()
        s += blk.shape[0]
    return idx_out, dist_out


def myers_rows(enc: MyersEncoding, rows, block: int = 64, n_keep=None,
               verbose: bool = False):
    """Full exact distance rows float64 (R, n_keep) for the given sources
    (the JAX package's ``myers_rows``)."""
    n_keep = enc.n if n_keep is None else int(n_keep)
    rows = np.asarray(rows, dtype=np.int64)
    out = np.empty((rows.shape[0], n_keep), dtype=np.float64)
    s = 0
    for blk in progress(_source_blocks(rows, n_keep, block), "exact rows", verbose):
        out[s : s + blk.shape[0]] = _block_columns(enc, blk, n_keep).cpu().numpy()
        s += blk.shape[0]
    return out
