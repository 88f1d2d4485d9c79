"""String encoding, the edit distance over large alphabets and the
scalar oracle.

The encoders are copied from the JAX package's ``ops/levenshtein.py``
(backend-neutral numpy): strings become a padded codepoint matrix that
the bit-parallel kernel's encoder (``ops/levenshtein_myers.py``) maps to
dense alphabet ids.  ``joined_codes`` takes the code points of all the
strings in one join and ``pad_codes`` lays them out as the same padded
matrix on a device.

Over more than ``MAX_ALPHABET`` (192) distinct symbols the dense Peq
tables are not built; the strings keep their codepoints in a
``RowDPEncoding`` with a sparse Peq table, each string's rows of only
the symbols it contains.  ``rowdp_pairs`` sends CUDA tensors to the
hand-written kernel K10 (``csrc/levenshtein_rowdp.cu`` through
``ops/levenshtein_rowdp_cuda.py``: the bit-parallel word step over that
table) and CPU tensors to ``lev_pairs_plain``, the JAX package's
``_lev_batch`` row dynamic programme in PyTorch.
``sparse_myers_pairs_plain`` runs K10's table, search and word step on
the CPU for the tests.  ``levenshtein_scalar`` is the pure-Python
dynamic programme, the independent oracle the kernels are held against.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from annchor_tpu_torch._backend import round_up


def encode_strings(strings, pad_to_multiple: int = 128):
    """Encode a sequence of unicode strings to a padded codepoint matrix.

    Returns
    -------
    codes: np.ndarray int32, shape (n, L)
        Unicode codepoints, padded with -1.  L is the maximum string
        length rounded up to ``pad_to_multiple``.
    lengths: np.ndarray int32, shape (n,)
    """
    n = len(strings)
    lengths = np.array([len(s) for s in strings], dtype=np.int32)
    L = round_up(max(int(lengths.max()), 1), pad_to_multiple)
    codes = np.full((n, L), -1, dtype=np.int32)
    for k, s in enumerate(strings):
        if len(s):
            codes[k, : len(s)] = np.frombuffer(
                s.encode("utf-32-le"), dtype=np.uint32
            ).astype(np.int32)
    return codes, lengths


def encode_sequences(seqs, pad_to_multiple: int = 128):
    """Encode arbitrary integer sequences (lists/arrays) like strings."""
    n = len(seqs)
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    L = round_up(max(int(lengths.max()), 1), pad_to_multiple)
    codes = np.full((n, L), -1, dtype=np.int32)
    for k, s in enumerate(seqs):
        codes[k, : len(s)] = np.asarray(s, dtype=np.int32)
    return codes, lengths


def joined_codes(strings):
    """The code points of ``strings`` end to end, int32 (sum of the
    lengths,), from one join and one encode, and the lengths int32 (n,):
    ``encode_strings``'s matrix row by row with its pads left out."""
    lengths = np.fromiter(map(len, strings), dtype=np.int32, count=len(strings))
    flat = np.frombuffer("".join(strings).encode("utf-32-le"), dtype=np.int32)
    return flat, lengths


def upload_int32(a, device):
    """A host array as int32 on ``device``, copied once: to a card through
    pinned memory, so the copy does not wait for the card."""
    dev = torch.device(device)
    t = torch.empty(np.shape(a), dtype=torch.int32, pin_memory=dev.type == "cuda")
    t.numpy()[...] = a
    return t.to(dev, non_blocking=True)


def pad_codes(flat, lengths, pad_to_multiple: int = 128):
    """``encode_strings``'s padded matrix (n, L) int32, -1 pads, built on
    the device of ``flat`` (``joined_codes``' code points as a tensor)
    from the host's ``lengths``: a gather, with no read from the device."""
    dev = flat.device
    n = len(lengths)
    L = round_up(max(int(lengths.max()), 1), pad_to_multiple)
    if not flat.numel():
        return torch.full((n, L), -1, dtype=torch.int32, device=dev)
    lens = upload_int32(lengths, dev).long()
    pos = torch.arange(L, device=dev)
    src = (torch.cumsum(lens, 0) - lens)[:, None] + pos
    return torch.where(pos < lens[:, None], flat[src.clamp_(max=flat.numel() - 1)], -1)


def levenshtein_scalar(x, y) -> int:
    """Edit distance by the textbook row DP in pure Python."""
    la, lb = len(x), len(y)
    if la == 0:
        return lb
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cur[j] = min(
                prev[j] + 1,
                cur[j - 1] + 1,
                prev[j - 1] + (x[i - 1] != y[j - 1]),
            )
        prev = cur
    return prev[lb]


# the share of a dataset's strings (in percent) that the main launch of
# K1 and of K10 is sized for; a pair of two strings from the longest rest
# overflows
BULK_PERCENT = 99
# the sparse Peq table's build holds about this many bytes per table
# word on its device at once (the int64 sums, the int32 table)
_TABLE_BUILD_BYTES = 12


def bulk_and_max(values):
    """(the value that ``BULK_PERCENT`` % of ``values`` do not exceed,
    the largest), both 0 for none: the host's sizes of a launch plan."""
    v = np.sort(np.asarray(values, dtype=np.int64))
    if not v.size:
        return 0, 0
    return int(v[-(-v.size * BULK_PERCENT // 100) - 1]), int(v[-1])


class RowDPEncoding:
    """Per-dataset tables of the edit distance over more than
    ``MAX_ALPHABET`` symbols on one device.

    ``ids`` (n, L) int32 code points, -1 past each string's end, and
    ``lengths`` (n,) int32, as the row DP reads them; and the sparse Peq
    table of K10 (``csrc/levenshtein_rowdp.cu``), which holds for each
    string s only the rows of the symbols it contains:

    - ``sym``: int32, s's distinct code points ascending at
      ``sym[soff[s]:soff[s+1]]`` (``soff`` int64 (n+1));
    - ``mask``: 32-bit words held as int32 (CPU PyTorch has no uint32
      bit operations); word w of the position mask of s's r-th symbol is
      ``mask[moff[s] + r * Wp + w]`` (``moff`` int64 (n+1)), bit k set iff
      character 32w + k of s is that symbol, with W = ceil(len / 32) and
      rows Wp = W rounded up to 4 words apart, so that every row starts
      on 16 bytes.

    Kept on the host, so that a launch plan needs no read from the
    device: ``lmax``, the longest string's length; ``wmax`` and
    ``wbulk``, the largest word count and the one ``BULK_PERCENT`` % of
    the strings do not exceed (as ``MyersEncoding``); ``tbulk``, the same
    for a string's table words, n_s x (Wp + 1) with n_s its symbols.
    The table is built with torch on the device; its size is computed on
    the host first, and a table that does not fit the card raises."""

    __slots__ = ("ids", "lengths", "lmax", "sym", "soff", "mask", "moff",
                 "wmax", "wbulk", "tbulk")

    def __init__(self, codes, lengths, device):
        dev = torch.device(device)
        lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        self.ids = torch.as_tensor(codes, dtype=torch.int32, device=dev).contiguous()
        self.lengths = torch.from_numpy(lengths).to(dev)
        self.lmax = int(np.max(lengths)) if len(lengths) else 0
        words = (lengths.astype(np.int64) + 31) // 32
        self.wbulk, self.wmax = bulk_and_max(words)
        self.sym, self.soff, self.mask, self.moff, nsym = sparse_peq(
            self.ids, self.lengths, words)
        self.tbulk = bulk_and_max(nsym * (round_up_words(words) + 1))[0]

    @property
    def device(self) -> torch.device:
        return self.ids.device

    @property
    def n(self) -> int:
        return int(self.ids.shape[0])

    def to(self, device) -> "RowDPEncoding":
        """A copy of the tables on ``device`` (a mesh shard's)."""
        out = object.__new__(RowDPEncoding)
        for name in self.__slots__:
            v = getattr(self, name)
            setattr(out, name, v.to(device) if isinstance(v, torch.Tensor) else v)
        return out


def round_up_words(words):
    """Row widths of the sparse table: word counts rounded up to 4."""
    return (np.asarray(words, dtype=np.int64) + 3) // 4 * 4


def sparse_peq(ids, lengths, words):
    """The sparse Peq table of the strings ``ids`` (n, L) int32 code points
    of ``lengths`` (n,) on their device, whose word counts ``words``
    (numpy, ceil(len / 32)) the host knows.  Returns (sym, soff, mask,
    moff) as ``RowDPEncoding`` holds them and each string's symbol count
    (numpy int64 (n,)).

    The characters are sorted stably on the key (string, code point);
    ``unique_consecutive`` makes one slot per distinct symbol of a
    string; each character adds its bit, a distinct power of two within
    its word, so ``scatter_add`` over int64 words equals the OR.  The
    key's low half is the code point plus 2^31, so a string's symbols
    come out in signed int32 order, the order the kernel searches."""
    dev = ids.device
    n, L = ids.shape
    pos = torch.arange(L, device=dev)
    rows, cols = (pos[None, :] < lengths[:, None].long()).nonzero(as_tuple=True)
    key = (rows << 32) | (ids[rows, cols].long() + (1 << 31))
    key, order = torch.sort(key, stable=True)
    slots, slot = torch.unique_consecutive(key, return_inverse=True)
    sym = ((slots & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)
    counts = torch.bincount(slots >> 32, minlength=n)
    soff = F.pad(torch.cumsum(counts, 0), (1, 0))
    # the table's size, on the host, before it is allocated
    nsym = counts.cpu().numpy().astype(np.int64)
    wp = round_up_words(words)
    moff_h = np.concatenate([[0], np.cumsum(nsym * wp)]).astype(np.int64)
    total = int(moff_h[-1])
    if dev.type == "cuda":
        need = total * _TABLE_BUILD_BYTES
        free = torch.cuda.mem_get_info(dev)[0]
        if need > free:
            raise MemoryError(
                "the sparse Peq table of %d strings needs %d words (%.3f GB to build), "
                "%.3f GB free on %s" % (n, total, need / 1e9, free / 1e9, dev))
    moff = torch.from_numpy(moff_h).to(dev)
    r = rows[order]
    c = cols[order]
    at = moff[r] + (slot - soff[r]) * torch.from_numpy(wp).to(dev)[r] + (c >> 5)
    acc = torch.zeros(total, dtype=torch.int64, device=dev)
    acc.scatter_add_(0, at, torch.ones_like(c) << (c & 31))
    mask = torch.where(acc >= 1 << 31, acc - (1 << 32), acc).to(torch.int32)
    return sym, soff, mask, moff, nsym


def rowdp_pairs(enc: RowDPEncoding, I, J):
    """Edit distances of the pairs (I[k], J[k]) as an int32 tensor.  I and
    J are integer tensors on the encoding's device: a CUDA device launches
    the hand-written kernel (K10, bit-parallel over the sparse table), and
    the plain version, the row DP, runs only for tensors on the CPU."""
    if I.device != enc.device or J.device != enc.device:
        raise ValueError(
            "pair ids on %s/%s, encoding on %s" % (I.device, J.device, enc.device)
        )
    if enc.device.type == "cuda":
        from annchor_tpu_torch.ops.levenshtein_rowdp_cuda import rowdp_pairs_cuda

        return rowdp_pairs_cuda(enc, I, J)
    if enc.device.type == "cpu":
        return lev_pairs_plain(enc, I, J)
    raise NotImplementedError("no edit-distance kernel for %s" % enc.device)


def lev_pairs_plain(enc: RowDPEncoding, I, J, chunk: int = 1 << 13):
    """The plain PyTorch version of K10, the JAX package's ``_lev_batch``:
    each pair's rows walk its shorter string a, and a row of the DP over
    the longer string b is

        t_j    = min(D[i-1, j] + 1, D[i-1, j-1] + [a_i != b_j])   (t_0 = i)
        D[i,j] = j + cummin_{k <= j}(t_k - k),

    one ``torch.cummin`` per row, over ``chunk`` pairs at a time.
    Returns int32 (B,)."""
    I = I.long()
    J = J.long()
    la = enc.lengths[I].long()
    lb = enc.lengths[J].long()
    swap = la > lb
    A = torch.where(swap, J, I)
    Bx = torch.where(swap, I, J)
    la, lb = torch.minimum(la, lb), torch.maximum(la, lb)
    out = torch.empty(I.shape[0], dtype=torch.int32, device=I.device)
    for s in range(0, I.shape[0], chunk):
        out[s : s + chunk] = _rowdp_block(
            enc.ids, A[s : s + chunk], Bx[s : s + chunk], la[s : s + chunk],
            lb[s : s + chunk],
        )
    return out


def _rowdp_block(ids, A, Bx, la, lb):
    nb = int(lb.max()) if lb.numel() else 0
    a = ids[A]
    b = ids[Bx][:, :nb]
    cols = torch.arange(nb + 1, dtype=torch.int64, device=ids.device)
    prev = cols.expand(A.shape[0], nb + 1)
    result = lb.clone()  # an empty a gives lb
    for i in range(1, (int(la.max()) if la.numel() else 0) + 1):
        cost = (a[:, i - 1 : i] != b).long()
        t = torch.minimum(prev[:, 1:] + 1, prev[:, :-1] + cost)
        t = torch.cat([torch.full_like(t[:, :1], i), t], dim=1)
        prev = torch.cummin(t - cols, dim=1).values + cols
        result = torch.where(la == i, prev.gather(1, lb[:, None])[:, 0], result)
    return result.to(torch.int32)


def sparse_myers_pairs_plain(enc: RowDPEncoding, I, J, chunk: int = 1 << 16):
    """Test-only twin of K10 on the CPU: the bit-parallel recurrence of
    ``myers_pairs_plain`` (32-bit words in int64 lanes), each text
    character's Eq row found in the pattern's part of the sparse table
    by the kernel's search (``find_rows``), the zero row where the
    pattern lacks the symbol.  A string against itself gives 0 with no
    work, as in the kernel.  Returns int32 (B,)."""
    from annchor_tpu_torch.ops.levenshtein_myers import _MASK

    I = I.long()
    J = J.long()
    lengths = enc.lengths.long()
    la0 = lengths[I]
    lb0 = lengths[J]
    swap = la0 > lb0
    P = torch.where(swap, J, I)
    T = torch.where(swap, I, J)
    same = I == J
    la = torch.where(same, 0, torch.minimum(la0, lb0))
    lb = torch.where(same, 0, torch.maximum(la0, lb0))
    out = torch.empty(I.shape[0], dtype=torch.int32, device=I.device)
    # one zero word past each table, so a clamped gather of a missing
    # entry reads a defined value
    sym = F.pad(enc.sym.long(), (0, 1))
    mask = F.pad(enc.mask.long() & _MASK, (0, 1))
    for s in range(0, I.shape[0], chunk):
        e = s + chunk
        out[s:e] = _sparse_block(enc, sym, mask, P[s:e], T[s:e], la[s:e], lb[s:e])
    return out


def find_rows(sym, base, n, c):
    """The kernel's search, vectorised: the row of symbol c[k] among the
    n[k] ascending symbols sym[base[k]:base[k] + n[k]], or -1.  Halve
    [lo, lo + len) on sym[lo + len // 2] <= c, then compare the one
    candidate left.  ``sym`` holds one spare entry at its end."""
    last = sym.shape[0] - 1
    lo = torch.zeros_like(n)
    ln = n.clone()
    for _ in range(int(n.max()).bit_length() if n.numel() else 0):
        half = ln >> 1
        probe = sym[(base + lo + half).clamp(max=last)]
        lo = lo + torch.where((ln > 1) & (probe <= c), half, 0)
        ln = torch.where(ln > 1, ln - half, ln)
    hit = (ln == 1) & (sym[(base + lo).clamp(max=last)] == c)
    return torch.where(hit, lo, -1)


def _sparse_block(enc, sym, mask, P, T, la, lb):
    from annchor_tpu_torch.ops.levenshtein_myers import _MASK, _add_with_carry, _shift1

    dev = P.device
    L = int(enc.ids.shape[1])
    W = max(1, (int(la.max()) + 31) // 32) if la.numel() else 1
    wr = torch.arange(W, device=dev)
    nbits = (la[:, None] - 32 * wr).clamp(0, 32)
    one = torch.ones_like(nbits)
    VP = torch.where(nbits >= 32, _MASK, (one << nbits) - 1)
    VN = torch.zeros_like(VP)
    m1 = (la - 1).clamp(min=0)
    tap = torch.where(wr[None, :] == (m1 >> 5)[:, None], one[:, :1] << (m1 & 31)[:, None], 0)
    score = la.clone()
    base = enc.soff[P]
    n = torch.where(la > 0, enc.soff[P + 1] - base, 0)
    wp = ((la + 31) // 32 + 3) // 4 * 4
    rows0 = enc.moff[P]
    last = mask.shape[0] - 1
    ids_flat = enc.ids.reshape(-1)
    for j in range(int(lb.max()) if lb.numel() else 0):
        c = ids_flat[T * L + min(j, L - 1)].long()
        row = find_rows(sym, base, n, c)
        at = (rows0 + row.clamp(min=0) * wp)[:, None] + wr
        Eq = torch.where((row >= 0)[:, None] & (wr[None, :] < wp[:, None]),
                         mask[at.clamp(max=last)], 0)
        D0 = (_add_with_carry(Eq & VP, VP) ^ VP) | Eq | VN
        HP = VN | (~(D0 | VP) & _MASK)
        HN = VP & D0
        inc = ((HP & tap) != 0).any(1).long() - ((HN & tap) != 0).any(1).long()
        score += torch.where(j < lb, inc, 0)
        X = _shift1(HP, 1)
        VP = _shift1(HN, 0) | (~(D0 | X) & _MASK)
        VN = X & D0
    return torch.where(la == 0, lb, score).to(torch.int32)
