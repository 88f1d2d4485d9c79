"""String encoding, the row-DP edit distance and the scalar oracle.

The encoders are copied from the JAX package's ``ops/levenshtein.py``
(backend-neutral numpy): strings become a padded codepoint matrix that
the bit-parallel kernel's encoder (``ops/levenshtein_myers.py``) maps to
dense alphabet ids.

Over more than ``MAX_ALPHABET`` (192) distinct symbols the bit-parallel
tables are not built; the strings keep their codepoints in a
``RowDPEncoding`` and every pair runs the row dynamic programme (K10):
``rowdp_pairs`` sends CUDA tensors to the hand-written kernel
(``csrc/levenshtein_rowdp.cu`` through ``ops/levenshtein_rowdp_cuda.py``)
and CPU tensors to ``lev_pairs_plain``, the JAX package's ``_lev_batch``
recurrence in PyTorch.  ``levenshtein_scalar`` is the pure-Python dynamic
programme, the independent oracle the kernels are held against.
"""

from __future__ import annotations

import numpy as np
import torch

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


class RowDPEncoding:
    """Per-dataset tables of the row-DP edit distance on one device:
    ``ids`` (n, L) int32 codepoints, -1 past each string's end, and
    ``lengths`` (n,) int32; ``lmax``, the longest string's length, is
    kept on the host so that the kernel's scratch is sized without a
    read from the device."""

    __slots__ = ("ids", "lengths", "lmax")

    def __init__(self, codes, lengths, device):
        dev = torch.device(device)
        self.ids = torch.from_numpy(np.ascontiguousarray(codes, dtype=np.int32)).to(dev)
        self.lengths = torch.from_numpy(np.ascontiguousarray(lengths, dtype=np.int32)).to(dev)
        self.lmax = int(np.max(lengths)) if len(lengths) else 0

    @property
    def device(self) -> torch.device:
        return self.ids.device

    @property
    def n(self) -> int:
        return int(self.ids.shape[0])

    def to(self, device) -> "RowDPEncoding":
        """A copy of the tables on ``device`` (a mesh shard's)."""
        out = object.__new__(RowDPEncoding)
        out.ids, out.lengths, out.lmax = self.ids.to(device), self.lengths.to(device), self.lmax
        return out


def rowdp_pairs(enc: RowDPEncoding, I, J):
    """Edit distances of the pairs (I[k], J[k]) as an int32 tensor, by the
    row DP.  I and J are integer tensors on the encoding's device: a CUDA
    device launches the hand-written kernel (K10), and the plain version
    runs only for tensors on the CPU."""
    if I.device != enc.device or J.device != enc.device:
        raise ValueError(
            "pair ids on %s/%s, encoding on %s" % (I.device, J.device, enc.device)
        )
    if enc.device.type == "cuda":
        from annchor_tpu_torch.ops.levenshtein_rowdp_cuda import rowdp_pairs_cuda

        return rowdp_pairs_cuda(enc.ids, enc.lengths, I, J, lmax=enc.lmax)
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
