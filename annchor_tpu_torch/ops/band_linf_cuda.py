"""Wrapper of the hand-written CUDA band score (K9a).

The kernel, ``csrc/band_linf.cu``, replaces the "linf" branch of the JAX
package's XLA program ``_band_score`` inside ``_band_bins_sym`` and
``_band_keep2_dense`` (``annchor_tpu/ops/locality.py``): the budgeted
band build's triangle lower bound max_k |Db[i,k] - Dc[j,k]| of a row band
against a block of columns, fused with the candidate filter (shared
near-anchor count >= min(eff_i, eff_j), the diagonal or the upper
triangle, real columns only) and either pass 1's per-row histogram of
the admitted pairs' bins ("hist", which replaces the JAX package's
(B, C) int16 bins and their bisection) or pass 2's threshold keep
("keep").  Its plain PyTorch versions are
``locality._band_hist_sym_plain`` and ``locality._band_keep2_plain``;
the dispatch points ``locality._band_hist_sym`` and
``locality._band_keep2_dense`` launch it for CUDA tensors under the
"linf" score.  One launch a call on PyTorch's current stream, no host
sync.

Each side of the product is handed over as ``operands(D, S)``: its
anchor distances transposed (k-major, so the kernel's slab loads are
contiguous) and its near-anchor membership packed into ceil(na / 32)
32-bit words a point.  The build makes the columns' operands once and
the band rows' per band.
"""

from __future__ import annotations

import ctypes

import torch

from annchor_tpu_torch._backend import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# DbT, ldb, DcT, ldc, na, Pb, Pc, W, eb, ec, B, C, row_off, nx
_COMMON = [_P, _L, _P, _L, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I]
K9A = Kernel(
    "band_linf",
    "band_linf.cu",
    {
        "annchor_k9a_hist": _COMMON + [_P, _I, _P, _P],
        "annchor_k9a_keep": _COMMON + [_P, _P, _P, _P],
    },
    modes=("hist", "keep"),
)

_INT_MAX = (1 << 31) - 1


def pack_bits(S):
    """int32 (n, ceil(na / 32)): bit k % 32 of word k // 32 of row p is
    set iff S[p, k] is non-zero.  The popcount of the AND of two rows is
    their shared near-anchor count (``features.shared_anchor_counts``)."""
    n, na = S.shape
    W = max(1, -(-na // 32))
    bits = torch.zeros((n, W * 32), dtype=torch.int64, device=S.device)
    bits[:, :na] = S != 0
    weights = torch.ones(32, dtype=torch.int64, device=S.device) << torch.arange(
        32, device=S.device)
    words = (bits.view(n, W, 32) * weights).sum(dim=2)
    # the unsigned word's bits as an int32
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def operands(D, S):
    """One side's operands: (D transposed, contiguous (na, n) float32,
    the packed bits of S (n, W) int32)."""
    return D.t().contiguous(), pack_bits(S)


def _check(name, t, dtype, device, shape=None, strided=False):
    """Device, dtype and shape; contiguous, or with ``strided`` (a
    distance matrix, read with its row stride) contiguous rows."""
    if t.dtype != dtype:
        raise ValueError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError("%s has shape %s, expected %s" % (name, tuple(t.shape), shape))
    if not (t.dim() == 2 and t.stride(1) == 1 if strided else t.is_contiguous()):
        raise ValueError("%s must be %s" % (name, "contiguous along its rows" if strided
                                             else "contiguous"))
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))


def _args(rows, eb, cols, ec, row_off: int, nx: int):
    """The launch's shared arguments after checking both sides (all on
    one device; ``_launch`` requires a card)."""
    if cols is None:
        raise ValueError("K9a needs the columns' operands: pass "
                         "cols=band_linf_cuda.operands(D32p, Sp), made once per build")
    DbT, Pb = rows
    DcT, Pc = cols
    dev = DbT.device
    if DbT.dim() != 2:
        raise ValueError("the rows' distances must be 2-d (na, B)")
    na, B = DbT.shape
    C = DcT.shape[1]
    W = max(1, -(-na // 32))
    _check("the rows' distances", DbT, torch.float32, dev, strided=True)
    _check("the columns' distances", DcT, torch.float32, dev, (na, C), strided=True)
    _check("the rows' bits", Pb, torch.int32, dev, (B, W))
    _check("the columns' bits", Pc, torch.int32, dev, (C, W))
    _check("eb", eb, torch.float32, dev, (B,))
    _check("ec", ec, torch.float32, dev, (C,))
    if na < 1 or B > _INT_MAX or C > _INT_MAX:
        raise ValueError("K9a needs at least one anchor and fewer than 2^31 rows and columns")
    out = (DbT.data_ptr(), DbT.stride(0), DcT.data_ptr(), DcT.stride(0), na,
           Pb.data_ptr(), Pc.data_ptr(), W, eb.data_ptr(), ec.data_ptr(), B, C,
           int(row_off), int(nx))
    return dev, B, C, out


def _launch(fn, mode, dev, args):
    """Launch ``fn`` on checked arguments and count it."""
    if dev.type != "cuda":
        raise ValueError("K9a takes tensors on a card, got %s" % dev)
    lib = K9A.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, fn)(*args, stream)
    K9A.count(mode)
    K9A.check(fn, code)


def band_hist(rows, eb, cols, ec, row_off: int, nx: int, inv_bin, nbins: int):
    """Pass 1: int32 (B, nbins), row i's count of admitted pairs in each
    bin of the score (the symmetric view: every column but the row's
    own).  ``rows``, ``cols``: ``operands`` of each side; eb, ec: their
    effective thresholds; row_off: the point id of the first row (column
    j is point j); inv_bin: a 0-d float32 tensor on the card."""
    dev, B, C, args = _args(rows, eb, cols, ec, row_off, nx)
    _check("inv_bin", inv_bin, torch.float32, dev, ())
    if not 0 < nbins < 1 << 15:
        raise ValueError("nbins %d does not fit the plain version's int16 bins" % nbins)
    out = torch.zeros((B, nbins), dtype=torch.int32, device=dev)
    _launch("annchor_k9a_hist", "hist", dev,
            (*args, inv_bin.data_ptr(), int(nbins), out.data_ptr()))
    return out


def band_keep(rows, eb, tb, cols, ec, tc, row_off: int, nx: int):
    """Pass 2: bool (B, C), True for an admitted pair above the diagonal
    whose score is at most max(tb[i], tc[j]).  Arguments as
    ``band_hist``; tb, tc: the rows' and columns' score thresholds."""
    dev, B, C, args = _args(rows, eb, cols, ec, row_off, nx)
    _check("tb", tb, torch.float32, dev, (B,))
    _check("tc", tc, torch.float32, dev, (C,))
    out = torch.empty((B, C), dtype=torch.bool, device=dev)
    _launch("annchor_k9a_keep", "keep", dev,
            (*args, tb.data_ptr(), tc.data_ptr(), out.data_ptr()))
    return out
