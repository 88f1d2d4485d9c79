"""Wrapper of the hand-written CUDA Sinkhorn loop (K8).

The kernel, ``csrc/sinkhorn.cu``, replaces two XLA programs of the JAX
package's ``annchor_tpu/ops/wasserstein.py``, one launch per chunk of
pairs instead of a few kernels per iteration:

* K8a (mode "exp"), ``_sinkhorn_exp_chunk``: the exp-domain loop of the
  hybrid's scout and its max-min anchors.  Plain PyTorch version
  ``wasserstein.sinkhorn_exp_chunk_plain``; dispatch point
  ``wasserstein.sinkhorn_exp_chunk``.
* K8b (mode "log"), ``_sinkhorn_batch``: the log-domain loop of the
  ``wasserstein_sinkhorn`` metric.  Plain version
  ``wasserstein.sinkhorn_batch_plain``; dispatch point
  ``wasserstein.sinkhorn_batch``.

Each launch goes on PyTorch's current stream; nothing here waits for the
card or reads a value back from it.  ``exp_plan`` and ``log_plan`` are the
launch plans, pure functions of the batch and the bin count;
``exp_chunk_model`` repeats K8a's arithmetic in torch in the kernel's
order of summation.  K8a runs its products on the FP64 tensor cores
(``mma.sync`` m16n8k8 and m16n8k4), the pairs as the mma's rows: one
launch a chunk while K stays in shared memory (``RES_MAX_BINS``), one a
half step beyond.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from annchor_tpu_torch._backend import Kernel, round_up

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

K8 = Kernel(
    "sinkhorn",
    "sinkhorn.cu",
    {
        # Xn, Zn, I, sI, J, sJ, K, KC, B, n, npad, n_iter, tiny, out, stream
        "annchor_k8a_resident": [_P, _P, _P, _L, _P, _L, _P, _P, _I, _I, _I, _I, _F, _P, _P],
        # Xn, Zn, I, sI, J, sJ, K, KC, B, n, npad, Bp, bn, n_iter, tiny, ws,
        # out, stream
        "annchor_k8a_streamed": [_P, _P, _P, _L, _P, _L, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                 _P, _P, _P],
        # A, B, C, m, n, P, G, resident, global_v, eps, inv, n_iter, ws, out,
        # stream
        "annchor_k8b_log": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P, _P, _P],
    },
    modes=("exp", "log"),
)

SMS = 132  # streaming multiprocessors of the H100 SXM
SMEM_MAX = 232_448  # dynamic shared memory a block can have (227 KB)
# K8a resident: 16 pairs a block (one m16 tile), a warp per 8 output
# columns, K, u and v as float64 rows of stride npad + 4 in shared memory;
# the most bins that fit (of the variants tried on the H100, m16n8k8 with
# 8 columns a warp led on the digits at every batch; 32 pairs a block, 16
# columns a warp, m16n8k4 and m16n8k16 were slower)
RES_PAIRS = 16
RES_MAX_BINS = 144
# K8a streamed: a block's tile is 64 pairs by STREAM_COLS[i] columns, the
# widest that gives every SM a block, else the narrowest
STREAM_PAIRS = 64
STREAM_COLS = (64, 32, 16)
STREAM_MAX_TILES = 65_535  # the grid's second dimension: pair tiles
LOG_THREADS = 256  # threads a K8b block at most
_INT_MAX = (1 << 31) - 1


def _res_smem(npad: int) -> int:
    """Bytes of shared memory of a resident K8a block (csrc/sinkhorn.cu
    res_smem): K, u and v as float64 rows of stride npad + 4."""
    return 8 * (npad + 4) * (npad + 2 * RES_PAIRS)


def exp_plan(B: int, n: int, path: str | None = None, cols: int | None = None) -> dict:
    """K8a's launch for B pairs of n-bin histograms, a pure function of
    (B, n); a block's tile is ``P`` pairs by ``cols`` columns.
    "resident" up to ``RES_MAX_BINS`` bins (one launch, 16 pairs a block
    by all npad = n rounded up to 16 columns, a warp per 8), else
    "streamed" (2 n_iter + 4 launches of tiles of 64 pairs by ``cols``
    columns: the widest of ``STREAM_COLS`` that gives every SM a block,
    else 16; npad rounded up to 64, the workspace's rows ``Bp`` to 64).
    ``path`` and ``cols`` force a plan, for the tests and for timing; a
    resident plan past ``RES_MAX_BINS`` raises, and so does a streamed
    plan of more than 64 x 65,535 pairs (a chunk of the engine is
    8,192)."""
    if n < 1 or B < 0:
        raise ValueError("K8a needs n >= 1 bins and B >= 0 pairs, got n %d, B %d" % (n, B))
    if path is None:
        path = "resident" if n <= RES_MAX_BINS else "streamed"
    if path == "resident":
        if n > RES_MAX_BINS:
            raise ValueError("no resident plan at %d bins (at most %d)" % (n, RES_MAX_BINS))
        npad = round_up(n, 16)
        return {"B": B, "n": n, "path": path, "npad": npad, "P": RES_PAIRS, "cols": npad,
                "threads": 4 * npad, "blocks": -(-B // RES_PAIRS), "smem": _res_smem(npad),
                "Bp": 0}
    if path != "streamed":
        raise ValueError("path must be 'resident' or 'streamed', got %r" % (path,))
    npad = round_up(n, STREAM_COLS[0])
    Bp = round_up(max(B, 1), STREAM_PAIRS)
    if Bp // STREAM_PAIRS > STREAM_MAX_TILES:
        raise ValueError("K8a's streamed path takes at most %d pairs a call, got %d"
                         % (STREAM_PAIRS * STREAM_MAX_TILES, B))
    if cols is None:
        cols = next((c for c in STREAM_COLS if npad // c * (Bp // STREAM_PAIRS) >= SMS),
                    STREAM_COLS[-1])
    if cols not in STREAM_COLS:
        raise ValueError("cols must be one of %s, got %r" % (STREAM_COLS, cols))
    return {"B": B, "n": n, "path": path, "npad": npad, "P": STREAM_PAIRS, "cols": cols,
            "threads": 128, "blocks": npad // cols * (Bp // STREAM_PAIRS), "smem": 40_960,
            "Bp": Bp}


def exp_launches(plan: dict, n_iter: int) -> int:
    """CUDA launches of one K8a call under ``plan``."""
    if plan["B"] == 0:
        return 0
    return 1 if plan["path"] == "resident" else 2 * int(n_iter) + 4


def _log_ldc(n: int) -> int:
    """K8b's odd row stride of -C/eps in shared memory."""
    return n + 1 + (n & 1)


def _log_smem(n: int, P: int, G: int, resident: bool, global_v: bool) -> int:
    """Bytes of shared memory of a K8b block (csrc/sinkhorn.cu log_smem):
    -C/eps as (n, ldc) float32 when resident, f/eps, g/eps, log A, log B
    as (P, n) float32 unless they live in global memory, the partial sums
    (P, G) float64."""
    f = n * _log_ldc(n) if resident else 0
    f += 0 if global_v else 4 * P * n
    f += f & 1
    return 4 * f + 8 * P * G


def log_plan(B: int, n: int) -> dict:
    """K8b's launch for B pairs of n-bin histograms: G threads a pair (n
    rounded up to a warp, at most 256), P pairs a block (256 / G, halved
    while that leaves fewer than two blocks an SM, and until the block
    fits shared memory), blocks, shared memory bytes, whether -C/eps is
    resident in it (to 237 bins), and whether the potentials and log
    histograms live in a global workspace (``global_v``, above 14,400
    bins, where one pair's do not fit)."""
    if n < 1 or B < 0:
        raise ValueError("K8b needs n >= 1 bins and B >= 0 pairs, got n %d, B %d" % (n, B))
    G = min(LOG_THREADS, round_up(n, 32))
    P = max(1, LOG_THREADS // G)
    while P > 1 and -(-B // P) < 2 * SMS:
        P //= 2
    global_v = _log_smem(n, 1, G, False, False) > SMEM_MAX
    resident = not global_v and _log_smem(n, 1, G, True, False) <= SMEM_MAX
    while P > 1 and _log_smem(n, P, G, resident, global_v) > SMEM_MAX:
        P //= 2
    return {"B": B, "n": n, "G": G, "P": P, "threads": G * P, "blocks": -(-B // P),
            "smem": _log_smem(n, P, G, resident, global_v), "resident": resident,
            "global_v": global_v}


def _check(name, t, dtype, shape=None, dim=None):
    if not isinstance(t, torch.Tensor):
        raise ValueError("%s must be a tensor, got %s" % (name, type(t).__name__))
    if t.dtype != dtype:
        raise ValueError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if dim is not None and t.dim() != dim:
        raise ValueError("%s must be %d-d, got shape %s" % (name, dim, tuple(t.shape)))
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError("%s has shape %s, expected %s" % (name, tuple(t.shape), tuple(shape)))


def _launch(fn, mode, dev, args, launches=1):
    if dev.type != "cuda":
        raise ValueError("K8 takes tensors on a card, got %s" % dev)
    lib = K8.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, fn)(*args, stream)
    K8.count(mode, launches)
    K8.check(fn, code)


def sinkhorn_exp_cuda(Xn, Zn, I, J, K64, KC64, n_iter: int, tiny: float, _plan=None):
    """K8a: the exp-domain Sinkhorn cost of the pairs (Xn[I[k]], Zn[J[k]]),
    float32 (B,) on the card: one launch while K fits shared memory,
    ``exp_launches`` beyond.

    Xn (nX, n), Zn (nZ, n): contiguous float32 histograms; I, J: int64
    (B,) row ids in range, any stride (``expand`` of one id is fine);
    K64, KC64: contiguous (n, n) float64 (K = exp(-C/eps), KC = K * C);
    tiny: the clamp's float32 floor.  ``_plan``, an ``exp_plan`` of these
    B and n, forces a path (for the tests and timing).  Nothing here waits
    for the card."""
    _check("Xn", Xn, torch.float32, dim=2)
    n = int(Xn.shape[1])
    _check("Zn", Zn, torch.float32, dim=2)
    if Zn.shape[1] != n:
        raise ValueError("Zn has %d bins, Xn %d" % (Zn.shape[1], n))
    _check("I", I, torch.int64, dim=1)
    B = int(I.shape[0])
    _check("J", J, torch.int64, (B,))
    _check("K64", K64, torch.float64, (n, n))
    _check("KC64", KC64, torch.float64, (n, n))
    for name, t in (("Xn", Xn), ("Zn", Zn), ("K64", K64), ("KC64", KC64)):
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    dev = Xn.device
    for name, t in (("Zn", Zn), ("I", I), ("J", J), ("K64", K64), ("KC64", KC64)):
        if t.device != dev:
            raise ValueError("%s is on %s, Xn on %s" % (name, t.device, dev))
    if not 0 <= int(n_iter) <= _INT_MAX or B > _INT_MAX:
        raise ValueError("n_iter %d or %d pairs out of range" % (n_iter, B))
    plan = exp_plan(B, n) if _plan is None else _plan
    if (plan["B"], plan["n"]) != (B, n):
        raise ValueError("the plan is for %d pairs of %d bins, got %d of %d"
                         % (plan["B"], plan["n"], B, n))
    out = torch.empty(B, dtype=torch.float32, device=dev)
    if dev.type == "cuda" and B == 0:
        return out
    ids = (Xn.data_ptr(), Zn.data_ptr(), I.data_ptr(), I.stride(0), J.data_ptr(),
           J.stride(0), K64.data_ptr(), KC64.data_ptr(), B, n, plan["npad"])
    tiny32 = float(np.float32(tiny))
    if plan["path"] == "resident":
        _launch("annchor_k8a_resident", "exp", dev, (*ids, int(n_iter), tiny32, out.data_ptr()))
        return out
    # u, then v: (Bp, npad) float64 each
    ws = torch.empty(2 * plan["Bp"] * plan["npad"], dtype=torch.float64, device=dev)
    _launch("annchor_k8a_streamed", "exp", dev,
            (*ids, plan["Bp"], plan["cols"], int(n_iter), tiny32, ws.data_ptr(),
             out.data_ptr()),
            exp_launches(plan, n_iter))
    return out


def sinkhorn_log_cuda(A, B, C, eps: float, n_iter: int):
    """K8b: the log-domain Sinkhorn costs of the histogram pairs (A[k],
    B[k]), float32 (m,) on the card, in one launch.  A, B: contiguous (m,
    n) float32; C: contiguous (n, n) float32; eps: a float32 value.
    Nothing here waits for the card."""
    _check("A", A, torch.float32, dim=2)
    m, n = (int(s) for s in A.shape)
    _check("B", B, torch.float32, (m, n))
    _check("C", C, torch.float32, (n, n))
    dev = A.device
    for name, t in (("A", A), ("B", B), ("C", C)):
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
        if t.device != dev:
            raise ValueError("%s is on %s, A on %s" % (name, t.device, dev))
    if not 0 <= int(n_iter) <= _INT_MAX or m > _INT_MAX:
        raise ValueError("n_iter %d or %d pairs out of range" % (n_iter, m))
    plan = log_plan(m, n)
    out = torch.empty(m, dtype=torch.float32, device=dev)
    if dev.type == "cuda" and m == 0:
        return out
    ws = (torch.empty(plan["blocks"] * 4 * plan["P"] * n, dtype=torch.float32, device=dev)
          if plan["global_v"] else None)
    e32 = np.float32(eps)
    # x / eps on a card is x * (1 / eps), the reciprocal in float32
    inv = np.float32(1.0) / e32
    _launch("annchor_k8b_log", "log", dev,
            (A.data_ptr(), B.data_ptr(), C.data_ptr(), m, n, plan["P"], plan["G"],
             int(plan["resident"]), int(plan["global_v"]), float(e32), float(inv), int(n_iter),
             None if ws is None else ws.data_ptr(), out.data_ptr()))
    return out


def exp_chunk_model(Xn, Zn, I, J, K64, KC64, n_iter: int, tiny: float):
    """K8a's arithmetic in torch, on any device, summed in the kernel's
    order (on every path): each product entry the float64 sum over
    k = 0..n-1 in order of exact products (the FP64 tensor cores' chained
    mma is that FMA chain, tools/probe_dmma.cu), rounded once to float32,
    clamped at ``tiny``, one float32 division; the cost's terms
    u_c (v KC^T)_c, each a rounded product, summed over c in order.  On a
    card its values are the kernel's, bit for bit; on the CPU it
    calibrates the kernel against the plain version.  Slow: n steps a
    product."""
    A = Xn.index_select(0, I)
    Bh = Zn.index_select(0, J)
    n = int(Xn.shape[1])
    Kt = K64.t()
    KCt = KC64.t()

    def product(w, M):
        # y[:, c] = sum_k w[:, k] M[k, c]; each product exact, so a multiply
        # and an add are the kernel's fma
        y = torch.zeros(w.shape, dtype=torch.float64, device=w.device)
        for k in range(n):
            y = y + w[:, k : k + 1] * M[k]
        return y

    def scale(hist, w, M):
        return (hist / product(w, M).to(torch.float32).clamp(min=tiny)).to(torch.float64)

    v = torch.ones(A.shape, dtype=torch.float64, device=A.device)
    for _ in range(int(n_iter)):
        u = scale(A, v, Kt)
        v = scale(Bh, u, K64)
    u = scale(A, v, Kt)
    terms = u * product(v, KCt)
    total = torch.zeros(terms.shape[0], dtype=torch.float64, device=A.device)
    for c in range(n):
        total = total + terms[:, c]
    return total.to(torch.float32)
