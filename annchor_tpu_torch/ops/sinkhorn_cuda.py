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
``exp_chunk_model`` and ``log_batch_model`` repeat K8a's and K8b's
arithmetic in torch in the kernels' order of summation.  K8a runs its
products on the FP64 tensor cores (``mma.sync`` m16n8k8 and m16n8k4), the
pairs as the mma's rows; K8b's threads hold register tiles of pairs x
outputs that share each -C/eps value and each potential they load.  Each
takes one launch a chunk while its matrix stays in shared memory
(``RES_MAX_BINS``, ``LOG_RES_MAX_BINS``), one a half step beyond.
"""

from __future__ import annotations

import ctypes
from fractions import Fraction

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
        # A, B, C, m, n, npad, P, tc, tr, eps, inv, n_iter, out, stream
        "annchor_k8b_resident": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P, _P],
        # A, B, C, m, n, npad, Bp, PT, tc, tr, eps, inv, n_iter, ws, rw, out,
        # launched, stream
        "annchor_k8b_streamed": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P, _P,
                                 _P, ctypes.POINTER(_I), _P],
    },
    modes=("exp", "log"),
)

SMS = 132  # streaming multiprocessors of the H100 SXM
SMEM_MAX = 232_448  # dynamic shared memory a block can have (227 KB)
SM_SMEM = 233_472  # shared memory of an SM (228 KB; each block also takes 1 KB)
SM_THREADS_128 = 512  # threads an SM holds at 128 registers each (65,536 in all)
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
# K8b: a thread's tile of (outputs, pairs), the largest first; a plan
# takes the largest of its path's that still gives the card LOG_MIN_LANES
# threads in all.  The resident path has no 4 x 4: its 128 registers cost
# more warps than its loads save (tools/time_k8.py --plans, 4,096-8,192
# pairs of the digits)
LOG_TILES = ((4, 4), (4, 2), (4, 1), (1, 1))
LOG_RES_TILES = LOG_TILES[1:]
LOG_MIN_LANES = 24_000
# -C/eps in shared memory (one copy, swizzled) while it fits (npad 224):
# at 192 bins the resident path led on 1 to 300 pairs (one launch against
# 402 at n_iter 200) and beat the streamed plan on 4,096
LOG_RES_MAX_BINS = 224
LOG_COLS = 64  # outputs of a streamed tile
LOG_SLAB = 32  # k of a streamed slab
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


def _log_res_smem(npad: int, P: int) -> int:
    """Bytes of shared memory of a resident K8b block (csrc/sinkhorn.cu
    log_res_floats): -C/eps (npad, npad), f/eps and g/eps (P, npad + 4),
    log A and log B (P, npad), all float32."""
    return 4 * (npad * npad + 2 * P * (npad + 4) + 2 * P * npad)


def _log_tile(B: int, n: int, path: str) -> tuple:
    """K8b's thread tile (outputs, pairs): the largest of the path's tiles
    (``LOG_TILES`` streamed, ``LOG_RES_TILES`` resident) that still gives
    the card ``LOG_MIN_LANES`` threads, else one output of one pair a
    thread."""
    tiles = LOG_TILES if path == "streamed" else LOG_RES_TILES
    return next(((c, r) for c, r in tiles if -(-B // r) * -(-n // c) >= LOG_MIN_LANES),
                LOG_TILES[-1])


def _res_cost(B: int, P: int, threads: int, smem: int) -> tuple:
    """How a resident K8b plan of P pairs a block loads the busiest SM,
    to be minimised: its pairs over the threads it runs at once (its
    blocks at once are capped by shared memory and by the threads that
    the kernel's 128-register bound lets an SM hold), then its pairs, then
    the distance of the block from 128 threads, then the block's
    threads."""
    per_sm = -(-(-(-B // P)) // SMS)
    at_once = max(1, min(per_sm, SM_SMEM // (smem + 1024), SM_THREADS_128 // threads))
    return (Fraction(per_sm * P, at_once * threads), per_sm * P, abs(threads - 128), threads)


def log_plan(B: int, n: int, path: str | None = None, tile: tuple | None = None) -> dict:
    """K8b's launch for B pairs of n-bin histograms, a pure function of
    (B, n).  A thread takes a tile of ``R`` pairs x ``C`` outputs
    (``_log_tile``).  "resident" up to ``LOG_RES_MAX_BINS`` bins: one
    launch, -C/eps in shared memory with npad = n rounded up to 32, ``P``
    pairs a block, the block 32 to 256 threads: the P that loads the
    busiest SM least (``_res_cost``); of equals the block nearest 128
    threads, so an SM runs two or more and one block's barrier waits on
    the other's work.  "streamed" beyond: 2 n_iter + 2 launches of tiles of ``P``
    pairs by 64 outputs (npad = n rounded up to 64, the workspace's rows
    ``Bp`` to P), the pair tile shrunk while the tiles leave an SM without a
    block.  ``path`` and ``tile`` force a plan, for the tests and for
    timing; a resident plan past ``LOG_RES_MAX_BINS`` raises (-C/eps does
    not fit shared memory), and so does a streamed one of more than 65,535
    pair tiles."""
    if n < 1 or B < 0:
        raise ValueError("K8b needs n >= 1 bins and B >= 0 pairs, got n %d, B %d" % (n, B))
    if path is None:
        path = "resident" if n <= LOG_RES_MAX_BINS else "streamed"
    if path not in ("resident", "streamed"):
        raise ValueError("path must be 'resident' or 'streamed', got %r" % (path,))
    tile = _log_tile(B, n, path) if tile is None else tuple(tile)
    tiles = LOG_TILES if path == "streamed" else LOG_RES_TILES
    if tile not in tiles:
        raise ValueError("tile must be one of %s on the %s path, got %r" % (tiles, path, tile))
    c, r = tile
    if path == "resident":
        npad = round_up(n, 32)
        TO = -(-n // c)
        low = -(-32 // TO)
        fits = [t for t in range(low, max(low, LOG_THREADS // TO) + 1)
                if _log_res_smem(npad, t * r) <= SMEM_MAX]
        if not fits:
            raise ValueError("no resident plan at %d bins: -C/eps does not fit shared memory"
                             % n)
        tp = min(fits, key=lambda t: _res_cost(B, t * r, t * TO, _log_res_smem(npad, t * r)))
        P = tp * r
        return {"B": B, "n": n, "path": path, "npad": npad, "C": c, "R": r, "P": P,
                "threads": tp * TO, "blocks": -(-B // P), "smem": _log_res_smem(npad, P),
                "Bp": 0}
    npad = round_up(n, LOG_COLS)
    TO = LOG_COLS // c
    tp = max(1, min(LOG_THREADS // TO, -(-B // r)))
    while tp > 1 and -(-B // (tp * r)) * (npad // LOG_COLS) < SMS:
        tp //= 2
    P = tp * r
    Bp = round_up(max(B, 1), P)
    if Bp // P > STREAM_MAX_TILES:
        raise ValueError("K8b's streamed path takes at most %d pairs a call, got %d"
                         % (P * STREAM_MAX_TILES, B))
    return {"B": B, "n": n, "path": path, "npad": npad, "C": c, "R": r, "P": P,
            "threads": tp * TO, "blocks": npad // LOG_COLS * (Bp // P),
            "smem": 4 * (2 * LOG_COLS * LOG_SLAB + 2 * P * (LOG_SLAB + 4)), "Bp": Bp}


def log_plans(B: int, n: int) -> list:
    """Every (path, tile) that ``log_plan`` can be forced to for B pairs
    of n bins: each resident tile up to ``LOG_RES_MAX_BINS``, each
    streamed one."""
    out = []
    for path in ("resident", "streamed"):
        for tile in LOG_TILES if path == "streamed" else LOG_RES_TILES:
            try:
                log_plan(B, n, path, tile)
            except ValueError:
                continue
            out.append((path, tile))
    return out


def log_launches(plan: dict, n_iter: int) -> int:
    """CUDA launches of one K8b call under ``plan``."""
    if plan["B"] == 0:
        return 0
    return 1 if plan["path"] == "resident" else 2 * int(n_iter) + 2


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
    """Call the entry point ``fn`` on the current stream and count its
    launches: ``launches``, or the value of a ctypes int that the entry
    point sets to the launches it made."""
    if dev.type != "cuda":
        raise ValueError("K8 takes tensors on a card, got %s" % dev)
    lib = K8.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, fn)(*args, stream)
    K8.count(mode, launches if isinstance(launches, int) else launches.value)
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


def sinkhorn_log_cuda(A, B, C, eps: float, n_iter: int, _plan=None):
    """K8b: the log-domain Sinkhorn costs of the histogram pairs (A[k],
    B[k]), float32 (m,) on the card: one launch while -C/eps fits shared
    memory, ``log_launches`` beyond.  A, B: contiguous (m, n) float32; C:
    contiguous (n, n) float32; eps: a float32 value.  ``_plan``, a
    ``log_plan`` of these m and n, forces a path and tile (for the tests
    and timing).  Nothing here waits for the card."""
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
    plan = log_plan(m, n) if _plan is None else _plan
    if (plan["B"], plan["n"]) != (m, n):
        raise ValueError("the plan is for %d pairs of %d bins, got %d of %d"
                         % (plan["B"], plan["n"], m, n))
    out = torch.empty(m, dtype=torch.float32, device=dev)
    if dev.type == "cuda" and m == 0:
        return out
    e32 = np.float32(eps)
    # x / eps on a card is x * (1 / eps), the reciprocal in float32
    inv = np.float32(1.0) / e32
    ids = (A.data_ptr(), B.data_ptr(), C.data_ptr(), m, n, plan["npad"])
    if plan["path"] == "resident":
        _launch("annchor_k8b_resident", "log", dev,
                (*ids, plan["P"], plan["C"], plan["R"], float(e32), float(inv), int(n_iter),
                 out.data_ptr()))
        return out
    # f / eps, then g / eps: (Bp, npad) float32 zeros; the cost's row sums
    ws = torch.zeros(2 * plan["Bp"] * plan["npad"], dtype=torch.float32, device=dev)
    rw = torch.empty(plan["Bp"] * plan["npad"], dtype=torch.float64, device=dev)
    launched = _I(0)
    _launch("annchor_k8b_streamed", "log", dev,
            (*ids, plan["Bp"], plan["P"], plan["C"], plan["R"], float(e32), float(inv),
             int(n_iter), ws.data_ptr(), rw.data_ptr(), out.data_ptr(), ctypes.byref(launched)),
            launched)
    return out


def log_batch_model(A, B, C, eps: float, n_iter: int):
    """K8b's arithmetic in torch, on any device, in the kernel's order:
    -C/eps as -C * float32(1 / eps); each LSE the max over k (0 where
    infinite), the float32 sum of exp(x - max) over k in order (a loop of
    elementwise adds), log, the max added back; the potentials as
    (eps (log h - LSE)) * (1 / eps); the cost's float64 terms of
    exp((-C/eps + f/eps) + g/eps) C summed over each row's k in order, then
    over the rows in order.  On a card, where torch's exp and log are the
    kernel's expf and logf, its values are the kernel's bit for bit; on the
    CPU it calibrates the kernel against the plain version.  Slow: n steps
    a sweep; (m, n, n) temporaries."""
    dev = A.device
    e32 = torch.tensor(float(np.float32(eps)), dtype=torch.float32, device=dev)
    inv = torch.tensor(float(np.float32(1.0) / np.float32(eps)), dtype=torch.float32,
                       device=dev)
    n = int(A.shape[1])
    N = -C * inv
    LA = torch.where(A > 0, torch.log(A), -1e9)
    LB = torch.where(B > 0, torch.log(B), -1e9)

    def in_order(t):
        # t[..., k] summed over k = 0..n-1 in order
        s = torch.zeros(t.shape[:-1], dtype=t.dtype, device=dev)
        for k in range(n):
            s = s + t[..., k]
        return s

    def update(M, W, logh):
        # x[p, o, k] = M[o, k] + W[p, k]; the max is exact in any order
        x = M[None, :, :] + W[:, None, :]
        mx = x.amax(dim=2)
        mx = torch.where(torch.isinf(mx), 0.0, mx)
        lse = torch.log(in_order(torch.exp(x - mx[:, :, None]))) + mx
        return (e32 * (logh - lse)) * inv

    f = torch.zeros_like(A)
    g = torch.zeros_like(B)
    for _ in range(int(n_iter)):
        f = update(N, g, LA)
        g = update(N.t(), f, LB)
    x = (N[None, :, :] + f[:, :, None]) + g[:, None, :]
    rows = in_order((torch.exp(x) * C[None, :, :]).to(torch.float64))
    return in_order(rows).to(torch.float32)


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
