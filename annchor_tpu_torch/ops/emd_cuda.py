"""Wrapper of the hand-written CUDA network simplex (K12): exact EMD on
the card, a warp a pair.

The kernel, ``csrc/emd_simplex.cu``, replaces no kernel of the JAX
package: there the exact EMD is host C++ (``annchor_tpu/native``), as in
the port's ``native.py`` (``csrc/emd_native.cpp``).  Pivoting within one
pair is sequential, but the pairs of a batch are independent, so each
warp solves one pair with the host's own transportation network simplex,
step for step in the host's node numbering and order of operations, and
gives ``native.emd_batch``'s float64 bits:

* the histograms' unit-mass normalisation (the serial sum, then one IEEE
  division a bin) and the zero-mass bins dropped, keeping bin order;
* the least-cost initial basis on perturbed supplies, scanned from one
  cell order shared by the batch (``cell_order``): the full cost
  matrix's cells stable by (distinct-cost rank, i, j), which filtered by
  a pair's support is the host's per-pair counting sort;
* Dantzig pricing: a lane per source row (rows r and r + 32), each row's
  first minimal column, and a warp argmin over (value, row): the host's
  first strict minimum of both loops;
* the pivot, the kid-list surgery, the subtree update and the flows
  re-derived from the final tree in reverse BFS order, in one lane.

The host solver is built with ``-ffp-contract=off`` and writes its FMAs
out: ``sb[m-1] += n * eps``, the tolerance ``scale * 1e-12 + 1e-15``, the
flow peel's ``cost += |bal[v]| * C`` and, in the one-node case (one
source or one sink), the last product of an odd count.  K12 and the
plain version fuse exactly there and round every other product and sum
on its own.  Each site is marked ``FMA site: <name>`` in the three
transcriptions (the host's, K12's and the plain version), and
``FMA_SITES`` is their one list, which the tests hold all three to.  The
port's bit-parity with the JAX package's library holds only where that
library's g++ contracts as GCC 12 does, at these sites and no others.

``emd_simplex_plain`` is K12's plain version, a numpy transcription of a
warp's solve (the lanes' pricing, the warp argmin, the ballot scan of the
shared order); ``emd_simplex_cuda`` launches K12 on PyTorch's current
stream and waits for nothing.  ``metrics._EMDEngine`` calls it for a
card and histograms of at most ``K12_MAX_BINS`` bins, and keeps the host
solver otherwise.
"""

from __future__ import annotations

import ctypes
import math
from fractions import Fraction

import numpy as np
import torch

from annchor_tpu_torch._backend import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int

K12 = Kernel(
    "emd_simplex",
    "emd_simplex.cu",
    {
        # X, Z, I, J, P, nbins, C, order, out, blocks, warps, smem, stream
        "annchor_k12_emd": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _P],
    },
    modes=("simplex",),
)

# a warp's rows are its lanes and the lanes + 32, and a block's shared
# memory holds the cost matrix and 16 warps' trees at 64 bins (199 KB)
K12_MAX_BINS = 64
# where the network simplex fuses a multiply-add, in all three
# transcriptions: sb[m-1] += n * eps, the pricing tolerance, the flow
# peel, the one-node sum's odd last term
FMA_SITES = ("supply", "tol", "peel", "one-node")
WARPS = 16
LANES = 32
SMEM_MAX = 232_448  # dynamic shared memory a block can have (227 KB)

# Shared memory of one warp's solver state (csrc/emd_simplex.cu
# WarpState), sized for K12_MAX_BINS bins and N = 2 K12_MAX_BINS nodes:
# float64 u, flow, supplies and arc flows (4 N) and sb, a, b (3 x 64);
# int16 parent, depth, kid lists, BFS order, stack and adjacency heads
# (8 N), adjacency links (4 N), arc ends (2 N) and the support maps
# (4 x 64); a byte a node of ``seen``.
WARP_BYTES = 8 * (4 * 128 + 3 * 64) + 2 * (14 * 128 + 4 * 64) + 128


def block_bytes(nbins: int) -> int:
    """Shared memory of a K12 block: the cost matrix as float64 rows of
    stride nbins + 1 and the int16 cell order (rounded up to 16), then
    ``WARPS`` solver states."""
    fixed = 8 * nbins * (nbins + 1) + 2 * nbins * nbins
    return -(-fixed // 16) * 16 + WARPS * WARP_BYTES


def plan(P: int, nbins: int, sms: int) -> dict:
    """K12's launch for P pairs of nbins-bin histograms on a card of
    ``sms`` SMs: blocks of ``WARPS`` warps, a warp a pair at a time
    striding over the batch, and at most one block an SM (a block holds
    the cost matrix and its warps' trees in shared memory)."""
    if not 1 <= nbins <= K12_MAX_BINS:
        raise ValueError("K12 takes 1 to %d bins, got %d" % (K12_MAX_BINS, nbins))
    if P < 0:
        raise ValueError("K12 needs P >= 0 pairs, got %d" % P)
    smem = block_bytes(nbins)
    assert smem <= SMEM_MAX, smem
    return {"P": P, "nbins": nbins, "warps": WARPS, "threads": WARPS * LANES,
            "blocks": max(1, min(-(-P // WARPS), sms)), "smem": smem}


def cell_order(C) -> np.ndarray:
    """The cells of the (nbins, nbins) cost matrix C in the host's basis
    order: stable by distinct-cost rank (``build_cost_ranks``: the rank
    of a value among C's sorted distinct values), then by (i, j); each
    cell packed as (i << 8) | j into int16.  Filtered by a pair's
    support it is the order of the host's per-pair counting sort, since
    dropping zero bins keeps bin order."""
    C = np.asarray(C, dtype=np.float64)
    nb = C.shape[0]
    if C.shape != (nb, nb) or nb > 128:
        raise ValueError("cell_order packs a square cost of at most 128 bins, got %s"
                         % (C.shape,))
    rank = np.searchsorted(np.unique(C), C.ravel(), side="left")
    flat = np.argsort(rank, kind="stable")
    return ((flat // nb) << 8 | (flat % nb)).astype(np.int16)


def emd_simplex_cuda(X, Z, I, J, C, order):
    """Exact EMD of the pairs (X[I[k]], Z[J[k]]) on the card: float64 (P,).

    X, Z: contiguous float64 (rows, nbins) on one card (Z may be X);
    I, J: int64 (P,) ids in range (not checked here: that would wait for
    the card); C: float64 (nbins, nbins) cost; order: ``cell_order(C)``
    as int16 on the card.  One K12 launch on the current stream; nothing
    here waits for the card."""
    dev = X.device
    if dev.type != "cuda":
        raise ValueError("emd_simplex_cuda takes tensors on a card, got %s" % dev)
    for name, t, dtype, dim in (("X", X, torch.float64, 2), ("Z", Z, torch.float64, 2),
                                ("I", I, torch.int64, 1), ("J", J, torch.int64, 1),
                                ("C", C, torch.float64, 2), ("order", order, torch.int16, 1)):
        if t.device != dev or t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
            raise ValueError("%s must be a contiguous %d-d %s tensor on %s, got %s %s on %s"
                             % (name, dim, dtype, dev, t.dtype, tuple(t.shape), t.device))
    nb = int(X.shape[1])
    if not 1 <= nb <= K12_MAX_BINS:
        raise ValueError("K12 takes histograms of 1 to %d bins, got %d" % (K12_MAX_BINS, nb))
    if Z.shape[1] != nb or C.shape != (nb, nb) or order.shape != (nb * nb,):
        raise ValueError("histograms of %d and %d bins, cost %s, order %s"
                         % (nb, Z.shape[1], tuple(C.shape), tuple(order.shape)))
    if I.shape != J.shape:
        raise ValueError("I and J differ in shape: %s, %s" % (tuple(I.shape), tuple(J.shape)))
    P = int(I.shape[0])
    out = torch.empty(P, dtype=torch.float64, device=dev)
    if P == 0:
        return out
    p = plan(P, nb, torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = K12.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.annchor_k12_emd(X.data_ptr(), Z.data_ptr(), I.data_ptr(), J.data_ptr(), P,
                                   nb, C.data_ptr(), order.data_ptr(), out.data_ptr(),
                                   p["blocks"], p["warps"], p["smem"], stream)
    K12.count("simplex")
    K12.check("annchor_k12_emd", code)
    return out


# ---------------------------------------------------------------------------
# the plain version: one warp's solve, in numpy and Python floats


def _fma(a: float, b: float, c: float) -> float:
    """a * b + c rounded once (float64)."""
    if hasattr(math, "fma"):
        return math.fma(a, b, c)
    exact = Fraction(a) * Fraction(b) + Fraction(c)
    if exact == 0:
        return a * b + c  # the sign of an exact zero, as IEEE gives it
    return float(exact)


def _warp_argmin(vals, rows, cols):
    """The warp's butterfly reduction over 32 lanes' (value, row, col),
    value then row compared lexicographically."""
    v, r, c = list(vals), list(rows), list(cols)
    off = LANES // 2
    while off:
        nv, nr, nc = v[:], r[:], c[:]
        for lane in range(LANES):
            o = lane ^ off
            if v[o] < v[lane] or (v[o] == v[lane] and r[o] < r[lane]):
                nv[lane], nr[lane], nc[lane] = v[o], r[o], c[o]
        v, r, c = nv, nr, nc
        off //= 2
    return v[0], r[0], c[0]


class _Warp:
    """One warp's solve of one pair (csrc/emd_simplex.cu solve_pair)."""

    def __init__(self, C, order):
        self.C = C  # float64 (nb, nb) ndarray
        self.Cl = C.tolist()
        self.nb = C.shape[0]
        self.order = order.tolist()

    def solve(self, x, y) -> float:
        """The pair's EMD; ``pivots`` and ``priced`` (the reduced costs
        of every pricing pass) count its work."""
        self.pivots = self.priced = 0
        nb = self.nb
        xs, ys = x.tolist(), y.tolist()
        sx = sy = 0.0
        for k in range(nb):
            sx += xs[k]
            sy += ys[k]
        if sx <= 0.0 or sy <= 0.0:
            return 0.0
        ia = [k for k in range(nb) if xs[k] > 0.0]
        ib = [k for k in range(nb) if ys[k] > 0.0]
        a = [xs[k] / sx for k in ia]
        b = [ys[k] / sy for k in ib]
        n, m = len(ia), len(ib)
        Cl = self.Cl
        if n == 1 or m == 1:  # all mass through the one node
            w, c = (b, [Cl[ia[0]][k] for k in ib]) if n == 1 else (a, [Cl[k][ib[0]] for k in ia])
            cost = 0.0
            for k in range(len(w) - (len(w) & 1)):
                cost += w[k] * c[k]
            if len(w) & 1:
                # FMA site: one-node
                cost = _fma(w[-1], c[-1], cost)
            return cost
        self.n, self.m, self.N = n, m, n + m
        self.ia, self.ib = ia, ib
        self.Cs = self.C[np.ix_(ia, ib)]
        return self._simplex(a, b)

    def _cost(self, src, snk):
        return self.Cl[self.ia[src]][self.ib[snk]]

    def _simplex(self, a, b):
        n, m, N = self.n, self.m, self.N
        self.parent = [-1] * N
        self.depth = [0] * N
        self.u = [0.0] * N
        self.flow = [0.0] * N
        self.order_ = [0] * N
        self.khead = [-1] * N
        self.knext = [-1] * N
        self.kprev = [-1] * N
        sa, sb = list(a), list(b)
        total = 0.0
        for i in range(n):
            total += sa[i]
        eps = total * 1e-11
        for i in range(n):
            sa[i] += eps
        # FMA site: supply
        sb[m - 1] = _fma(float(n), eps, sb[m - 1])
        arcs = self._basis(sa, sb)
        self._build_tree(arcs)
        scale = 0.0
        for c in self.Cs.ravel().tolist():
            scale = c if scale < c else scale
        # FMA site: tol
        tol = _fma(scale, 1e-12, 1e-15)
        self._refresh()
        rows = np.arange(n)
        for _ in range(64 * N + 256):
            self.priced += n * m
            # pricing: lane l holds rows l and l + 32; each row's first
            # minimal column, then rmin - u[row]
            R = self.Cs - np.asarray(self.u[n:])
            jmin = R.argmin(axis=1)
            val = (R[rows, jmin] - np.asarray(self.u[:n])).tolist()
            lv, lr, lc = [math.inf] * LANES, [1 << 30] * LANES, [-1] * LANES
            for r in range(n):
                lane = r % LANES
                if val[r] < lv[lane]:
                    lv[lane], lr[lane], lc[lane] = val[r], r, int(jmin[r])
            best, bi, bj = _warp_argmin(lv, lr, lc)
            if not best < -tol:
                break
            self._pivot(bi, n + bj)
            self._update_subtree(self.end)
            self.pivots += 1
        self._rebuild_order()
        bal = [0.0] * N
        for i in range(n):
            bal[i] = a[i]
        for j in range(m):
            bal[n + j] = -b[j]
        cost = 0.0
        for k in range(N - 1, 0, -1):
            v = self.order_[k]
            p = self.parent[v]
            src, snk = (v, p - n) if v < n else (p, v - n)
            # FMA site: peel
            cost = _fma(abs(bal[v]), self._cost(src, snk), cost)
            bal[p] += bal[v]
        return cost

    def _basis(self, sa, sb):
        """The least-cost initial basis: the shared cell order scanned 32
        cells at a time, a ballot of the cells on the support whose row
        and column are both live, one allocation at a time in lane order
        and a new ballot after each."""
        n, m, N, nb = self.n, self.m, self.N, self.nb
        rmap = [-1] * nb
        cmap = [-1] * nb
        for i, k in enumerate(self.ia):
            rmap[k] = i
        for j, k in enumerate(self.ib):
            cmap[k] = j
        seen = [0] * N
        live = N
        arcs = []
        order = self.order
        for k0 in range(0, nb * nb, LANES):
            if live <= 1:
                break
            group = order[k0:k0 + LANES]
            lanes = [(rmap[c >> 8], cmap[c & 0xFF]) for c in group]
            last = -1
            while live > 1:
                ballot = [L for L, (i, j) in enumerate(lanes)
                          if L > last and i >= 0 and j >= 0 and not seen[i]
                          and not seen[n + j]]
                if not ballot:
                    break
                last = ballot[0]
                i, j = lanes[last]
                f = sb[j] if sb[j] < sa[i] else sa[i]
                arcs.append((i, j, f))
                sa[i] -= f
                sb[j] -= f
                if live > 2:
                    if sa[i] <= 0.0:
                        seen[i] = 1
                    else:
                        seen[n + j] = 1
                    live -= 1
                else:
                    live = 1
        return arcs

    def _build_tree(self, arcs):
        n, N = self.n, self.N
        head = [-1] * N
        nxt, node = [], []
        for i, j, _ in arcs:
            for s, t in ((i, n + j), (n + j, i)):
                node.append(t)
                nxt.append(head[s])
                head[s] = len(node) - 1
        parent, depth = self.parent, self.depth
        stack = [0]
        seen = [0] * N
        seen[0] = 1
        parent[0] = -1
        depth[0] = 0
        while stack:
            v = stack.pop()
            e = head[v]
            while e >= 0:
                w = node[e]
                if not seen[w]:
                    seen[w] = 1
                    parent[w] = v
                    depth[w] = depth[v] + 1
                    stack.append(w)
                e = nxt[e]
        self.flow = [0.0] * N
        for i, j, f in arcs:
            x, y = i, n + j
            self.flow[x if parent[x] == y else y] = f

    def _attach(self, c, p):
        h = self.khead[p]
        self.knext[c] = h
        self.kprev[c] = -1
        if h >= 0:
            self.kprev[h] = c
        self.khead[p] = c

    def _detach(self, c):
        p = self.parent[c]
        prv, nxt = self.kprev[c], self.knext[c]
        if prv >= 0:
            self.knext[prv] = nxt
        else:
            self.khead[p] = nxt
        if nxt >= 0:
            self.kprev[nxt] = prv

    def _rebuild_order(self):
        order, khead, knext = self.order_, self.khead, self.knext
        order[0] = 0
        tail = 1
        h = 0
        while h < tail:
            c = khead[order[h]]
            while c >= 0:
                order[tail] = c
                tail += 1
                c = knext[c]
            h += 1

    def _refresh(self):
        n, N = self.n, self.N
        self.khead = [-1] * N
        for v in range(N):
            if self.parent[v] >= 0:
                self._attach(v, self.parent[v])
        self._rebuild_order()
        self.depth[0] = 0
        self.u[0] = 0.0
        for h in range(1, N):
            c = self.order_[h]
            v = self.parent[c]
            self.depth[c] = self.depth[v] + 1
            src, snk = (c, v - n) if c < n else (v, c - n)
            self.u[c] = self._cost(src, snk) - self.u[v]

    def _update_subtree(self, root):
        n = self.n
        parent, depth, u = self.parent, self.depth, self.u
        stack = [root]
        while stack:
            v = stack.pop()
            p = parent[v]
            depth[v] = depth[p] + 1
            src, snk = (v, p - n) if v < n else (p, v - n)
            u[v] = self._cost(src, snk) - u[p]
            c = self.khead[v]
            while c >= 0:
                stack.append(c)
                c = self.knext[c]

    def _pivot(self, i, jn):
        n = self.n
        parent, depth, flow = self.parent, self.depth, self.flow
        delta = 1e300
        leave = -1
        lx, ly = i, jn
        while lx != ly:
            if depth[lx] >= depth[ly]:
                if lx < n and flow[lx] <= delta:
                    delta, leave = flow[lx], lx
                lx = parent[lx]
            else:
                if ly >= n and flow[ly] <= delta:
                    delta, leave = flow[ly], ly
                ly = parent[ly]
        v = i
        while v != lx:
            flow[v] += -delta if v < n else delta
            v = parent[v]
        v = jn
        while v != lx:
            flow[v] += -delta if v >= n else delta
            v = parent[v]
        on_path = False
        v = i
        while v >= 0:
            if v == leave:
                on_path = True
                break
            v = parent[v]
        end, other = (i, jn) if on_path else (jn, i)
        prev, carry, cur = other, delta, end
        while prev != -1 and cur != -1:
            nxt, nxtflow = parent[cur], flow[cur]
            self._detach(cur)
            parent[cur] = prev
            self._attach(cur, prev)
            flow[cur] = carry
            if cur == leave:
                break
            prev, cur, carry = cur, nxt, nxtflow
        self.end = end


def emd_simplex_plain(X, Z, C, I, J, order=None) -> np.ndarray:
    """K12's plain version: the exact EMD of the pairs (X[I[k]], Z[J[k]])
    by one warp's solve each, in numpy and Python floats.  X, Z: (rows,
    nbins) float64; C: (nbins, nbins) float64; order: ``cell_order(C)``
    (built here when None).  Returns float64 (P,)."""
    X = np.ascontiguousarray(X, dtype=np.float64)
    Z = np.ascontiguousarray(Z, dtype=np.float64)
    C = np.ascontiguousarray(C, dtype=np.float64)
    warp = _Warp(C, cell_order(C) if order is None else np.asarray(order))
    I = np.asarray(I, dtype=np.int64)
    J = np.asarray(J, dtype=np.int64)
    return np.array([warp.solve(X[i], Z[j]) for i, j in zip(I.tolist(), J.tolist())],
                    dtype=np.float64)
