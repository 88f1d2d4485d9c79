"""Entropic optimal transport (Sinkhorn), batched over pairs on a torch
device.

Port of the JAX package's ``ops/wasserstein.py`` (XLA programs there, so
plain torch here).  Exact EMD is the network simplex of ``native.py``,
run on a card by K12, a warp a pair (``ops/emd_cuda.py``, through
``metrics._EMDEngine``), and on the host's cores otherwise; these
engines approximate it:

* ``SinkhornExpEngine``: exp-domain Sinkhorn with the dataset resident
  on the device, the scout of the scout/certify hybrid
  (``Annchor._certify``); each iteration is two (B, n) @ (n, n) products.
* ``SinkhornEngine``: log-domain Sinkhorn (``logsumexp``), the
  ``wasserstein_sinkhorn`` metric.

Both converge to the entropy-regularised transport cost, which is biased
against exact EMD and can break the triangle inequality, so their fits
take the non-metric path.

On a card both loops run as K8, hand-written CUDA, one launch per chunk
while the matrix fits shared memory (``ops/sinkhorn_cuda.py``):
``sinkhorn_exp_chunk`` and ``sinkhorn_batch``
dispatch CUDA tensors to it and CPU tensors to their plain versions,
``sinkhorn_exp_chunk_plain`` and ``sinkhorn_batch_plain``.

The exp-domain products run in float64 on float32 operands and are
rounded once to float32: each term of a 64-term dot product is exact in
float64, so the result is the float32 rounding of the exact product,
whatever TF32 setting the caller chose (TF32 applies to float32 operands
only) and whatever the reduction order.  The JAX package accumulates
the same products in float32, so the two agree to a few float32 ulps.
"""

from __future__ import annotations

import numpy as np
import torch

from annchor_tpu_torch import trace
from annchor_tpu_torch._backend import resolve_device
from annchor_tpu_torch.ops import sinkhorn_cuda

TINY = float(np.float32(1e-35))


def _exp_iterations(A, B, K64, Kt64, n_iter: int):
    """The exp-domain Sinkhorn scalings (u, v) of the histogram rows A and
    B (float32), as float64 tensors holding float32 values:
    u = A / max(v Kᵀ, TINY), v = B / max(u K, TINY), from v = 1."""
    shape = A.shape
    y = torch.empty(shape, dtype=torch.float64, device=A.device)
    c = torch.empty(shape, dtype=torch.float32, device=A.device)
    u = torch.empty(shape, dtype=torch.float64, device=A.device)
    v = torch.ones(shape, dtype=torch.float64, device=A.device)

    def scale(out, hist, w, K):
        torch.mm(w, K, out=y)
        c.copy_(y)  # the one rounding of the product to float32
        torch.div(hist, c.clamp_(min=TINY), out=out)  # float32 quotient

    for _ in range(n_iter):
        scale(u, A, v, Kt64)
        scale(v, B, u, K64)
    scale(u, A, v, Kt64)
    return u, v


def sinkhorn_exp_chunk(Xn, Zn, I, J, K64, KC64, n_iter: int):
    """Exp-domain Sinkhorn cost <P, C> = sum_ij u_i K_ij C_ij v_j of the
    pairs (Xn[I[k]], Zn[J[k]]): float32 (B,).  Xn, Zn: float32 histograms
    with unit row mass; I, J: int64 ids; K64 = exp(-C/eps) and KC64 = K * C
    as float64 tensors of float32 values.  On a card one K8a launch
    (``sinkhorn_cuda.sinkhorn_exp_cuda``), on the CPU the plain version."""
    # a span, named as chip_smoke.py reads it
    with trace.span("sinkhorn_exp_chunk", pairs=I.shape[0]):
        if Xn.is_cuda:
            return sinkhorn_cuda.sinkhorn_exp_cuda(Xn, Zn, I, J, K64, KC64, n_iter, TINY)
        return sinkhorn_exp_chunk_plain(Xn, Zn, I, J, K64, KC64, n_iter)


def sinkhorn_exp_chunk_plain(Xn, Zn, I, J, K64, KC64, n_iter: int):
    """K8a's plain PyTorch version of ``sinkhorn_exp_chunk``."""
    A = Xn.index_select(0, I)
    B = Zn.index_select(0, J)
    u, v = _exp_iterations(A, B, K64, K64.T.contiguous(), n_iter)
    return (u * (v @ KC64.T)).sum(dim=1).to(torch.float32)


def sinkhorn_maxmin(Xn, K64, KC64, first: int, na: int, n_iter: int):
    """Greedy max-min anchors on the exp-domain Sinkhorn scout: ``na``
    one-vs-all columns, with the running minimum and its argmax kept on
    the device.  Keeps the reference's quirk that the running minimum
    excludes the first anchor's column (reference pickers.py:48-50);
    argmax takes the first index of the maximum.
    Returns (A int64 (na,), D float32 (na, n)) on the device."""
    n = Xn.shape[0]
    dev = Xn.device
    J = torch.arange(n, device=dev)
    D = torch.zeros((na, n), dtype=torch.float32, device=dev)
    A = torch.zeros(na, dtype=torch.int64, device=dev)
    ix = torch.tensor(int(first), dtype=torch.int64, device=dev)
    for i in range(na):
        col = sinkhorn_exp_chunk(Xn, Xn, ix.expand(n), J, K64, KC64, n_iter)
        D[i] = col
        A[i] = ix
        ix = torch.argmax(col) if i == 0 else torch.argmax(D[1 : i + 1].amin(dim=0))
    return A, D


def sinkhorn_batch(A, B, C, eps: float, n_iter: int):
    """Batched log-domain Sinkhorn: A, B (m, n) float32 histograms (rows
    sum to 1, zeros allowed), C (n, n) float32 cost, eps the temperature.
    Returns the (m,) transport costs <P, C>.  On a card K8b
    (``sinkhorn_cuda.sinkhorn_log_cuda``), on the CPU the plain version."""
    if A.is_cuda:
        return sinkhorn_cuda.sinkhorn_log_cuda(A, B, C, eps, n_iter)
    return sinkhorn_batch_plain(A, B, C, eps, n_iter)


def sinkhorn_batch_plain(A, B, C, eps: float, n_iter: int):
    """K8b's plain PyTorch version of ``sinkhorn_batch``."""
    logA = torch.log(torch.where(A > 0, A, 1.0)) + torch.where(A > 0, 0.0, -1e9)
    logB = torch.log(torch.where(B > 0, B, 1.0)) + torch.where(B > 0, 0.0, -1e9)
    negC = -C[None, :, :] / eps
    f = torch.zeros_like(A)
    g = torch.zeros_like(B)
    for _ in range(n_iter):
        f = eps * (logA - torch.logsumexp(negC + (g / eps)[:, None, :], dim=2))
        g = eps * (logB - torch.logsumexp(negC + (f / eps)[:, :, None], dim=1))
    logP = negC + (f / eps)[:, :, None] + (g / eps)[:, None, :]
    return (torch.exp(logP) * C[None, :, :]).sum(dim=(1, 2))


def unit_mass(X):
    """X's rows as float32 histograms of unit mass (all-zero rows stay
    zero), as the JAX package normalises them, in numpy."""
    X = np.asarray(X, dtype=np.float32)
    s = X.sum(axis=1, keepdims=True)
    return X / np.where(s > 0, s, 1.0)


def cached_table(tables, X, make):
    """``make(X)``, kept in the dict ``tables`` for up to two datasets (the
    fitted set and a query set); each entry holds a strong reference to X
    so its id() cannot be recycled."""
    hit = tables.get(id(X))
    if hit is None or hit[0] is not X:
        if len(tables) >= 2:
            tables.clear()
        hit = (X, make(X))
        tables[id(X)] = hit
    return hit[1]


def to_device(a, device, dtype=np.int64):
    """A host array as ``dtype`` (by default int64 ids) on ``device``; to
    a card through pinned memory, so the copy does not wait for the card."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class SinkhornExpEngine:
    """Entropic-OT scout: batched exp-domain Sinkhorn with the dataset
    resident on the device.

    The exploration metric of the scout/certify hybrid: its values carry
    an O(eps) bias and small violations of the triangle inequality, which
    the non-metric fit and the final exact certification absorb.  eps is
    relative to max(cost_matrix) and must keep exp(-C/eps) representable
    in float32 (max(C)/eps < 80)."""

    def __init__(self, cost_matrix, eps: float = 0.015, n_iter: int = 300,
                 chunk: int = 8192, device="cuda"):
        self.C = np.ascontiguousarray(cost_matrix, dtype=np.float32)
        self.eps = float(eps) * float(self.C.max())
        if self.C.max() / self.eps > 80:
            raise ValueError(
                "eps too small for the exp-domain kernel: need "
                "max(cost)/eps < 80, got %.1f" % (self.C.max() / self.eps)
            )
        self.n_iter = int(n_iter)
        self.chunk = int(chunk)
        self.device = resolve_device(device)
        K = np.exp(-self.C / self.eps)  # float32, as the JAX package's
        self._K = torch.from_numpy(K.astype(np.float64)).to(self.device)
        self._KC = torch.from_numpy((K * self.C).astype(np.float64)).to(self.device)
        self._tables = {}

    def _table(self, X):
        """X's rows as float32 histograms of unit mass on the device."""
        return cached_table(self._tables, X, lambda X: torch.from_numpy(
            np.ascontiguousarray(unit_mass(X))).to(self.device))

    def _chunks(self, Xd, Zd, I, J):
        outs = [
            sinkhorn_exp_chunk(Xd, Zd, I[s : s + self.chunk], J[s : s + self.chunk],
                               self._K, self._KC, self.n_iter)
            for s in range(0, I.shape[0], self.chunk)
        ]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def fused_maxmin(self, X, na, first_ix, verbose=False):
        """Greedy max-min anchors on the scout metric (the anchors of a
        hybrid fit).  Returns (A (na,), D float64 (n, na)) as numpy."""
        A, D = sinkhorn_maxmin(self._table(X), self._K, self._KC, int(first_ix),
                               int(na), self.n_iter)
        return A.cpu().numpy(), D.cpu().numpy().astype(np.float64).T

    def batch_dev_ready(self, X):
        return True

    def batch_dev(self, X, I, J):
        """Device-id scout eval: I, J integer tensors on the engine's
        device -> float32 values on the device, nothing waits."""
        Xd = self._table(X)
        return self._chunks(Xd, Xd, I.long(), J.long())

    def dispatch(self, X, Z, IJ):
        """Queue the scout values of the pairs IJ on the device and return
        (device float32 values, m) without waiting for them, so the caller
        can overlap host work (the exact-EMD certify batch) with the
        device's."""
        IJ = np.asarray(IJ, dtype=np.int64).reshape(-1, 2)
        m = IJ.shape[0]
        if m == 0:
            return None, 0
        Xd = self._table(X)
        Zd = Xd if Z is X else self._table(Z)
        return self._chunks(Xd, Zd, to_device(IJ[:, 0], self.device),
                            to_device(IJ[:, 1], self.device)), m

    def __call__(self, X, Z, IJ):
        with trace.span("engine.sinkhorn", pairs=len(IJ)):
            dev, m = self.dispatch(X, Z, IJ)
            if m == 0:
                return np.zeros(0, dtype=np.float64)
            return dev.cpu().numpy().astype(np.float64)


class SinkhornEngine:
    """Log-domain Sinkhorn over pair batches (the ``wasserstein_sinkhorn``
    metric's engine, the ``Metric.batch`` contract)."""

    def __init__(self, cost_matrix, eps: float = 0.02, n_iter: int = 200,
                 chunk: int = 4096, device="cuda"):
        self.C = np.ascontiguousarray(cost_matrix, dtype=np.float32)
        # eps relative to the cost magnitude, as a float32 scalar
        self.eps = float(np.float32(float(eps) * float(self.C.max())))
        self.n_iter = int(n_iter)
        self.chunk = int(chunk)
        self.device = resolve_device(device)

    def __call__(self, X, Z, IJ):
        IJ = np.asarray(IJ, dtype=np.int64)
        if IJ.shape[0] == 0:
            return np.zeros(0, dtype=np.float64)
        Xn = unit_mass(X)
        Zn = Xn if Z is X else unit_mass(Z)
        Cd = torch.from_numpy(self.C).to(self.device)
        outs = []
        for s in range(0, IJ.shape[0], self.chunk):
            blk = IJ[s : s + self.chunk]
            A = torch.from_numpy(np.ascontiguousarray(Xn[blk[:, 0]])).to(self.device)
            B = torch.from_numpy(np.ascontiguousarray(Zn[blk[:, 1]])).to(self.device)
            outs.append(sinkhorn_batch(A, B, Cd, self.eps, self.n_iter))
        return torch.cat(outs).cpu().numpy().astype(np.float64)
