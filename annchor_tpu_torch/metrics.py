"""Metric resolution and batched pairwise evaluation.

Port of the JAX package's ``metrics.py``.  Every built-in metric has a
batched engine:

* ``levenshtein``: the bit-parallel pair kernel
  (``ops/levenshtein_myers.myers_pairs``), on the card or, for
  ``device="cpu"``, through its plain PyTorch version; on a card the
  strings' encoding is built there too (``MyersEncoding.on_device``);
* ``euclidean``, ``sqeuclidean`` and ``cosine``: ``_DenseBatchEngine``,
  a gather and a row reduction in float32 (the JAX engine is an XLA
  program, not a Pallas kernel, so plain torch ops are its port);
* ``wasserstein``: ``_EMDEngine``, the exact EMD: on a card K12, a warp
  a pair (``ops/emd_cuda.py``), on the CPU and past K12's 64 bins the
  host solver on the host's cores (``native.py``), the same float64
  bits either way; with ``scout="sinkhorn"`` the exp-domain
  Sinkhorn scout on the device (``ops/wasserstein.SinkhornExpEngine``)
  for the scout/certify hybrid;
* ``wasserstein_sinkhorn``: log-domain Sinkhorn on the device
  (``ops/wasserstein.SinkhornEngine``), a non-metric approximation.

On a device mesh (``parallel.auto_mesh``) the Levenshtein and vector
engines split each pair block over the shards: every shard evaluates
its slice on its own device against a copy of the dataset cached there,
and the results come back in block order, equal to the unsharded
engine's (the JAX package's ``shard_map``'d engines).

Any other Python callable is evaluated on the host by
``_fanout_scalar``, which fans chunks of pairs out over a worker pool,
keeping the ``get_exact_ijs(f, X, IJ)`` plug-in contract (reference
annchor/annchor.py:77-82, doc/parallelisation.rst:14-32).
"""

from __future__ import annotations

import atexit
import concurrent.futures as cf
import contextlib
import multiprocessing as mp
import os
import threading

import numpy as np
import torch

from annchor_tpu_torch import native, parallel, trace
from annchor_tpu_torch._backend import resolve_device
from annchor_tpu_torch.ops import levenshtein as _lev_ops
from annchor_tpu_torch.ops.emd_cuda import K12_MAX_BINS, cell_order, emd_simplex_cuda
from annchor_tpu_torch.ops.levenshtein_myers import (
    MyersEncoding,
    myers_maxmin,
    myers_pairs,
)
from annchor_tpu_torch.ops.wasserstein import (
    SinkhornEngine,
    SinkhornExpEngine,
    cached_table,
    to_device,
)
from annchor_tpu_torch.progress import progress

__all__ = [
    "Metric",
    "get_function_from_input",
    "make_get_exact_ijs",
    "make_get_exact_query_ijs",
    "test_parallelisation",
]

class Metric:
    """A metric plus (optionally) a batched pairwise engine.

    scalar: f(x, y) -> float, the user-visible metric
    batch:  optional fn(X, Z, IJ) -> float64 (m,) evaluating
            [f(X[i], Z[j]) for i, j in IJ] as one batch.  Z is X for
            in-sample pairs.  Engines may cache per-dataset encodings.
    is_metric: whether the triangle inequality is trusted
        (reference annchor.py:73-76).
    scout:  optional cheap approximate engine with the batch contract;
            when present, Annchor explores with it and certifies the
            reported graph with the exact engine (the scout/certify
            hybrid, ``Annchor._certify``).
    """

    def __init__(self, scalar, batch=None, name="custom", is_metric=True,
                 scout=None):
        self.scalar = scalar
        self.batch = batch
        self.name = name
        self.is_metric = is_metric
        self.scout = scout

    def __call__(self, x, y):
        return self.scalar(x, y)


# ---------------------------------------------------------------------------
# vector metrics


def _euclidean_scalar(x, y):
    return float(np.linalg.norm(np.asarray(x) - np.asarray(y)))


def _sqeuclidean_scalar(x, y):
    return float(np.sum((np.asarray(x) - np.asarray(y)) ** 2))


def _cosine_scalar(x, y):
    """Cosine distance; 0 when either vector is zero (the batched engine
    returns 1 there instead, as the JAX package's does)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    nx = np.linalg.norm(x)
    ny = np.linalg.norm(y)
    if nx == 0 or ny == 0:
        return 0.0
    return float(1.0 - np.dot(x, y) / (nx * ny))


def _dense_pairs(kind: str, a, b):
    """Row-wise float32 distance between the gathered rows a and b."""
    if kind == "euclidean":
        return torch.sqrt(((a - b) ** 2).sum(dim=1))
    if kind == "sqeuclidean":
        return ((a - b) ** 2).sum(dim=1)
    if kind == "cosine":
        num = (a * b).sum(dim=1)
        den = torch.linalg.vector_norm(a, dim=1) * torch.linalg.vector_norm(
            b, dim=1
        )
        return 1.0 - num / torch.clamp(den, min=1e-30)
    raise ValueError(kind)


class _Replicas:
    """Copies of a dataset's device tables on the other devices of a
    mesh, one per device, each held until its source changes."""

    def __init__(self):
        self._copies = {}

    def on(self, src, device, copy):
        """``src`` (whose ``.device`` is one device) on ``device``:
        ``copy(src, device)``, made once per device and source."""
        if src.device == device:
            return src
        hit = self._copies.get(device)
        if hit is None or hit[0] is not src:
            hit = self._copies[device] = (src, copy(src, device))
        return hit[1]


def _mesh_split(device, fn, I, J):
    """fn(I_c, J_c) on each shard's slice of the pair ids I, J when a
    mesh is active for ``device`` (results in pair order on I's
    device), else fn(I, J)."""
    mesh = parallel.auto_mesh(device)
    if mesh is None:
        return fn(I, J)
    return parallel.split_pairs(fn, mesh, I, J)


class _DenseBatchEngine:
    """Batched vector-metric engine (euclidean / sqeuclidean / cosine)
    on one device: gather the pairs' rows and reduce, in float32
    (replaces the reference's numba prange loop, utils.py:144-150).
    The two sides of a pair are summed in another order than XLA's, so
    results agree with the JAX engine to a few float32 ulps."""

    def __init__(self, kind: str, device, chunk: int = 1 << 20):
        if kind not in ("euclidean", "sqeuclidean", "cosine"):
            raise ValueError(kind)
        self.kind = kind
        self.device = resolve_device(device)
        self.chunk = chunk
        self._dev_cache = {}  # up to two datasets (fit X + query Q)
        self._replicas = _Replicas()

    def _data_dev(self, X):
        """X as float32 on the device, from a two-entry LRU cache keyed
        by identity; each entry holds a strong reference to X so its
        id() cannot be recycled while the entry is live."""
        hit = self._dev_cache.get(id(X))
        if hit is not None and hit[0] is X:
            # touch: a steady fit-side X is never the one evicted by a
            # stream of query batches
            self._dev_cache.pop(id(X))
            self._dev_cache[id(X)] = hit
            return hit[1]
        Xd = torch.as_tensor(
            np.asarray(X), dtype=torch.float32, device=self.device
        )
        if len(self._dev_cache) >= 2:  # evict the least recently used
            self._dev_cache.pop(next(iter(self._dev_cache)))
        self._dev_cache[id(X)] = (X, Xd)
        return Xd

    def _chunks(self, Xd, Zd, I, J):
        """(B,) float32 distances of rows I of Xd to rows J of Zd, in
        chunks of ``self.chunk`` pairs."""
        B = I.shape[0]
        outs = [
            _dense_pairs(
                self.kind,
                Xd.index_select(0, I[s : s + self.chunk]),
                Zd.index_select(0, J[s : s + self.chunk]),
            )
            for s in range(0, max(B, 1), self.chunk)
        ]
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _eval(self, X, Z, I, J):
        """Distances of rows I of X to rows J of Z, split over the mesh
        when one is active; the uploads are reused across calls."""
        Xd = self._data_dev(X)
        Zd = Xd if Z is X else self._data_dev(Z)

        def local(i, j):
            xd = self._replicas.on(Xd, i.device, torch.Tensor.to)
            zd = xd if Zd is Xd else Zd.to(i.device)
            return self._chunks(xd, zd, i, j)

        return _mesh_split(self.device, local, I, J)

    def __call__(self, X, Z, IJ):
        IJ = np.asarray(IJ, dtype=np.int64)
        if IJ.shape[0] == 0:
            return np.zeros(0, dtype=np.float64)
        ij = torch.as_tensor(IJ, device=self.device)
        d = self._eval(X, Z, ij[:, 0], ij[:, 1])
        return d.cpu().numpy().astype(np.float64)

    def batch_dev_ready(self, X):
        return True

    def batch_dev(self, X, I, J):
        """Device-id eval: I, J integer tensors on the engine's device
        -> float32 distances on the device, no host hop."""
        return self._eval(X, X, I.long(), J.long())

    def fused_maxmin(self, X, na, first_ix, verbose=False):
        """Greedy max-min anchors with every column on the device
        (reference pickers.py:18-52).  Keeps the reference's quirk that
        the running minimum excludes the first anchor's column
        (``D[1:]``, pickers.py:48-50); argmax takes the first index of
        the maximum.  Returns (A (na,), D float64 (n, na))."""
        Xd = self._data_dev(X)
        n = Xd.shape[0]
        if self.kind == "cosine":
            row_norms = torch.linalg.vector_norm(Xd, dim=1)

        def column(ix):
            x = Xd[ix]
            if self.kind == "cosine":
                num = Xd @ x
                den = row_norms * torch.linalg.vector_norm(x)
                return 1.0 - num / torch.clamp(den, min=1e-30)
            sq = ((Xd - x) ** 2).sum(dim=1)
            return torch.sqrt(sq) if self.kind == "euclidean" else sq

        D = torch.zeros((na, n), dtype=torch.float32, device=self.device)
        A = torch.zeros(na, dtype=torch.int64, device=self.device)
        ix = torch.tensor(int(first_ix), dtype=torch.int64, device=self.device)
        min_d = None
        for i in range(na):
            col = column(ix)
            D[i] = col
            A[i] = ix
            if i > 0:
                min_d = col if min_d is None else torch.minimum(min_d, col)
            ix = torch.argmax(col if i == 0 else min_d)
        return A.cpu().numpy(), D.cpu().numpy().astype(np.float64).T


# ---------------------------------------------------------------------------
# edit distance


def _encode_codes(X):
    seq = list(X)
    if len(seq) and not isinstance(seq[0], str):
        return _lev_ops.encode_sequences(seq)
    return _lev_ops.encode_strings(seq)


class _LevenshteinEngine:
    """Batched edit distance on one device, with a one-dataset
    encoding cache (reference annchor/distances.py:16-20,
    utils.py:144-177 evaluate one pair per C-extension call)."""

    def __init__(self, device):
        self.device = resolve_device(device)
        self._cache = {}
        self._holds = 0
        self._pair_enc = None  # (X, Z, encoding) while a hold is open
        self._replicas = _Replicas()

    @contextlib.contextmanager
    def hold_pair_encoding(self):
        """Within the block, query-path calls on the same (X, Z) objects
        share one joint encoding of X + Z instead of encoding it anew per
        call; it is dropped when the outermost hold closes."""
        self._holds += 1
        try:
            yield
        finally:
            self._holds -= 1
            if not self._holds:
                self._pair_enc = None

    def _encode(self, X):
        # keyed by identity, but the entry holds a strong reference to X
        # so its id() cannot be recycled while the entry is live
        key = id(X)
        hit = self._cache.get(key)
        if hit is not None and hit[0] is X:
            return hit[1]
        enc = self.build(X)
        self._cache = {key: (X, enc)}  # hold one dataset at a time
        return enc

    def build(self, X):
        """A new encoding of X on the engine's device: on a card built
        there from X's code points (``MyersEncoding.on_device``), on the
        CPU by the host's numpy (``from_codes``), the faster one there.
        The span counts the strings and those encoded on the card."""
        n = len(X)
        on_card = n if self.device.type == "cuda" else 0
        with trace.device_span("engine.encode", (self.device,), strings=n, on_card=on_card):
            if on_card:
                return MyersEncoding.on_device(X, self.device)
            return MyersEncoding.from_codes(*_encode_codes(X), self.device)

    def _eval(self, enc, I, J):
        """``myers_pairs`` of the pair ids I, J, split over the mesh when
        one is active (each shard on its device's copy of the tables)."""
        return _mesh_split(
            self.device,
            lambda i, j: myers_pairs(self._replicas.on(enc, i.device, type(enc).to), i, j),
            I, J,
        )

    def _pairs(self, enc, I, J):
        with trace.span("engine.levenshtein", pairs=len(I)):
            I = torch.as_tensor(np.asarray(I, dtype=np.int64), device=self.device)
            J = torch.as_tensor(np.asarray(J, dtype=np.int64), device=self.device)
            return self._eval(enc, I, J).cpu().numpy()

    def batch_dev_ready(self, X):
        return True

    def batch_dev(self, X, I, J):
        """Device-id eval: I, J integer tensors on the engine's device
        -> float32 distances on the device, no host hop."""
        return self._eval(self._encode(X), I, J).to(torch.float32)

    def fused_maxmin(self, X, na, first_ix, verbose=False):
        """Greedy max-min anchors, one kernel launch per column."""
        return myers_maxmin(self._encode(X), int(na), int(first_ix))

    def __call__(self, X, Z, IJ):
        IJ = np.asarray(IJ, dtype=np.int64)
        if IJ.shape[0] == 0:
            return np.zeros(0, dtype=np.float64)
        if Z is X:
            enc = self._encode(X)
            return self._pairs(enc, IJ[:, 0], IJ[:, 1]).astype(np.float64)
        # query path: X and Z share one encoding, kept only while a hold
        # is open, so the fitted dataset's cache entry survives
        held = self._pair_enc
        if held is not None and held[0] is X and held[1] is Z:
            enc = held[2]
        else:
            enc = self.build(list(X) + list(Z))
            if self._holds:
                self._pair_enc = (X, Z, enc)
        return self._pairs(enc, IJ[:, 0], IJ[:, 1] + len(X)).astype(
            np.float64
        )


# ---------------------------------------------------------------------------
# optimal transport


class _EMDEngine:
    """Exact 1-Wasserstein distance, bit-equal on every device to the host
    C++ solver (``native.py``), the network simplex the reference's
    pynndescent kantorovich solves (utils.py:82-86).  On a card, for
    histograms of at most ``K12_MAX_BINS`` bins, each batch is one K12
    launch, a warp a pair (``ops/emd_cuda.py``); on the CPU, or for wider
    histograms, the host solver striped over the host's cores."""

    def __init__(self, cost_matrix, device="cpu"):
        self.cost_matrix = np.ascontiguousarray(cost_matrix, np.float64)
        self.device = resolve_device(device)
        self.on_card = (self.device.type == "cuda"
                        and self.cost_matrix.shape[0] <= K12_MAX_BINS)
        self._card = None  # (cost, cell order) on the card, at first use
        self._tables = {}

    def _table(self, X):
        """X as float64 rows on the card."""
        return cached_table(self._tables, X, lambda X: to_device(X, self.device, np.float64))

    def dispatch(self, X, Z, IJ):
        """Queue K12 on the pairs IJ (int64 (m, 2), m > 0) and return the
        float64 distances on the card without waiting for them: the ids
        and, at first use, the histograms, cost and cell order go up
        through pinned memory."""
        nb = self.cost_matrix.shape[0]
        (nx, bx), (nz, bz) = np.shape(X), np.shape(Z)
        if bx != nb or bz != nb:
            raise ValueError("emd: histograms of %d and %d bins under a %d-bin cost"
                             % (bx, bz, nb))
        if IJ.min() < 0 or IJ[:, 0].max() >= nx or IJ[:, 1].max() >= nz:
            raise ValueError("emd: index out of range")
        if self._card is None:
            self._card = (to_device(self.cost_matrix, self.device, np.float64),
                          to_device(cell_order(self.cost_matrix), self.device, np.int16))
        Xd = self._table(X)
        Zd = Xd if Z is X else self._table(Z)
        return emd_simplex_cuda(Xd, Zd, to_device(IJ[:, 0], self.device),
                                to_device(IJ[:, 1], self.device), *self._card)

    def __call__(self, X, Z, IJ):
        IJ = np.asarray(IJ, dtype=np.int64)
        if IJ.shape[0] == 0:
            return np.zeros(0, dtype=np.float64)
        m = IJ.shape[0]
        with trace.span("engine.emd", pairs=m, on_card=m if self.on_card else 0):
            if self.on_card:
                return self.dispatch(X, Z, IJ).cpu().numpy()
            X = np.ascontiguousarray(X, dtype=np.float64)
            Zc = X if Z is X else np.ascontiguousarray(Z, dtype=np.float64)
            return native.emd_batch(X, Zc, self.cost_matrix, IJ[:, 0], IJ[:, 1])


def _make_emd_scalar(cost_matrix):
    M = np.ascontiguousarray(cost_matrix, np.float64)

    def wasserstein(x, y):
        return native.emd_single(np.asarray(x, np.float64), np.asarray(y, np.float64), M)

    return wasserstein


def _make_sinkhorn(cost_matrix, device, **kw):
    eng = SinkhornEngine(cost_matrix, device=device, **kw)

    def scalar(x, y):
        return float(eng(np.asarray(x)[None, :], np.asarray(y)[None, :],
                         np.array([[0, 0]]))[0])

    return scalar, eng


def get_function_from_input(func, func_kwargs=None, device="cuda"):
    """Resolve a metric spec to a Metric (reference utils.py:62-107).

    Accepts a Metric; a string in {euclidean, sqeuclidean, cosine,
    levenshtein, wasserstein, wasserstein_sinkhorn}; or any callable
    f(x, y), with ``func_kwargs`` bound when given.  The Wasserstein
    metrics need ``func_kwargs["cost_matrix"]``; ``wasserstein`` with
    ``"scout": "sinkhorn"`` (and optionally the scout's eps, n_iter,
    chunk) carries the Sinkhorn scout for the hybrid fit.  ``device`` is
    where the batched engine of a built-in metric runs (the exact EMD on a
    card runs K12 up to 64 bins and the host solver past them; its scalar
    form always runs on the host).
    """
    if isinstance(func, Metric):
        return func
    if isinstance(func, str):
        if func in ("euclidean", "sqeuclidean", "cosine"):
            scalar = {
                "euclidean": _euclidean_scalar,
                "sqeuclidean": _sqeuclidean_scalar,
                "cosine": _cosine_scalar,
            }[func]
            return Metric(scalar, _DenseBatchEngine(func, device), name=func)
        if func == "levenshtein":
            if func_kwargs:
                raise TypeError(
                    "levenshtein takes no func_kwargs, got %r" % (func_kwargs,)
                )
            return Metric(
                lambda x, y: float(_lev_ops.levenshtein_scalar(x, y)),
                _LevenshteinEngine(device),
                name="levenshtein",
            )
        if func == "wasserstein":
            assert func_kwargs and "cost_matrix" in func_kwargs, (
                "Error: wasserstein metric requires cost_matrix kwarg"
            )
            kw = dict(func_kwargs)
            M = kw.pop("cost_matrix")
            scout = None
            if kw.pop("scout", None) == "sinkhorn":
                # the scout/certify hybrid: entropic OT on the device drives
                # the search; the exact EMD engine certifies the graph
                scout = SinkhornExpEngine(M, device=device, **kw)
            return Metric(_make_emd_scalar(M), _EMDEngine(M, device), name="wasserstein",
                          scout=scout)
        if func == "wasserstein_sinkhorn":
            assert func_kwargs and "cost_matrix" in func_kwargs, (
                "Error: wasserstein_sinkhorn metric requires cost_matrix"
            )
            kw = dict(func_kwargs)
            scalar, eng = _make_sinkhorn(kw.pop("cost_matrix"), device, **kw)
            # entropic regularisation can violate the triangle inequality
            return Metric(scalar, eng, name="wasserstein_sinkhorn", is_metric=False)
        raise AssertionError(
            "Error: The string must be one of "
            "{euclidean, sqeuclidean, cosine, levenshtein, wasserstein, "
            "wasserstein_sinkhorn}"
        )

    # arbitrary callable, with optional kwargs binding
    if func_kwargs is None:
        return Metric(func)

    def bound(x, y):
        return func(x, y, **func_kwargs)

    return Metric(bound)


# ---------------------------------------------------------------------------
# arbitrary Python metrics: a host worker pool


_EXECUTORS = {}
_EXECUTORS_LOCK = threading.Lock()


def _shutdown_executors():
    """atexit hook: process pools otherwise leak worker handles across
    fits and can hold the interpreter open at shutdown."""
    with _EXECUTORS_LOCK:
        for pool in _EXECUTORS.values():
            pool.shutdown(wait=False, cancel_futures=True)
        _EXECUTORS.clear()


atexit.register(_shutdown_executors)


def _executor(backend: str):
    """Shared worker pool per backend, created on first use (the
    reference keeps joblib's loky pool alive across calls for the same
    reason, reference utils.py:152-177)."""
    with _EXECUTORS_LOCK:
        if backend not in _EXECUTORS:
            n = os.cpu_count() or 1
            if backend in ("loky", "multiprocessing"):
                # spawn: never fork a process that holds CUDA state
                _EXECUTORS[backend] = cf.ProcessPoolExecutor(
                    max_workers=n, mp_context=mp.get_context("spawn")
                )
            else:
                _EXECUTORS[backend] = cf.ThreadPoolExecutor(max_workers=n)
        return _EXECUTORS[backend]


def _chunk_eval(args):
    f, xs, zs = args
    return [f(x, z) for x, z in zip(xs, zs)]


def _serial(f, X, Z, IJ, verbose):
    m = IJ.shape[0]
    return np.array(
        [
            f(X[i], Z[j])
            for i, j in progress(IJ, "metric calls", verbose and m >= 4096, m)
        ],
        dtype=np.float64,
    )


def _fanout_scalar(f, X, Z, IJ, backend, verbose=False):
    """Evaluate [f(X[i], Z[j]) for i, j in IJ] for an arbitrary Python
    metric: chunks of pairs fanned out over a worker pool (reference
    utils.py:152-177 fans the same work over joblib processes).
    Threads by default, since metric closures are rarely picklable and
    NumPy/SciPy metrics release the GIL; spawned process pools with
    backend='loky' or 'multiprocessing'.  Fewer than 256 pairs, or one
    core and no backend, run serially.  verbose reports progress (the
    reference wraps these loops in tqdm, utils.py:136,159)."""
    m = IJ.shape[0]
    ncpu = os.cpu_count() or 1
    if m < 256 or (ncpu == 1 and backend is None):
        return _serial(f, X, Z, IJ, verbose)
    pool = _executor(backend or "threading")
    # capped chunk size: the hang deadline below scales with it
    nchunk = max(64, min(4096, m // (4 * ncpu)))
    jobs = []
    for s in range(0, m, nchunk):
        blk = IJ[s : s + nchunk]
        xs = [X[i] for i in blk[:, 0]]
        zs = [Z[j] for j in blk[:, 1]]
        jobs.append(pool.submit(_chunk_eval, (f, xs, zs)))
    # per-chunk deadline scales with the work (allow 100x a 10 ms
    # metric call): it only catches hung or dead workers
    deadline = max(60.0, 1.0 * nchunk)
    try:
        out = [
            v
            for job in progress(jobs, "metric chunks", verbose and len(jobs) > 1)
            for v in job.result(timeout=deadline)
        ]
    except Exception:
        # An unpicklable closure under a process backend, a dead worker
        # or a hang: finish the metric's host evaluation serially, as
        # the JAX package does, rather than fail the fit.  This falls
        # back between two host evaluations of the user's own Python
        # function; no device path or kernel is involved.
        for job in jobs:
            job.cancel()
        return _serial(f, X, Z, IJ, verbose)
    return np.array(out, dtype=np.float64)


def make_get_exact_ijs(metric: Metric, verbose: bool = False, backend=None):
    """Default in-sample pairwise evaluator for a Metric.

    Returns get_exact_ijs(f, X, IJ) -> float64 (m,), preserving the
    reference plug-in contract.  The batched engine, if any, does the
    work; arbitrary Python metrics fan out over a worker pool
    (``_fanout_scalar``, reference doc/parallelisation.rst:14-52)."""

    def get_exact(f, X, IJ):
        IJ = np.asarray(IJ)
        if metric.batch is not None:
            return metric.batch(X, X, IJ)
        return _fanout_scalar(f, X, X, IJ, backend, verbose=verbose)

    # pickers may take fused device shortcuts only when the user has
    # not overridden the evaluator (reference annchor.py:77-82)
    get_exact._annchor_default = True
    return get_exact


def make_get_exact_query_ijs(metric: Metric, verbose: bool = False, backend=None):
    """Query-side evaluator: pairs (X[i], Z[j])
    (reference utils.py:180-245)."""

    def get_exact(f, X, Z, IJ):
        IJ = np.asarray(IJ)
        if metric.batch is not None:
            return metric.batch(X, Z, IJ)
        return _fanout_scalar(f, X, Z, IJ, backend, verbose=verbose)

    return get_exact


def test_parallelisation(get_exact_ijs, f, X, nx, s=20, seed=42):
    """Construction-time smoke test (reference utils.py:248-271): run a
    few real metric calls so backend problems surface immediately with
    an actionable error."""
    rng = np.random.default_rng(seed)
    IJ = rng.integers(nx, size=(s, 2))
    try:
        out = get_exact_ijs(f, X, IJ)
    except Exception as err:
        raise RuntimeError(
            "Metric backend smoke test failed. If you supplied a "
            "custom get_exact_ijs, check it returns "
            "np.array([f(X[i],X[j]) for i,j in IJ]); for built-in "
            "metrics check the dataset dtype matches the metric. "
            f"Original error: {err!r}"
        ) from err
    out = np.asarray(out)
    if out.shape != (s,):
        raise RuntimeError(
            "get_exact_ijs smoke test returned shape "
            f"{out.shape}, expected ({s},)"
        )
    return out
