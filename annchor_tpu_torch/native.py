"""Exact EMD on the host: the ctypes binding of ``csrc/emd_native.cpp``.

The solver is compiled with ``g++`` at first use into a shared library
under the ignored ``build/native/``, keyed on a hash of its source, its
flags and the host's CPU model (``-march=native`` compiles for the CPU it
runs on), and loaded with ``ctypes``.  The flags are the JAX package's
and ``-ffp-contract=off``: the source writes out each FMA where GCC 12
contracts the JAX package's copy, so the float64 results are the
source's on every compiler and those of the card's solver (K12,
``ops/emd_cuda.py``; the sites are ``emd_cuda.FMA_SITES``).  Bit-parity
with the JAX package's library holds only where its g++ contracts as
GCC 12 does; under another contraction the two may differ by an ulp.  A
failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

from annchor_tpu_torch._backend import BUILD_ROOT

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "emd_native.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
             "-pthread")

# The solver packs (bin_i << 16 | bin_j) cell ids into a signed int32, so
# a bin index must stay below 1 << 15 for the packed id to stay positive.
_MAX_EMD_BINS = 32767

_DOUBLE_P = ctypes.POINTER(ctypes.c_double)
_LONG_P = ctypes.POINTER(ctypes.c_long)


def _cpu_model() -> str:
    """The host CPU's model name and feature flags (what -march=native
    compiles for)."""
    try:
        with open("/proc/cpuinfo") as fh:
            info = [line.split(":", 1)[1].strip() for line in fh
                    if line.startswith(("model name", "flags"))]
        return " | ".join(info[:2])
    except OSError:
        return platform.processor() or platform.machine()


class _Library:
    """The EMD library, built at first use."""

    def __init__(self):
        self._lib = None
        self._lock = threading.Lock()

    def path(self) -> str:
        with open(_SRC, "rb") as fh:
            digest = hashlib.sha256(fh.read())
        digest.update(" ".join(GXX_FLAGS).encode())
        digest.update(_cpu_model().encode())
        return os.path.join(BUILD_ROOT, "native", "emd_native-%s.so" % digest.hexdigest()[:16])

    def _build(self, out: str) -> None:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = "%s.%d.tmp" % (out, os.getpid())
        cmd = ["g++", *GXX_FLAGS, "-o", tmp, _SRC]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as err:
            raise RuntimeError("g++ not found: the exact EMD solver is built from "
                               "csrc/emd_native.cpp at first use") from err
        if proc.returncode != 0:
            raise RuntimeError("building the EMD solver failed (%s):\n%s"
                               % (" ".join(cmd), proc.stdout + proc.stderr))
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                out = self.path()
                if not os.path.exists(out):
                    self._build(out)
                lib = ctypes.CDLL(out)
                lib.emd_single.restype = ctypes.c_double
                lib.emd_single.argtypes = [_DOUBLE_P, _DOUBLE_P, ctypes.c_long, _DOUBLE_P]
                lib.emd_single_ssp.restype = ctypes.c_double
                lib.emd_single_ssp.argtypes = lib.emd_single.argtypes
                lib.emd_batch.restype = ctypes.c_int
                lib.emd_batch.argtypes = [
                    _DOUBLE_P, ctypes.c_long, _DOUBLE_P, ctypes.c_long, ctypes.c_long,
                    _DOUBLE_P, _LONG_P, _LONG_P, ctypes.c_long, _DOUBLE_P,
                ]
                self._lib = lib
        return self._lib


EMD = _Library()


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def _check_bins(nbins: int) -> None:
    if nbins > _MAX_EMD_BINS:
        raise ValueError(
            f"exact EMD supports at most {_MAX_EMD_BINS} histogram bins "
            f"(got {nbins}); use the Sinkhorn scout engine for larger supports"
        )


def emd_single(a, b, cost) -> float:
    """Exact 1-Wasserstein distance between two histograms, each
    normalised to unit mass (network simplex)."""
    a, b, cost = _f64(a), _f64(b), _f64(cost)
    _check_bins(a.shape[0])
    return EMD.lib().emd_single(_ptr(a, ctypes.c_double), _ptr(b, ctypes.c_double),
                                a.shape[0], _ptr(cost, ctypes.c_double))


def emd_single_ssp(a, b, cost) -> float:
    """The same distance by the independent successive-shortest-path
    solver (a cross-check of the network simplex)."""
    a, b, cost = _f64(a), _f64(b), _f64(cost)
    _check_bins(a.shape[0])
    return EMD.lib().emd_single_ssp(_ptr(a, ctypes.c_double), _ptr(b, ctypes.c_double),
                                    a.shape[0], _ptr(cost, ctypes.c_double))


def emd_batch(X, Y, cost, I, J) -> np.ndarray:
    """Exact EMD of the pairs (X[I[k]], Y[J[k]]), striped over the host's
    cores.  Returns float64 (m,)."""
    X, Y, cost = _f64(X), _f64(Y), _f64(cost)
    I = np.ascontiguousarray(I, dtype=np.int64)
    J = np.ascontiguousarray(J, dtype=np.int64)
    _check_bins(X.shape[1])
    if (Y.shape[1] != X.shape[1] or cost.shape != (X.shape[1], X.shape[1])
            or J.shape != I.shape):
        raise ValueError("emd_batch: histograms of %d and %d bins, cost %s, %d and %d ids"
                         % (X.shape[1], Y.shape[1], cost.shape, I.shape[0], J.shape[0]))
    out = np.zeros(I.shape[0], dtype=np.float64)
    rc = EMD.lib().emd_batch(
        _ptr(X, ctypes.c_double), X.shape[0], _ptr(Y, ctypes.c_double), Y.shape[0],
        X.shape[1], _ptr(cost, ctypes.c_double), _ptr(I, ctypes.c_long),
        _ptr(J, ctypes.c_long), I.shape[0], _ptr(out, ctypes.c_double),
    )
    if rc != 0:
        raise ValueError("emd_batch: index out of range")
    return out
