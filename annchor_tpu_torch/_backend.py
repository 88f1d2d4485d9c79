"""Device resolution and the hand-written CUDA kernels' build and load.

Every kernel of the port is CUDA C++ under ``csrc/``.  It is compiled
with ``nvcc`` for Hopper (``sm_90a``) into a shared library with a
plain C interface at first use, cached under ``build/kernels/`` keyed
on a hash of its source, the headers it includes and the flags, and
loaded with ``ctypes``.  A failed build raises: there is no fallback to
another code path.

Each kernel keeps a plain-integer launch counter that its wrapper bumps
once per launch, so a run can show that the main path went through it.
Launches made for one shard of a device mesh (``parallel``) are also
counted per shard.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
# build outputs and caches live beside the package, in a directory that
# version control ignores
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build")
BUILD_DIR = os.path.join(BUILD_ROOT, "kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


# a quoted include of a CUDA source: a header of csrc/ (hashed with it)
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

# the mesh shard whose work the current code runs (``parallel``), or None
_SHARD = contextvars.ContextVar("annchor_shard", default=None)


@contextlib.contextmanager
def shard_scope(index: int):
    """Within the block, kernel launches count toward shard ``index``."""
    token = _SHARD.set(int(index))
    try:
        yield
    finally:
        _SHARD.reset(token)


def resolve_device(device) -> torch.device:
    """The device a caller asked for.  ``"cuda"`` with no card raises
    instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device=%r requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions" % device
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card (stage timers read the host clock)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin); the CUDA kernels "
            "are built from csrc/ at first use and need the CUDA toolkit"
        )
    return path


class Kernel:
    """One CUDA source file built into its own shared library.

    ``launches`` is the launch counter and ``mode_launches`` holds one
    plain-integer counter per launch mode of the source: the wrapper
    calls ``count(mode)`` where it launches the kernel, nowhere else.
    ``shard_launches`` maps a mesh shard's index to the launches made
    inside its ``shard_scope``."""

    def __init__(self, name: str, source: str, signatures: dict, modes=()):
        self.name = name
        self.source = os.path.join(_PKG_DIR, "csrc", source)
        self.signatures = signatures  # C function -> ctypes argtypes
        self.launches = 0
        self.mode_launches = dict.fromkeys(modes, 0)
        self.shard_launches = {}
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def count(self, mode: str, n: int = 1) -> None:
        """Count ``n`` launches of ``mode`` (a call that launches the
        kernel's source several times counts each)."""
        self.launches += n
        self.mode_launches[mode] += n
        shard = _SHARD.get()
        if shard is not None:
            self.shard_launches[shard] = self.shard_launches.get(shard, 0) + n

    def reset_counts(self) -> None:
        self.launches = 0
        self.mode_launches = dict.fromkeys(self.mode_launches, 0)
        self.shard_launches = {}

    def sources(self) -> list:
        """The source and every file it includes by a quoted name
        (``#include "x.cuh"``, looked up beside the including file),
        recursively, each once."""
        out, todo = [], [self.source]
        while todo:
            path = todo.pop(0)
            if path in out or not os.path.exists(path):
                continue
            out.append(path)
            with open(path) as fh:
                names = _INCLUDE.findall(fh.read())
            todo.extend(os.path.join(os.path.dirname(path), name) for name in names)
        return out

    def library_path(self) -> str:
        """Where the library of the current sources and flags is cached:
        the key hashes the source, the headers it includes and the
        flags, so an edited header builds anew."""
        digest = hashlib.sha256()
        for path in self.sources():
            with open(path, "rb") as fh:
                digest.update(fh.read())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return os.path.join(
            BUILD_DIR, "%s-%s.so" % (self.name, digest.hexdigest()[:16])
        )

    def build(self) -> str:
        """Compile the source unless a library built from the same
        source and flags exists.  Returns the library's path.  The
        compiler's output (ptxas's registers and spills) is kept beside
        the library and read back into ``build_log`` either way."""
        out = self.library_path()
        if os.path.exists(out):
            if os.path.exists(out + ".log"):
                with open(out + ".log") as fh:
                    self.build_log = fh.read()
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "%s.%d.tmp" % (out, os.getpid())
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                "building %s failed (%s):\n%s"
                % (self.name, " ".join(cmd), self.build_log)
            )
        with open(out + ".log", "w") as fh:
            fh.write(self.build_log)
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
        return out

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first if needed.  Every source
        also exports ``annchor_error_string(int)``."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                for fn, argtypes in self.signatures.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                lib.annchor_error_string.argtypes = [ctypes.c_int]
                lib.annchor_error_string.restype = ctypes.c_char_p
                self._lib = lib
        return self._lib

    def check(self, fn: str, code: int) -> None:
        """Raise on a non-zero cudaError_t returned by a launch."""
        if code != 0:
            msg = self.lib().annchor_error_string(code).decode()
            raise RuntimeError(
                "%s.%s: CUDA error %d (%s)" % (self.name, fn, code, msg)
            )
