"""Wrapper of the hand-written CUDA tropical tighten (K4).

The kernel, ``csrc/tropical_tighten.cu``, replaces the JAX package's XLA
program ``_tighten_full`` (``annchor_tpu/ops/device_pipeline.py``): the
tropical self-product of the computed-distance matrix in both semirings,
LB[i,j] = max_y |E[i,y] - E[j,y]| over the entries present in both rows
and UB[i,j] = min_y E[i,y] + E[j,y], over a range of columns.  Its plain
PyTorch version is ``device_pipeline.tropical_product_plain``; the
dispatch point is ``device_pipeline.tropical_product``, which launches
this kernel for a CUDA tensor.  One launch on PyTorch's current stream,
no host sync.
"""

from __future__ import annotations

import ctypes

import torch

from annchor_tpu_torch._backend import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int

K4 = Kernel(
    "tropical_tighten",
    "tropical_tighten.cu",
    {"annchor_k4_tropical": [_P, _I, _I, _P, _P, _P]},
    modes=("full",),
)

# a grid edge of at most 65,535 tiles of 64 points
MAX_NX = 65535 * 64


def tropical_product_cuda(E, V, y0: int, y1: int):
    """(LB, UB), (nx, nx) float32 on the card: the tropical self-product
    of E over the columns y0..y1, counting only entries where V is True.

    E: (nx, nx) contiguous float32 on a card (its values where V is False
    are ignored); V: (nx, nx) bool on the same card.  The entries present
    must be finite.  Nothing here waits for the card."""
    if E.dtype != torch.float32 or E.dim() != 2 or not E.is_contiguous():
        raise ValueError("E must be a contiguous 2-d float32 tensor, got %s %s%s"
                         % (E.dtype, tuple(E.shape), "" if E.is_contiguous()
                            else " (not contiguous)"))
    nx = int(E.shape[0])
    if E.shape[1] != nx or V.shape != E.shape or V.dtype != torch.bool or V.device != E.device:
        raise ValueError("E must be square and V a bool tensor of its shape on its device")
    if not 0 <= y0 <= y1 <= nx:
        raise ValueError("column range %d..%d outside 0..%d" % (y0, y1, nx))
    if nx > MAX_NX:
        raise ValueError("nx %d above the kernel's %d" % (nx, MAX_NX))
    if E.device.type != "cuda":
        raise ValueError("tropical_product_cuda takes tensors on a card, got %s" % E.device)
    lbM = torch.empty((nx, nx), dtype=torch.float32, device=E.device)
    ubM = torch.empty_like(lbM)
    if nx == 0:
        return lbM, ubM
    # the absent entries as NaN, k-major: row y of ET is column y0 + y of E
    ET = torch.where(V[:, y0:y1], E[:, y0:y1], float("nan")).t().contiguous()
    lib = K4.lib()
    with torch.cuda.device(E.device):
        stream = torch.cuda.current_stream(E.device).cuda_stream
        code = lib.annchor_k4_tropical(ET.data_ptr(), y1 - y0, nx, lbM.data_ptr(),
                                       ubM.data_ptr(), stream)
    K4.count("full")
    K4.check("annchor_k4_tropical", code)
    return lbM, ubM
