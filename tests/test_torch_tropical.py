"""K4, the dense tropical tighten, on the CPU: the plain version that a
CPU tensor takes, held bit for bit against the JAX package's
``_tighten_full`` (through ``tighten_full`` and ``rebound_pairs``) and
against a numpy float32 reference of the two products; the column-range
split the sharded tighten relies on; the dispatch and the wrapper's
checks.  The kernel itself runs on the card: ``tests/test_torch_cuda.py``
(``test_k4_*``) and ``chip_smoke.py`` phase 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from annchor_tpu.ops import device_pipeline as jdp
from annchor_tpu_torch.ops import device_pipeline as tdp
from annchor_tpu_torch.ops.bounds_update import _build_E
from annchor_tpu_torch.ops.tropical_cuda import K4, tropical_product_cuda

torch.set_num_threads(2)

# (nx, share of the i < j pairs tracked, share of those computed, rows
# with no computed entry)
CASES = {
    "nx1": (1, 1.0, 1.0, 0),
    "nx17": (17, 0.8, 0.5, 0),
    "nx130-sparse": (130, 0.3, 0.3, 0),
    "empty-rows": (100, 0.6, 0.6, 12),
    "nearly-full": (90, 1.0, 0.97, 0),
}


def _state(nx, density, computed, empty_rows, seed):
    """A fit state: tracked pairs i < j, their values (integers, so ties
    abound, and arbitrary float32s), the computed mask and bounds."""
    rng = np.random.default_rng(seed)
    iu, ju = np.triu_indices(nx, 1)
    keep = rng.random(iu.size) < density
    ij_i, ij_j = iu[keep].astype(np.int32), ju[keep].astype(np.int32)
    m = ij_i.size
    RA = np.where(rng.random(m) < 0.5, rng.integers(0, 40, m),
                  rng.random(m) * 40).astype(np.float32)
    ncm = rng.random(m) >= computed
    ncm |= (ij_i < empty_rows) | (ij_j < empty_rows)
    lb = np.maximum(RA - rng.random(m).astype(np.float32) * 30, 0).astype(np.float32)
    ub = (RA + rng.random(m).astype(np.float32) * 30).astype(np.float32)
    return ij_i, ij_j, RA, ncm, lb, ub


@pytest.mark.parametrize("case", list(CASES))
def test_tighten_full_bit_equal_to_jax(case):
    nx, density, computed, empty = CASES[case]
    ij_i, ij_j, RA, ncm, lb, ub = _state(nx, density, computed, empty, seed=nx)
    want = jdp._tighten_full(*(jnp.asarray(a) for a in (ij_i, ij_j, RA, ncm, lb, ub)), nx)
    before = K4.launches
    got = tdp.tighten_full(*(torch.as_tensor(a) for a in (ij_i, ij_j, RA, ncm, lb, ub)), nx)
    assert K4.launches == before  # a CPU tensor takes the plain version
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _np_tropical(E, V, y0, y1):
    """numpy float32 reference of the two products over columns y0..y1."""
    a, v = E[:, y0:y1], V[:, y0:y1]
    both = v[:, None, :] & v[None, :, :]
    lb = np.where(both, np.abs(a[:, None, :] - a[None, :, :]), np.float32(0))
    e = np.where(v, a, np.float32(np.inf))
    ub = e[:, None, :] + e[None, :, :]
    return lb.max(axis=2, initial=np.float32(0)), ub.min(axis=2, initial=np.float32(np.inf))


def _matrix(nx, case, seed):
    """(E, V, Einf) as ``tighten_full`` builds them: E 0 and Einf +inf
    where V is False.  "full": every entry present, the diagonal too."""
    if case == "full":
        rng = np.random.default_rng(seed)
        E = (rng.random((nx, nx)) * 50).astype(np.float32)
        E = np.minimum(E, E.T)
        V = np.ones((nx, nx), dtype=bool)
        E, V = torch.as_tensor(E), torch.as_tensor(V)
    else:
        ij_i, ij_j, RA, ncm, _, _ = _state(nx, *CASES[case][1:], seed=seed)
        IJ = torch.as_tensor(np.stack([ij_i, ij_j], axis=1)).long()
        E, V = _build_E(IJ, torch.as_tensor(RA), ~torch.as_tensor(ncm), nx)
    return E, V, torch.where(V, E, torch.full_like(E, float("inf")))


@pytest.mark.parametrize("case", ["full", "nx130-sparse", "empty-rows"])
def test_tropical_product_plain_matches_numpy(case):
    nx = 77 if case == "full" else CASES[case][0]
    E, V, Einf = _matrix(nx, case, seed=3)
    for y0, y1 in ((0, nx), (5, 38), (nx, nx)):
        lbM, ubM = tdp.tropical_product_plain(E, V, Einf, y0, y1)
        lb_np, ub_np = _np_tropical(E.numpy(), V.numpy(), y0, y1)
        np.testing.assert_array_equal(lbM.numpy(), lb_np)
        np.testing.assert_array_equal(ubM.numpy(), ub_np)


@pytest.mark.parametrize("split", [1, 37, 64])
def test_column_ranges_combine_to_the_whole(split):
    """Two column ranges combined by max/min give the whole range's
    bits (the sharded tighten's split), and the block size changes
    nothing."""
    E, V, Einf = _matrix(130, "nx130-sparse", seed=5)
    whole = tdp.tropical_product(E, V, Einf, 0, 130)
    a = tdp.tropical_product(E, V, Einf, 0, split, block=7)
    b = tdp.tropical_product(E, V, Einf, split, 130, block=16)
    assert torch.equal(torch.maximum(a[0], b[0]), whole[0])
    assert torch.equal(torch.minimum(a[1], b[1]), whole[1])


def test_wrapper_refuses_before_building():
    """The wrapper raises a clear ValueError on a CPU tensor, a wrong
    dtype or a non-contiguous E, before any build (a build without a
    CUDA compiler raises a RuntimeError instead)."""
    E = torch.zeros((8, 8))
    V = torch.ones((8, 8), dtype=torch.bool)
    before = K4.launches
    with pytest.raises(ValueError, match="on a card"):
        tropical_product_cuda(E, V, 0, 8)
    with pytest.raises(ValueError, match="float32"):
        tropical_product_cuda(E.double(), V, 0, 8)
    with pytest.raises(ValueError, match="not contiguous"):
        tropical_product_cuda(torch.zeros((8, 16))[:, ::2], V, 0, 8)
    with pytest.raises(ValueError, match="column range"):
        tropical_product_cuda(E, V, 3, 9)
    assert K4.launches == before
