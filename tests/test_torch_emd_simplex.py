"""K12's plain version (``ops/emd_cuda.emd_simplex_plain``), a numpy
transcription of a warp's network simplex, held bit for bit against the
host solver (``native.py``, csrc/emd_native.cpp) on the CPU; the shared
cell order against the host's per-pair counting sort; and the EMD
engine's choice between K12 and the host solver.  The kernel itself runs
in tests/test_torch_cuda.py, on a card.
"""

import bisect

import numpy as np
import pytest
import torch

from annchor_tpu_torch import native, trace
from annchor_tpu_torch.datasets import digit_images, grid_cost_matrix
from annchor_tpu_torch.metrics import _EMDEngine, get_function_from_input
from annchor_tpu_torch.ops import emd_cuda


@pytest.fixture(scope="module")
def digits():
    X, _ = digit_images()
    return X, grid_cost_matrix()


def _near_pairs(X, rows):
    """Each of ``rows`` with its two nearest digits by pixel distance."""
    d2 = ((X[rows, None, :] - X[None, :, :]) ** 2).sum(-1)
    d2[np.arange(len(rows)), rows] = np.inf
    nn = np.argsort(d2, axis=1, kind="stable")[:, :2]
    return np.repeat(rows, 2), nn.ravel()


@pytest.mark.parametrize("kind", ["near", "random"])
def test_plain_bit_equal_to_host_on_digits(digits, kind):
    X, M = digits
    rng = np.random.default_rng(11)
    if kind == "near":
        I, J = _near_pairs(X, rng.choice(len(X), 80, replace=False))
    else:
        I, J = rng.integers(0, len(X), size=(2, 160))
    got = emd_cuda.emd_simplex_plain(X, X, M, I, J)
    want = native.emd_batch(X, X, M, I, J)
    assert got.dtype == np.float64 and got.tobytes() == want.tobytes()


def _edge_case(case, rng):
    """(X, C, I, J) of one named case."""
    if case in ("3x3 grid", "10x10 grid"):
        g = 3 if case == "3x3 grid" else 10
        X = rng.random((30, g * g)) * (rng.random((30, g * g)) < 0.6)
        return X, grid_cost_matrix(g, g), rng.integers(0, 30, 60), rng.integers(0, 30, 60)
    X = rng.random((50, 64)) * (rng.random((50, 64)) < 0.5)
    M = grid_cost_matrix()
    if case == "one-bin support":
        # one bin against supports of 1 to 49 bins, on either side
        X[:25] = 0.0
        X[np.arange(25), rng.integers(0, 64, 25)] = rng.random(25) * 3
        for k in range(25, 50):
            X[k] = 0.0
            X[k, rng.choice(64, k - 24, replace=False)] = rng.random(k - 24)
        I = np.concatenate([np.arange(25), np.arange(25, 50)])
        J = np.concatenate([np.arange(25, 50), np.arange(25)])
        return X, M, I, J
    if case == "all-zero histogram":
        X[3] = 0.0
        return X, M, np.array([3, 3, 7, 3]), np.array([3, 9, 3, 0])
    assert case == "duplicate pair"
    return X, M, np.arange(20), np.arange(20)


@pytest.mark.parametrize("case", ["one-bin support", "all-zero histogram", "duplicate pair",
                                  "3x3 grid", "10x10 grid"])
def test_plain_bit_equal_to_host_edge_cases(case):
    X, C, I, J = _edge_case(case, np.random.default_rng(3))
    got = emd_cuda.emd_simplex_plain(X, X, C, I, J)
    want = np.array([native.emd_single(X[i], X[j], C) for i, j in zip(I, J)])
    assert got.tobytes() == want.tobytes()
    if case in ("all-zero histogram", "duplicate pair"):
        assert (got[: 1 if case == "all-zero histogram" else None] == 0.0).all()


def _host_cell_order(C, ia, ib):
    """The host's per-pair order of the compressed cells (emd_normalised):
    distinct-cost ranks (build_cost_ranks), then a counting sort stable
    in (i, j) enumeration order.  Returns [(i, j)] of compressed ids."""
    vals = sorted(set(C.ravel().tolist()))
    n, m = len(ia), len(ib)
    ranks = [bisect.bisect_left(vals, C[ia[i], ib[j]]) for i in range(n) for j in range(m)]
    counts = [0] * (len(vals) + 1)
    for r in ranks:
        counts[r + 1] += 1
    for r in range(len(vals)):
        counts[r + 1] += counts[r]
    cells = [None] * (n * m)
    for k, r in enumerate(ranks):
        cells[counts[r]] = divmod(k, m)
        counts[r] += 1
    return cells


@pytest.mark.parametrize("cost", ["grid", "rounded random"])
def test_cell_order_filtered_is_host_counting_sort(cost):
    rng = np.random.default_rng(5)
    if cost == "grid":
        C = grid_cost_matrix()
    else:
        C = np.round(rng.random((64, 64)) * 6, 1)  # many ties
    order = emd_cuda.cell_order(C)
    assert order.dtype == np.int16 and sorted(order.tolist()) == sorted(
        (i << 8) | j for i in range(64) for j in range(64))
    for _ in range(20):
        ia = np.sort(rng.choice(64, int(rng.integers(1, 65)), replace=False))
        ib = np.sort(rng.choice(64, int(rng.integers(1, 65)), replace=False))
        rmap = dict(zip(ia.tolist(), range(len(ia))))
        cmap = dict(zip(ib.tolist(), range(len(ib))))
        got = [(rmap[c >> 8], cmap[c & 0xFF]) for c in order.tolist()
               if (c >> 8) in rmap and (c & 0xFF) in cmap]
        assert got == _host_cell_order(C, ia, ib)


def test_plan_fits_shared_memory():
    p = emd_cuda.plan(120_914, 64, 132)
    assert p["smem"] == 199_168 <= emd_cuda.SMEM_MAX
    assert p["blocks"] == 132 and p["threads"] == 512
    assert emd_cuda.plan(9, 64, 132)["blocks"] == 1
    assert emd_cuda.plan(33, 9, 132)["blocks"] == 3
    with pytest.raises(ValueError):
        emd_cuda.plan(10, emd_cuda.K12_MAX_BINS + 1, 132)


def test_wrapper_refuses_cpu_tensors(digits):
    X, M = digits
    Xt = torch.as_tensor(X[:4])
    ids = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="on a card"):
        emd_cuda.emd_simplex_cuda(Xt, Xt, ids, ids, torch.as_tensor(M),
                                  torch.as_tensor(emd_cuda.cell_order(M)))


def _engine_run(eng, X, IJ):
    """The engine's values and the counts of its ``engine.emd`` span."""
    trace.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = eng(X, X, IJ)
    (rec,) = [r for r in trace.spans() if r.name == "engine.emd"]
    return got, rec.counts


def test_engine_keeps_host_solver_on_cpu(digits):
    X, M = digits
    eng = get_function_from_input("wasserstein", {"cost_matrix": M}, device="cpu").batch
    assert isinstance(eng, _EMDEngine) and not eng.on_card
    IJ = np.random.default_rng(2).integers(0, len(X), size=(500, 2))
    got, counts = _engine_run(eng, X, IJ)
    assert counts == {"pairs": 500, "on_card": 0}
    assert got.tobytes() == native.emd_batch(X, X, M, IJ[:, 0], IJ[:, 1]).tobytes()


def test_engine_keeps_host_solver_past_k12_bins(monkeypatch):
    """A card engine (the card's presence faked; nothing reaches it) keeps
    the host solver for histograms wider than K12 takes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    rng = np.random.default_rng(4)
    g = 9  # 81 bins
    C = grid_cost_matrix(g, g)
    X = rng.random((20, g * g))
    eng = _EMDEngine(C, device="cuda")
    assert eng.device.type == "cuda" and not eng.on_card
    assert _EMDEngine(grid_cost_matrix(), device="cuda").on_card
    IJ = rng.integers(0, 20, size=(30, 2))
    got, counts = _engine_run(eng, X, IJ)
    assert counts == {"pairs": 30, "on_card": 0}
    assert got.tobytes() == native.emd_batch(X, X, C, IJ[:, 0], IJ[:, 1]).tobytes()


def _fma_sites(path, comment):
    """A source's ``FMA site: <name>`` marks, each with the code line under
    it, and the number of fused multiply-adds its code calls."""
    import os
    import re

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "annchor_tpu_torch", path)) as fh:
        lines = fh.read().splitlines()
    call = re.compile(r"(?<![\w.])(?:std::)?_?fma\(")
    sites, calls = [], 0
    for k, line in enumerate(lines):
        mark = re.search(re.escape(comment) + r" FMA site: ([\w-]+)( \(host only\))?", line)
        if mark:
            sites.append((mark.group(1), bool(mark.group(2)), lines[k + 1]))
        code = line.split(comment, 1)[0]
        if call.search(code) and not code.lstrip().startswith("def "):
            calls += len(call.findall(code))
    return sites, calls


@pytest.mark.parametrize("path, comment", [("csrc/emd_native.cpp", "//"),
                                           ("csrc/emd_simplex.cu", "//"),
                                           ("ops/emd_cuda.py", "#")])
def test_fma_sites_are_one_list(path, comment):
    """The host solver, K12 and the plain version fuse a multiply-add at
    the same named sites, ``emd_cuda.FMA_SITES``, and nowhere else: every
    fma call sits under a mark, and the host's only extra marks are its
    SSP's, which K12 does not transcribe."""
    sites, calls = _fma_sites(path, comment)
    shared = [name for name, host_only, _ in sites if not host_only]
    assert sorted(shared) == sorted(emd_cuda.FMA_SITES)
    assert all(host_only == path.endswith(".cpp") for _, host_only, _ in sites
               if host_only)
    assert all("fma(" in code for _, _, code in sites)
    assert calls == len(sites)
