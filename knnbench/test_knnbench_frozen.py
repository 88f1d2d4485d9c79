"""The benchmark's frozen copies give what the program's originals give
at small sizes, and its operation counts follow the originals' rules."""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from knnbench import counts, datagen  # noqa: E402
from knnbench.generators import npz_rows, strings  # noqa: E402


@pytest.mark.parametrize("kw", [
    dict(n=40, n_clusters=3, length=50, mutation_rate=0.25, seed=7),
    dict(n=33, n_clusters=4, length=80, mutation_rate=0.01, seed=3, evolve=True),
    dict(n=20, n_clusters=2, length=30, mutation_rate=0.1, alphabet="ACGTN", seed=11),
])
def test_make_strings_as_the_program(kw):
    from annchor_tpu_torch.datasets import make_strings

    a, ya = strings.make_strings(**kw)
    b, yb = make_strings(**kw)
    assert a.tolist() == b.tolist() and ya.tolist() == yb.tolist()


def test_grid_and_digits_as_the_program():
    from annchor_tpu_torch.datasets import digit_images, grid_cost_matrix

    assert np.array_equal(datagen.grid_cost_matrix(8, 8), grid_cost_matrix(8, 8))
    assert np.array_equal(datagen.grid_cost_matrix(3, 5), grid_cost_matrix(3, 5))
    spec = {"file": "knnbench/data/digits.npz", "key": "images", "n": 1797}
    a = npz_rows.make(spec, os.path.dirname(HERE))
    b, _ = digit_images()
    assert a.dtype == np.float64 and np.array_equal(a, b)
    with pytest.raises(ValueError, match="states 5620"):
        npz_rows.make({**spec, "n": 5620}, os.path.dirname(HERE))


def test_word_steps_as_the_program():
    from annchor_tpu_torch.ops.levenshtein_cuda import word_steps

    rng = np.random.default_rng(0)
    lens = rng.integers(0, 200, size=50)
    I = rng.integers(0, 50, size=400)
    J = rng.integers(0, 50, size=400)
    J[:20] = I[:20]
    want = word_steps(torch.as_tensor(lens), torch.as_tensor(I), torch.as_tensor(J))
    assert counts.word_steps(lens[I], lens[J], same=I == J) == want


def test_bounds_as_the_smoke_test():
    import chip_smoke

    pk = counts.peaks()
    assert counts.K1_OPS_PER_WORD_STEP == chip_smoke.K1_OPS_PER_STEP
    assert pk["sms"] * pk["int32_lanes_per_sm"] * pk["clock_hz"] == chip_smoke.INT32_OPS_PER_S
    assert (pk["sms"] * pk["fp64_tensor_fma_per_sm"] * pk["clock_hz"]
            == chip_smoke.FP64_FMA_PER_S)
    # the 8,192-pair chunk's bound, 0.6038 ms in the repo's kernels table
    assert counts.k8a_bound_s(8192, 64, 300) * 1e3 == pytest.approx(0.6038, abs=1e-4)
    assert counts.k1_bound_s(1_000_000) == pytest.approx(1e7 / chip_smoke.INT32_OPS_PER_S)


def test_data_keeps_sizes_across_seeds():
    rows = strings.make({"n": 60, "n_clusters": 3, "length": 40, "mutation_rate": 0.25,
                         "alphabet": "ACGT", "data_seed": 42}, None)
    a = datagen.split(rows, {"holdout_every": 4}, 1)
    b = datagen.split(rows, {"holdout_every": 4}, 2**40 + 3)
    assert sorted(a.index) == sorted(b.index) and a.index != b.index
    assert sorted(a.pool) == sorted(b.pool) == sorted(rows[::4])
    assert len(a.index) == 45 and len(a.pool) == 15
    again = datagen.split(rows, {"holdout_every": 4}, 1)
    assert again.index == a.index and again.pool == a.pool
    whole = datagen.split(rows, None, 1)
    assert sorted(whole.index) == sorted(rows) and whole.pool == []
