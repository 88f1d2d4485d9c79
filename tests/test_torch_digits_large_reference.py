"""The digits-5620 configuration of the benchmark on the CPU: its data
generator, a frozen copy of ``make_digits_large``, and a hybrid fit with
the configuration's knobs and the port's default sample stream on the
scale path, held to the benchmark's plain reference
(``knnbench/reference/emd.py``: the transport LP by HiGHS), not to the
JAX package.

The fit runs on 400 of the 5,620 images (200 test digits and the first
200 augmentations) under ``ANNCHOR_TPU_FORCE_SPARSE``, with the column
tighten of more than 4,096 points brought down to 256.  At that size the
configuration's anchors and samples exceed its p_work of 0.1, and the
constructor raises p_work to its floor, as it does for any such fit.
"""

import json
import os

import numpy as np
import pytest
import torch

import annchor_tpu_torch as att
from annchor_tpu_torch import datasets as tds
from annchor_tpu_torch.ops import device_pipeline
from knnbench import datagen, judge
from knnbench.generators import digits_large
from knnbench.reference import emd as ref

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 16  # rows judged against the reference


def _json(rel):
    with open(os.path.join(ROOT, rel)) as fh:
        return json.load(fh)


CONFIG = _json("knnbench/configs/digits-5620.json")
CHECK = _json("knnbench/cells/digits-5620.fit.json")


def test_generator_is_the_programs_stand_in():
    X = digits_large.make(CONFIG["data"], ROOT)
    want, _ = tds.make_digits_large()
    assert X.dtype == np.float64 and np.array_equal(X, want)
    g = np.load(os.path.join(os.path.dirname(att.__file__), "data", "digits_large_gt.npz"))
    assert tds._digest(X) == str(g["xhash"])


def test_generator_refuses_another_set(tmp_path):
    with pytest.raises(ValueError, match="states 5000"):
        digits_large.make({**CONFIG["data"], "n": 5000}, ROOT)
    with np.load(os.path.join(ROOT, CONFIG["data"]["file"])) as z:
        np.savez(tmp_path / "few.npz", images=z["images"][:1000])
    with pytest.raises(ValueError, match="holds 1000 rows"):
        digits_large.make({**CONFIG["data"], "file": "few.npz"}, str(tmp_path))


@pytest.fixture(scope="module")
def fit():
    mp = pytest.MonkeyPatch()
    mp.setenv("ANNCHOR_TPU_FORCE_SPARSE", "1")
    mp.setenv("ANNCHOR_TPU_DISABLE_SHARDING", "1")
    mp.setattr(device_pipeline, "MAX_FULL_MATRIX_NX", 256)
    try:
        X = digits_large.make(CONFIG["data"], ROOT)[1597:1997]
        kw, _ = datagen.with_cost_matrix(CONFIG["metric"]["func_kwargs"])
        ann = att.Annchor(X, CONFIG["metric"]["func"], func_kwargs=kw, random_seed=42,
                          device="cpu", **CONFIG["annchor"])
        ann.fit()
    finally:
        mp.undo()
    return X, ann


def test_scale_path_takes_the_admit_build(fit):
    _, ann = fit
    assert ann._dev.sparse
    assert ann._locality_info["build"] == "admit"
    assert ann._ij_dev[2] == ann._locality_info["admitted"] > 0


def test_hybrid_fit_against_the_reference(fit):
    X, ann = fit
    ngi, ngd = ann.neighbor_graph
    k = ngi.shape[1]
    assert k == CONFIG["annchor"]["n_neighbors"]
    rows = np.sort(np.random.default_rng(7).choice(len(X), ROWS, replace=False))
    params = {"cost_matrix": datagen.grid_cost_matrix(8, 8), "grid": [8, 8]}
    (true,), top = ref.judge(X, X[rows], [ngi[rows]], k, params)
    # every reported distance is the LP's EMD
    assert np.all(ngi[rows] >= 0)
    np.testing.assert_allclose(ngd[rows], true, rtol=0, atol=1e-9)
    flags = getattr(ann, "_ng_exact", None)
    for r in range(ROWS):
        got = judge.numbers(ngi[rows][r:r + 1], ngd[rows][r:r + 1],
                            None if flags is None else flags[rows][r:r + 1],
                            true[r:r + 1], top[r:r + 1], CHECK["match_tol"])
        assert got["dist_gap"] <= CHECK["limits"]["dist_gap"], (r, got)
        assert got["miss_share"] <= CHECK["limits"]["miss_share"], (r, got)
