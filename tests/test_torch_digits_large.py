"""The digits-5620 workload in the port: its copied ground truth, and a
small hybrid fit on the scale path (the admit-everything build) held
against the JAX package on the CPU.

The hybrid's scout is float32 Sinkhorn: the port forms its products in
float64 and rounds once, XLA:CPU sums in float32, so scout values differ
in the last bits (rtol 2e-6, ``tests/test_torch_wasserstein.py``).  The
scout calls are set by the budget and must be equal; an exact call is
spent where ``_certify`` admits a pair whose scout value is within its
margin of a row's kth exact distance, so a last-bit difference can move
an admission: the exact calls may differ by 1 %, and the graph may have
no more errors than the JAX package's.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

import annchor_tpu as at
import annchor_tpu_torch as att
from annchor_tpu_torch import datasets as tds
from annchor_tpu_torch import native
from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms

torch.set_num_threads(2)

_JAX_GT = os.path.join(os.path.dirname(at.__file__), "data", "digits_large_gt.npz")
_PORT_GT = os.path.join(os.path.dirname(att.__file__), "data", "digits_large_gt.npz")


def test_ground_truth_is_a_byte_copy():
    assert filecmp.cmp(_PORT_GT, _JAX_GT, shallow=False)


def test_ground_truth_hash_matches_the_images(monkeypatch):
    X, _ = tds.make_digits_large()
    g = np.load(_PORT_GT)
    assert str(g["xhash"]) == tds._digest(X)
    assert g["ngi"].shape == g["ngd"].shape == (5620, 100)
    d = tds.load_digits_large(k=25)
    np.testing.assert_array_equal(d["neighbor_graph"][0], g["ngi"][:, :25])
    # other images than the ones the graph was computed on are refused
    monkeypatch.setattr(tds, "make_digits_large", lambda: (X + 1.0, None))
    with pytest.raises(ValueError, match="hash"):
        tds.load_digits_large()


def test_small_sparse_hybrid_equals_jax(monkeypatch):
    """A hybrid fit on 200 of the 5,620 images (1,797 onwards: the
    augmented ones) under ANNCHOR_TPU_FORCE_SPARSE, scout n_iter cut to
    50, in both packages."""
    monkeypatch.setenv("ANNCHOR_TPU_FORCE_SPARSE", "1")
    monkeypatch.setenv("ANNCHOR_TPU_DISABLE_SHARDING", "1")
    d = tds.load_digits_large()
    X, M = d["X"][1797:1997], d["cost_matrix"]
    fk = {"cost_matrix": M, "scout": "sinkhorn", "n_iter": 50}
    kw = dict(n_anchors=15, n_neighbors=10, n_samples=600, p_work=0.3, random_seed=42)
    ref = at.Annchor(X, "wasserstein", func_kwargs=fk, **kw)
    ref.fit()
    port = att.Annchor(X, "wasserstein", func_kwargs=fk, device="cpu",
                       uniforms=jax_threefry_uniforms, **kw)
    port.fit()
    assert port._locality_info == {"build": "admit", "admitted": ref._ij_dev[2]}
    for k in (0, 1):
        np.testing.assert_array_equal(port._ij_dev[k].numpy(), np.asarray(ref._ij_dev[k]))
    np.testing.assert_array_equal(port.A, ref.A)
    assert port.scout_evals == ref.scout_evals
    assert abs(port.evals - ref.evals) <= 0.01 * ref.evals
    ngi, ngd = port.neighbor_graph
    rows = np.repeat(np.arange(len(X)), ngi.shape[1])
    exact = native.emd_batch(X, X, M, rows, ngi.reshape(-1)).reshape(ngi.shape)
    np.testing.assert_allclose(ngd, exact, atol=1e-9)
    bf = att.BruteForce(X, "wasserstein", func_kwargs={"cost_matrix": M}, device="cpu")
    bf.fit()
    assert (att.compare_neighbor_graphs(bf.neighbor_graph, port.neighbor_graph, 10)
            <= at.compare_neighbor_graphs(bf.neighbor_graph, ref.neighbor_graph, 10))
