"""Whole fits of the port, on the CPU, held against the JAX package and
against the reference's accuracy budget.

With JAX's sample uniforms injected, a fit of the port must pick the
same anchors and candidate pairs, spend the same number of metric
evaluations and report the same k-NN graph as the JAX fit.
"""

import numpy as np
import pytest
import torch

import annchor_tpu as at
import annchor_tpu_torch as att
from annchor_tpu.datasets import make_strings as jax_make_strings
from annchor_tpu_torch.datasets import load_strings, make_strings

torch.set_num_threads(2)


def _jax_uniforms(random_seed, loop_num, m, device):
    """The JAX package's sample-draw stream, handed over as numpy."""
    import jax
    import jax.numpy as jnp

    key = jax.random.fold_in(jax.random.PRNGKey(random_seed), loop_num)
    r = np.array(jax.random.uniform(key, (m,), dtype=jnp.float32))
    return torch.as_tensor(r, device=device)


@pytest.fixture(scope="module")
def fits():
    X, _ = make_strings(n=300, length=60, seed=7)
    kw = dict(n_anchors=12, n_neighbors=10, n_samples=800, p_work=0.3)
    ref = at.Annchor(list(X), "levenshtein", **kw)
    ref.fit()
    port = att.Annchor(
        list(X), "levenshtein", device="cpu", uniforms=_jax_uniforms, **kw
    )
    port.fit()
    return ref, port


def test_fit_matches_jax_anchors_and_pairs(fits):
    ref, port = fits
    np.testing.assert_array_equal(port.A, ref.A)
    np.testing.assert_array_equal(port.D, ref.D)
    np.testing.assert_array_equal(port.IJs, ref.IJs)


def test_fit_matches_jax_evals_and_graph(fits):
    ref, port = fits
    assert port.evals == ref.evals
    assert att.compare_neighbor_graphs(port.neighbor_graph, ref.neighbor_graph, 10) == 0
    np.testing.assert_array_equal(port.neighbor_graph[0], ref.neighbor_graph[0])


def test_fit_matches_jax_state(fits):
    """Same computed pairs; features bit-equal; estimates within the
    regression predict's FMA ulps (see tests/test_torch_pipeline.py)."""
    ref, port = fits
    np.testing.assert_array_equal(port.not_computed_mask, ref.not_computed_mask)
    np.testing.assert_array_equal(port.features, ref.features)
    ra_ref = ref.RefineApprox.astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(ra_ref), 1.0))
    assert np.all(np.abs(port.RefineApprox.astype(np.float32) - ra_ref) <= 4 * ulp)


def test_strings_levenshtein_budget():
    """Port copy of tests/test_annchor.py::test_strings_levenshtein_budget
    with the port's own torch generator: same set, knobs and budgets."""
    X, _ = make_strings(n=400, length=60, seed=1)
    bf = att.BruteForce(list(X), "levenshtein", device="cpu")
    bf.fit()
    ann = att.Annchor(
        list(X),
        "levenshtein",
        n_anchors=15,
        n_neighbors=15,
        n_samples=1000,
        p_work=0.15,
        niters=4,
        random_seed=42,
        device="cpu",
    )
    ann.fit()
    err = att.compare_neighbor_graphs(bf.neighbor_graph, ann.neighbor_graph, 15)
    assert err < 80
    assert ann.evals <= 1.4 * ann.p_work * ann.N + 2 * ann.n_samples


def test_bruteforce_matches_jax():
    X, _ = make_strings(n=120, length=30, seed=4)
    bf_t = att.BruteForce(list(X), "levenshtein", device="cpu")
    bf_t.fit()
    bf_j = at.BruteForce(list(X), "levenshtein")
    bf_j.fit()
    np.testing.assert_array_equal(bf_t.D, bf_j.D)
    np.testing.assert_array_equal(bf_t.neighbor_graph[0], bf_j.neighbor_graph[0])


def test_compare_neighbor_graphs_matches_jax():
    rng = np.random.default_rng(8)
    ngd = np.sort(rng.integers(0, 30, size=(50, 12)).astype(float), axis=1)
    ngi = np.argsort(rng.random((50, 12)), axis=1)
    bad = ngd.copy()
    bad[:17, 4] += 100.0
    for a, b in [((ngi, ngd), (ngi, ngd)), ((ngi, bad), (ngi, ngd)), ((ngi, ngd), (ngi, bad[:30]))]:
        assert att.compare_neighbor_graphs(a, b, 10) == at.compare_neighbor_graphs(a, b, 10)
    assert att.compare_neighbor_graphs((ngi, bad), (ngi, ngd), 10) == 17


def test_pickers_match_jax():
    X, _ = make_strings(n=80, length=30, seed=6)
    for Picker, args in [
        ("MaxMinAnchorPicker", ()),
        ("RandomAnchorPicker", ()),
        ("SelectedAnchorPicker", ([3, 9, 40],)),
        ("ExternalAnchorPicker", (["ACGTTGCA" * 3, "GATTACA" * 4, "TTTT"],)),
    ]:
        kw = dict(n_anchors=3, n_neighbors=5, n_samples=200, p_work=0.5)
        a = at.Annchor(list(X), "levenshtein", anchor_picker=getattr(at, Picker)(*args), **kw)
        b = att.Annchor(
            list(X), "levenshtein", anchor_picker=getattr(att, Picker)(*args),
            device="cpu", **kw,
        )
        a.get_anchors()
        b.get_anchors()
        np.testing.assert_array_equal(np.asarray(b.A), np.asarray(a.A))
        np.testing.assert_array_equal(b.D, a.D)
        assert a.evals == b.evals


def test_make_strings_matches_jax():
    a, ya = make_strings(n=50, length=20, seed=3, evolve=True)
    b, yb = jax_make_strings(n=50, length=20, seed=3, evolve=True)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ya, yb)


def test_load_strings_caches_bruteforce_graph(tmp_path, monkeypatch):
    import annchor_tpu_torch.datasets as ds

    small = make_strings(n=40, length=20, seed=2)
    monkeypatch.setattr(ds, "make_strings", lambda: small)
    first = load_strings(k=10, device="cpu", cache_dir=str(tmp_path))
    assert (tmp_path / "strings_gt_synth.npz").exists()
    bf = att.BruteForce(list(small[0]), "levenshtein", device="cpu")
    bf.fit()
    np.testing.assert_array_equal(first["neighbor_graph"][1], bf.neighbor_graph[1][:, :10])
    again = load_strings(k=5, device="cpu", cache_dir=str(tmp_path))
    np.testing.assert_array_equal(again["neighbor_graph"][0], first["neighbor_graph"][0][:, :5])


def test_unported_paths_raise():
    X, _ = make_strings(n=60, length=20, seed=1)
    ann = att.Annchor(
        list(X), "levenshtein", n_anchors=3, n_neighbors=5, n_samples=100,
        p_work=0.5, sampler=att.SimpleStratifiedSampler(n_partitions=5),
        device="cpu",
    )
    ann.sampler = type("Custom", (att.SimpleStratifiedSampler,), {})()
    with pytest.raises(NotImplementedError, match="host pipeline"):
        ann.fit()
    with pytest.raises(NotImplementedError, match="item 13"):
        att.Annchor(["a"] * 4097, "levenshtein", device="cpu")


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        att.Annchor(["ab", "abc", "b"], "levenshtein")


def test_tiny_dataset_exact_graph():
    """Data sets below the sampler's floor evaluate the remaining pool
    outright on the first iteration (port of tests/test_annchor.py::
    test_tiny_dataset_exact_graph): the graph comes out exact."""
    rng = np.random.default_rng(0)
    for n, na, k in [(4, 2, 2), (12, 5, 3)]:
        X = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(5, 15)))) for _ in range(n)]
        ann = att.Annchor(X, "levenshtein", n_anchors=na, n_neighbors=k, device="cpu")
        ann.fit()
        bf = att.BruteForce(X, "levenshtein", device="cpu")
        bf.fit()
        assert att.compare_neighbor_graphs(bf.neighbor_graph, ann.neighbor_graph, k) == 0
        assert not ann.not_computed_mask.any()


def test_user_evaluator_fit_matches_jax():
    """A user get_exact_ijs takes the host hops (the max-min host loop,
    host sample and refinement evals) in both packages."""
    X, _ = make_strings(n=150, length=40, seed=9)
    engine = att.get_function_from_input("levenshtein", device="cpu").batch
    calls = []

    def user_eval(f, X, IJ):
        calls.append(len(IJ))
        return engine(X, X, np.asarray(IJ))

    kw = dict(n_anchors=8, n_neighbors=8, n_samples=400, p_work=0.3,
              get_exact_ijs=user_eval)
    ref = at.Annchor(list(X), "levenshtein", **kw)
    ref.fit()
    n_ref_calls = len(calls)
    port = att.Annchor(
        list(X), "levenshtein", device="cpu", uniforms=_jax_uniforms, **kw
    )
    port.fit()
    assert port._dev_eval is None
    assert len(calls) == 2 * n_ref_calls
    np.testing.assert_array_equal(port.A, ref.A)
    assert port.evals == ref.evals
    assert att.compare_neighbor_graphs(port.neighbor_graph, ref.neighbor_graph, 8) == 0
