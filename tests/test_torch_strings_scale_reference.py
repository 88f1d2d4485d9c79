"""The strings-100k configuration of the benchmark on the CPU: its data
generator at a small n, and a Levenshtein fit on the scale path (the
budgeted band build, the sparse state and the post-fit refinement) held
to the configuration's plain reference
(``knnbench/reference/levenshtein_scale.py``: the textbook DP), not to
the JAX package; its control reads not correct on the same rows; and
the K9a roofline's counting rule.

The fit runs on 300 evolve-mode strings of about 40 characters under
``ANNCHOR_TPU_FORCE_SPARSE``, with the constructor's defaults above 4,096
points passed explicitly (``loc_thresh`` 3, ``niters`` 4, ``refine_frac``
0.05), since below that size the constructor picks the dense ones.  At
that size the configuration's p_work of 0.01 is under the floor its
anchors and samples need, and the fit would spend the whole allowance,
leaving the refinement nothing; so the fit takes 8 anchors, 300 samples
and p_work 0.3, which leaves the refinement its 5 %.
"""

import collections
import json
import os

import numpy as np
import pytest
import torch

import annchor_tpu_torch as att
from annchor_tpu_torch import trace
from annchor_tpu_torch.ops import device_pipeline
from knnbench import counts_k9a, judge
from knnbench.generators import strings
from knnbench.reference import levenshtein, levenshtein_scale as ref

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 16  # rows judged against the reference
SMALL = {"n": 300, "length": 40, "n_clusters": 4}
SCALE_KNOBS = {"loc_thresh": 3, "niters": 4, "refine_frac": 0.05, "n_anchors": 8,
               "n_samples": 300, "p_work": 0.3}


def _json(rel):
    with open(os.path.join(ROOT, rel)) as fh:
        return json.load(fh)


CONFIG = _json("knnbench/configs/strings-100k.json")
CHECK = _json("knnbench/cells/strings-100k.fit.json")


def small_strings():
    return strings.make({**CONFIG["data"], **SMALL}, ROOT)


def small_fit(random_seed=42):
    """The configuration's fit of ``small_strings()`` on the scale path."""
    X = small_strings()
    mp = pytest.MonkeyPatch()
    mp.setenv("ANNCHOR_TPU_FORCE_SPARSE", "1")
    mp.setenv("ANNCHOR_TPU_DISABLE_SHARDING", "1")
    mp.setattr(device_pipeline, "MAX_FULL_MATRIX_NX", 64)
    try:
        ann = att.Annchor(X, CONFIG["metric"]["func"], random_seed=random_seed, device="cpu",
                          **{**CONFIG["annchor"], **SCALE_KNOBS})
        ann.fit()
    finally:
        mp.undo()
    return X, ann


@pytest.fixture(scope="module")
def fit():
    return small_fit()


@pytest.fixture(scope="module")
def rows(fit):
    X, _ = fit
    return np.sort(np.random.default_rng(7).choice(len(X), ROWS, replace=False))


def test_generator_keeps_the_configurations_shape():
    X = small_strings()
    big = CONFIG["data"]
    assert len(X) == SMALL["n"] and big["evolve"] and big["n"] == 100_000
    want, _ = strings.make_strings(SMALL["n"], SMALL["n_clusters"], SMALL["length"],
                                   big["mutation_rate"], big["alphabet"], big["data_seed"],
                                   evolve=True)
    assert X == want.tolist()
    assert set("".join(X)) <= set(big["alphabet"])


def test_fit_takes_the_budgeted_build_the_sparse_state_and_the_refinement(fit):
    _, ann = fit
    assert ann._dev.sparse
    assert ann._locality_info["build"] == "budgeted"
    stats = ann._refine_stats
    assert stats and stats[0]["stage"] == "certify"
    assert sum(s.get("evals", 0) for s in stats) > 0


def test_fit_against_the_reference(fit, rows):
    X, ann = fit
    ngi, ngd = ann.neighbor_graph
    k = ngi.shape[1]
    assert k == CONFIG["annchor"]["n_neighbors"]
    queries = [X[r] for r in rows]
    (true,), top = ref.judge(X, queries, [ngi[rows]], k, {})
    got = judge.numbers(ngi[rows], ngd[rows], ann._ng_exact[rows], true, top,
                        CHECK["match_tol"])
    assert got["dist_gap"] == 0 == CHECK["limits"]["dist_gap"]
    # the cell's limit: the check the benchmark makes at 100,000 strings,
    # set from readings there, holds here too
    assert got["miss_share"] <= CHECK["limits"]["miss_share"], got
    # every distance the graph marks exact is the DP's
    flags = ann._ng_exact[rows] & (ngi[rows] >= 0)
    assert flags.mean() > 0.9
    assert np.array_equal(ngd[rows][flags], true[flags])


def test_control_is_not_correct_on_the_same_rows(fit, rows):
    X, ann = fit
    k = CONFIG["annchor"]["n_neighbors"]
    queries = [X[r] for r in rows]
    ids, dists = ref.control(X, queries, k, {})
    (true,), top = ref.judge(X, queries, [ids], k, {})
    got = judge.numbers(ids, dists, None, true, top, CHECK["match_tol"])
    ok, _ = judge.verdict(got, CHECK["limits"])
    assert not ok and got["dist_gap"] > 0, got
    # the shortcut bounds the edit distance from above, exact without indels
    R = ref.prefix_hamming_rows(X, queries)
    exact = levenshtein.full_rows(X, queries)
    assert (R >= exact).all() and (R > exact).any()


def test_k9a_rule_and_reader(monkeypatch):
    from knnbench import harness

    # the 100k build's first band in the repo's kernels table: 13.9 M
    # admitted (row, column) pairs over both ends, 96 anchors, 0.0799 ms
    # (the table gives the pairs to three figures)
    assert counts_k9a.k9a_bound_s(13.9e6 / 2, 96) * 1e3 == pytest.approx(0.0799, rel=5e-3)
    mod = harness.Bench().module("layer_metrics", "k9a_roofline.fit")
    config = {"kernels": {"k9a": {"fragment": "k9a_", "anchors": 96}}}
    prof = {"kernel_s": {"void k9a_band<true>(Args)": 0.004, "k1_group": 1.0,
                         "void k9a_band<false>(Args)": 0.006}}
    records = {"profile": prof, "config": config}
    assert mod.read(records) is None  # no span recorded
    spans = []
    for i, counts in enumerate(({"m": 5, "admitted": 10**6, "bands": 2},
                                {"m": 5, "admitted": 3 * 10**6, "bands": 2})):
        r = trace.Span(i, "locality.budgeted", 0, None, 1, counts)
        r.end_ns = 10
        spans.append(r)
    monkeypatch.setattr(trace, "_records", collections.deque(spans))
    want = 100.0 * counts_k9a.k9a_bound_s(4 * 10**6, 96) / 0.010
    assert mod.read(records) == pytest.approx(want, rel=1e-12)
    # a program whose build span has no admitted count (the parent's) reads nothing
    del spans[1].counts["admitted"]
    assert mod.read(records) is None
