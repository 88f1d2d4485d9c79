"""Pin the JAX package's figures that ``chip_smoke.py`` phase 11 holds the
port to: the JAX package's own fits on the CPU, on the same data and
with the same arguments.

    JAX_PLATFORMS=cpu python3 tools/pin_hybrid_figures.py --stage digits|graph|digits-large

* ``digits``: the digits-1797 scout/certify hybrid (BENCHMARKS.md's
  protocol): ``Annchor(X, "wasserstein", func_kwargs={"cost_matrix":
  grid_cost_matrix(), "scout": "sinkhorn"}, n_anchors=25,
  n_neighbors=25, n_samples=5000, p_work=0.16, random_seed=42)`` on the
  1,797 digits, scored against the exact EMD graph (``BruteForce``):
  exact and scout calls, errors, wall.  A few minutes on a CPU.
* ``graph``: graph-sp on the 796-vertex component of ``make_graph()``,
  ``Annchor(X, GraphShortestPathMetric(A), n_anchors=20,
  n_neighbors=15, p_work=0.15, random_seed=42)``: evals and errors
  against the exact graph.  Seconds.
* ``digits-large``: the digits-5620 hybrid (BENCHMARKS.md's
  ``digits_large`` protocol): ``Annchor(X, "wasserstein", func_kwargs=
  {"cost_matrix": grid_cost_matrix(), "scout": "sinkhorn"},
  n_anchors=30, n_neighbors=25, p_work=0.1, random_seed=42)`` on
  ``load_digits_large()``, scored against its stored exact 100-NN graph
  at k = 25: exact and scout calls, errors, the admitted pair count m,
  the largest difference of a reported distance from the exact EMD,
  wall; once with the constructor's defaults above 4,096 points
  (loc_thresh 3, niters 4) and once with the reference's own
  (``loc_thresh=1, niters=2``).  Non-metric above 4,096 points, so the
  admit-everything build.  About 15-20 minutes on a CPU.

Prints one JSON line of figures.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def digits():
    import annchor_tpu as at
    from annchor_tpu.datasets import grid_cost_matrix
    from annchor_tpu_torch.datasets import digit_images

    X, _ = digit_images()
    M = grid_cost_matrix()
    t0 = time.perf_counter()
    ann = at.Annchor(X, "wasserstein", func_kwargs={"cost_matrix": M, "scout": "sinkhorn"},
                     n_anchors=25, n_neighbors=25, n_samples=5000, p_work=0.16,
                     random_seed=42)
    ann.fit()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    bf = at.BruteForce(X, "wasserstein", func_kwargs={"cost_matrix": M})
    bf.fit()
    bf_s = time.perf_counter() - t0
    ngi, ngd = ann.neighbor_graph
    exact = float(np.abs(ngd - bf.D[np.arange(len(X))[:, None], ngi]).max())
    return {"stage": "digits", "evals": int(ann.evals), "scout_evals": int(ann.scout_evals),
            "errors": int(at.compare_neighbor_graphs(bf.neighbor_graph, ann.neighbor_graph, 25)),
            "max_abs_err_reported": exact, "anchors": [int(a) for a in ann.A[:5]],
            "fit_s": wall, "bruteforce_s": bf_s}


def graph():
    from scipy.sparse.csgraph import connected_components

    import annchor_tpu as at
    from annchor_tpu.datasets import make_graph
    from annchor_tpu.graph_sp import GraphShortestPathMetric
    from annchor_tpu_torch.datasets import graph_adjacency

    edges, weights, y = make_graph()
    A = graph_adjacency(len(y), edges, weights)
    _, labels = connected_components(A, directed=False)
    X = np.flatnonzero(labels == np.argmax(np.bincount(labels)))
    t0 = time.perf_counter()
    ann = at.Annchor(X, GraphShortestPathMetric(A), n_anchors=20, n_neighbors=15,
                     p_work=0.15, random_seed=42)
    ann.fit()
    wall = time.perf_counter() - t0
    bf = at.BruteForce(X, GraphShortestPathMetric(A))
    bf.fit()
    return {"stage": "graph", "n": int(X.shape[0]), "evals": int(ann.evals),
            "errors": int(at.compare_neighbor_graphs(bf.neighbor_graph, ann.neighbor_graph, 15)),
            "fit_s": wall}


def digits_large():
    import annchor_tpu as at
    from annchor_tpu import native
    from annchor_tpu.datasets import load_digits_large

    d = load_digits_large()
    X, M = d["X"], d["cost_matrix"]
    gi, gd = d["neighbor_graph"]
    os.environ["ANNCHOR_TPU_DISABLE_SHARDING"] = "1"
    out = {"stage": "digits-large"}
    # the constructor's defaults above 4,096 points (loc_thresh 3, niters
    # 4), then the reference's own (loc_thresh 1, niters 2)
    for name, knobs in (("scale_defaults", {}), ("reference_knobs", {"loc_thresh": 1, "niters": 2})):
        t0 = time.perf_counter()
        ann = at.Annchor(X, "wasserstein", func_kwargs={"cost_matrix": M, "scout": "sinkhorn"},
                         n_anchors=30, n_neighbors=25, p_work=0.1, random_seed=42, **knobs)
        ann.fit()
        wall = time.perf_counter() - t0
        ngi, ngd = ann.neighbor_graph
        rows = np.repeat(np.arange(len(X)), ngi.shape[1])
        exact = native.emd_batch(X, X, M, rows, ngi.reshape(-1)).reshape(ngi.shape)
        out[name] = {
            "evals": int(ann.evals), "scout_evals": int(ann.scout_evals),
            "m": int(ann._ij_dev[2]),
            "errors": int(at.compare_neighbor_graphs((gi[:, :25], gd[:, :25]),
                                                     ann.neighbor_graph, 25)),
            "max_abs_err_reported": float(np.abs(ngd - exact).max()),
            "anchors": [int(a) for a in ann.A[:5]], "fit_s": wall}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", choices=("digits", "graph", "digits-large"), required=True)
    args = ap.parse_args()
    print(json.dumps({"digits": digits, "graph": graph,
                      "digits-large": digits_large}[args.stage]()))


if __name__ == "__main__":
    main()
