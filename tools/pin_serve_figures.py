"""The JAX package's figures that chip_smoke.py's phase 10 is held to.

    JAX_PLATFORMS=cpu python3 tools/pin_serve_figures.py [--stage all|query|blobs|enemies5k]

Runs ``annchor_tpu`` on the CPU with the data and arguments of phase 10
(chip_smoke's own query mutator and ``make_blobs``) and prints:

* (a) the strings-1600 fit (``n_neighbors=25, p_work=0.12,
  random_seed=42``) queried with 1,000 substitution copies of strings
  0-999 (rate 0.05, ``default_rng(7)``) at ``nn=15, p_work=0.2``: the
  distance recall of the first 15 columns over the exact query rows
  and the share of queries whose first column is their source;
* (c) the blobs fit (``make_blobs(1000, 2, centers=5, seed=1)``,
  euclidean, ``n_anchors=12, n_neighbors=15, p_work=0.4,
  random_seed=42``): its evals, the nearest-enemy graph's evals and
  first-column accuracy against the exact nearest enemy, and the sizes
  of the selective subset and of ``alpha_rss``;
* (d) the strings-5000 scale-path fit (phase 9(a)'s arguments, on one
  device) with its cluster ids as labels: ``get_nearest_enemies(y,
  nn=3)``'s evals and the share of 500 rows (``default_rng(3)``) whose
  first enemy distance equals the exact nearest enemy, and the
  selective subset's size.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import annchor_tpu as at  # noqa: E402
import chip_smoke  # noqa: E402
from annchor_tpu.datasets import make_strings  # noqa: E402


def strings_query():
    X, _ = make_strings()
    X = list(X)
    t0 = time.perf_counter()
    ann = at.Annchor(X, "levenshtein", n_neighbors=25, p_work=0.12, random_seed=42)
    ann.fit()
    print("strings-1600 fit: %d evals, %.1f s" % (ann.evals, time.perf_counter() - t0),
          flush=True)
    Q = chip_smoke.mutate_strings(X[:1000], 0.05, 7)
    e0 = ann.evals
    t0 = time.perf_counter()
    ngi, ngd = ann.query(Q, nn=15, p_work=0.2)
    print("query: shape %s, %.1f s" % (ngi.shape, time.perf_counter() - t0), flush=True)
    geq = ann._get_exact_query_ijs_for(ann.f)
    nx, nq = len(X), len(Q)
    IJ = np.stack([np.tile(np.arange(nx), nq), np.repeat(np.arange(nq), nx)], axis=1)
    t0 = time.perf_counter()
    R = np.asarray(geq(ann.f, X, Q, IJ)).reshape(nq, nx)
    print("exact rows: %.1f s" % (time.perf_counter() - t0), flush=True)
    recall = chip_smoke.query_recall(ngi, R, 15)
    source = float(np.mean(ngi[:, 0] == np.arange(nq)))
    print("PIN strings-1600 query: distance recall %.6f, source recovered %.4f, "
          "fit evals %d (unchanged by the query: %s)" % (recall, source, ann.evals,
                                                          ann.evals == e0))


def blobs_extras():
    X, y = chip_smoke.make_blobs(1000, 2, 5, 1)
    ann = at.Annchor(X, "euclidean", n_anchors=12, n_neighbors=15, p_work=0.4,
                     random_seed=42)
    ann.fit()
    fit_evals = ann.evals
    ngi, ngd = ann.get_nearest_enemies(y, nn=3)
    enemy_evals = ann.evals - fit_evals
    D = np.linalg.norm(X[:, None] - X[None, :], axis=2)
    exact = np.array([D[i][y != y[i]].min() for i in range(len(X))])
    enemy_acc = float(np.isclose(ngd[:, 0], exact, rtol=1e-6).mean())
    ss = ann.annchor_selective_subset(y)
    rss = ann.alpha_rss(y)
    print("PIN blobs extras: fit evals %d, nearest-enemy evals %d, first-enemy accuracy "
          "%.4f, selective subset %d, alpha_rss %d" % (fit_evals, enemy_evals, enemy_acc,
                                                       len(ss), len(rss)))


def strings5k_enemies():
    X, y = make_strings(n=5000, n_clusters=16, length=200, mutation_rate=0.01, seed=42,
                        evolve=True)
    X = list(X)
    t0 = time.perf_counter()
    ann = at.Annchor(X, "levenshtein", n_neighbors=15, p_work=0.05, random_seed=42)
    ann.fit()
    fit_evals = ann.evals
    print("strings-5000 fit: %d evals, %.1f s" % (fit_evals, time.perf_counter() - t0),
          flush=True)
    ngi, ngd = ann.get_nearest_enemies(y, nn=3)
    enemy_evals = ann.evals - fit_evals
    ss = ann.annchor_selective_subset(y)
    rows = np.sort(np.random.default_rng(3).choice(len(X), 500, replace=False))
    geq = ann._get_exact_query_ijs_for(ann.f)
    Z = [X[r] for r in rows]
    IJ = np.stack([np.tile(np.arange(len(X)), len(Z)),
                   np.repeat(np.arange(len(Z)), len(X))], axis=1)
    R = np.asarray(geq(ann.f, X, Z, IJ)).reshape(len(Z), len(X))
    exact = np.where(y[None, :] != y[rows][:, None], R, np.inf).min(axis=1)
    acc = float(np.mean(ngd[rows, 0] == exact))
    print("PIN strings-5000 extras: nearest-enemy evals %d, first enemy exact for %.4f "
          "of the 500 rows (mean excess %.4f), selective subset %d"
          % (enemy_evals, acc, float(np.mean(ngd[rows, 0] - exact)), len(ss)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", default="all",
                    choices=("all", "query", "blobs", "enemies5k"))
    args = ap.parse_args()
    if args.stage in ("all", "blobs"):
        blobs_extras()
    if args.stage in ("all", "enemies5k"):
        strings5k_enemies()
    if args.stage in ("all", "query"):
        strings_query()


if __name__ == "__main__":
    main()
