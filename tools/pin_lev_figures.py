"""Pin the JAX package's figures that ``chip_smoke.py`` phases 8(b), 9(c)
and 12(c) hold the port to: the JAX package's own fits on the CPU, on the
same data and with the same arguments.

    JAX_PLATFORMS=cpu python3 tools/pin_lev_figures.py --stage strings5k|alpha256

* ``strings5k``: ``make_strings(n=5000, n_clusters=16, length=200,
  mutation_rate=0.01, seed=42, evolve=True)`` with phase 9(a)'s
  arguments (``n_neighbors=15, p_work=0.05, random_seed=42``): (8b) the
  fit with a do-nothing ``SimpleStratifiedSampler`` subclass, which
  takes the host pipeline above 4,096 points, and (9c) the fit under
  ``ANNCHOR_TPU_BUILD_SCORE=rms``; evals and errors against the exact
  15-NN graph (``exact_knn``).  About 10-15 minutes on a CPU.
* ``alpha256``: strings-1600 over 256 code points
  (``make_strings(alphabet=chip_smoke.ALPHA256)``), phase 4's arguments
  (``n_neighbors=25, p_work=0.12, random_seed=42``): more than 192
  symbols, so every evaluation runs the row DP.  Its evals and errors
  against the exact 25-NN graph.  That graph comes from the bit-parallel
  oracle with the alphabet limit raised to 256 (edit distances do not
  depend on how symbols are encoded, and the row DP on a CPU would take
  far longer).

Prints one JSON line of figures.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _host_sampler(at):
    class HostSampler(at.SimpleStratifiedSampler):
        """A do-nothing subclass: custom strategy objects take the host
        pipeline."""

    return HostSampler()


def strings5k():
    import annchor_tpu as at
    from annchor_tpu.datasets import make_strings
    from annchor_tpu.exact import exact_knn

    X, _ = make_strings(n=5000, n_clusters=16, length=200, mutation_rate=0.01,
                        seed=42, evolve=True)
    X = list(X)
    kw = dict(n_neighbors=15, p_work=0.05, random_seed=42)
    os.environ["ANNCHOR_TPU_DISABLE_SHARDING"] = "1"
    t0 = time.perf_counter()
    host = at.Annchor(X, "levenshtein", sampler=_host_sampler(at), **kw)
    host.fit()
    host_s = time.perf_counter() - t0
    os.environ["ANNCHOR_TPU_BUILD_SCORE"] = "rms"
    t0 = time.perf_counter()
    rms = at.Annchor(X, "levenshtein", **kw)
    rms.fit()
    rms_s = time.perf_counter() - t0
    del os.environ["ANNCHOR_TPU_BUILD_SCORE"]
    gt = exact_knn(X, "levenshtein", k=15)
    return {"stage": "strings5k", "host_evals": int(host.evals), "host_m": int(host.IJs.shape[0]),
            "host_errors": int(at.compare_neighbor_graphs(gt, host.neighbor_graph, 15)),
            "host_fit_s": host_s, "rms_evals": int(rms.evals), "rms_m": int(rms._ij_dev[2]),
            "rms_errors": int(at.compare_neighbor_graphs(gt, rms.neighbor_graph, 15)),
            "rms_fit_s": rms_s}


def alpha256():
    import annchor_tpu as at
    import chip_smoke
    from annchor_tpu.datasets import make_strings
    from annchor_tpu.exact import exact_knn
    from annchor_tpu.ops import levenshtein_myers

    X, _ = make_strings(alphabet=chip_smoke.ALPHA256)
    X = list(X)
    t0 = time.perf_counter()
    ann = at.Annchor(X, "levenshtein", n_neighbors=chip_smoke.N_NEIGHBORS,
                     p_work=chip_smoke.P_WORK, random_seed=42)
    ann.fit()
    wall = time.perf_counter() - t0
    levenshtein_myers.MAX_ALPHABET = 256  # the oracle only: exact either way
    gt = exact_knn(X, "levenshtein", k=chip_smoke.N_NEIGHBORS)
    return {"stage": "alpha256", "evals": int(ann.evals),
            "errors": int(at.compare_neighbor_graphs(gt, ann.neighbor_graph,
                                                     chip_smoke.N_NEIGHBORS)),
            "anchors": [int(a) for a in ann.A[:5]], "fit_s": wall}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", choices=("strings5k", "alpha256"), required=True)
    args = ap.parse_args()
    print(json.dumps({"strings5k": strings5k, "alpha256": alpha256}[args.stage]()))


if __name__ == "__main__":
    main()
