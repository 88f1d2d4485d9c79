"""Time K8a, the exp-domain Sinkhorn kernel, through its dispatch at the
main path's shapes and at large n beside its plain version and the plain
version's float64 products, as the annchor_tpu_torch package of one
checkout has it; and, with ``--plans``, in each forced launch plan
and tile (the evidence behind ``sinkhorn_cuda.exp_plan``'s choices).

    python3 tools/time_k8.py [--root DIR] [--plans]

``--root`` is the checkout whose package is imported (default: the one
holding this script), so two versions are compared by running the script
once per checkout on the same card, in the order A, B, B, A (for example
the parent commit unpacked with ``git archive`` into an ignored
directory, and this tree); everything but ``--plans`` runs on any
version of the package.  The data: the digits (n 64) with their grid
cost at the scout's n_iter 300, as ``chip_smoke.py`` phase 5 times them,
``wasserstein.sinkhorn_exp_chunk`` on a 1,797-pair anchor column (row
1126 against all), 256 and 8,192 random pairs (numpy seed 5), the mean
of CUDA events around 20 calls after one warm-up call.  Then, on random
histograms and an asymmetric cost (``chip_smoke._k8_random``), K8a at
300 and 784 bins (28 x 28 images) on 8,192 pairs at n_iter 20 and at
2,100 and 7,200 bins on 64 pairs at n_iter 2, and K8b at 14,401 bins on 2
pairs at n_iter 1, each beside its plain version (the mean of 3 calls
after a warm-up); for K8a also ``library_ms``, the plain version's
float64 ``torch.mm`` alone, (2 n_iter + 2) products of (B, n) by (n, n).
``--plans`` then times K8a at n 64 in each plan (resident, and streamed
in tiles of 64, 32 and 16 columns) for a range of batches (numpy seed 6),
5 calls each, and the large-n K8a shapes in each streamed tile (the
evidence behind ``exp_plan``'s choice of tile).  Prints the card as
``nvidia-smi`` names it, a line for each shape, and one JSON line
{"root", "card", "dispatch": {shape: ms}, "large": {shape: {"ms",
"plain_ms", "library_ms"}}, "plans": {B: {plan: ms}}, "tiles": {shape:
{cols: ms}}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = (256, 1024, 1797, 2048, 4224, 6144, 8192, 16384)
LARGE = ((300, 8192, 20), (784, 8192, 20), (2100, 64, 2), (7200, 64, 2))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, HERE)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_k8: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from annchor_tpu_torch.datasets import digit_images, grid_cost_matrix
    from annchor_tpu_torch.ops import wasserstein as w

    card = cs._card(torch)
    X, _ = digit_images()
    eng = w.SinkhornExpEngine(grid_cost_matrix(), device="cuda")
    Xd = eng._table(X)
    report = {"root": os.path.abspath(args.root), "card": card, "dispatch": {}}
    rng = np.random.default_rng(5)
    for name, B in (("column", 1797), ("256 pairs", 256), ("chunk", 8192)):
        if name == "column":
            I, J = torch.tensor(1126, device="cuda").expand(B), torch.arange(B, device="cuda")
        else:
            IJ = torch.as_tensor(rng.integers(0, len(X), size=(B, 2)), device="cuda")
            I, J = IJ[:, 0], IJ[:, 1]
        report["dispatch"][name] = cs._time(torch, lambda: w.sinkhorn_exp_chunk(
            Xd, Xd, I, J, eng._K, eng._KC, eng.n_iter), 20)
        print("dispatch %-9s %5d pairs: %.4f ms" % (name, B, report["dispatch"][name]),
              flush=True)
    large = report["large"] = {}
    rng = np.random.default_rng(6)
    for n, B, n_iter in LARGE:
        Xr, Cr = cs._k8_random(np, n, 200, n)
        er = w.SinkhornExpEngine(Cr, device="cuda")
        Xrd = er._table(Xr)
        IJ = torch.as_tensor(rng.integers(0, len(Xr), size=(B, 2)), device="cuda")
        targs = (Xrd, Xrd, IJ[:, 0], IJ[:, 1], er._K, er._KC, n_iter)
        V = torch.rand((B, n), dtype=torch.float64, device="cuda")
        large["K8a n %d B %d" % (n, B)] = {
            "ms": cs._time(torch, lambda: w.sinkhorn_exp_chunk(*targs), 3),
            "plain_ms": cs._time(torch, lambda: w.sinkhorn_exp_chunk_plain(*targs), 3),
            "library_ms": (2 * n_iter + 2) * cs._time(torch, lambda: torch.mm(V, er._K), 3)}
        del er, Xrd, targs, V
    n, B = 14_401, 2
    Xr, Cr = cs._k8_random(np, n, 40, n)  # rows 0-15 are the zero and one-bin rows
    Xu = torch.as_tensor(w.unit_mass(Xr), device="cuda")
    targs = (Xu[20:22].contiguous(), Xu[30:32].contiguous(), torch.as_tensor(Cr, device="cuda"),
             float(np.float32(0.02 * Cr.max())), 1)
    large["K8b n %d B %d" % (n, B)] = {
        "ms": cs._time(torch, lambda: w.sinkhorn_batch(*targs), 1),
        "plain_ms": cs._time(torch, lambda: w.sinkhorn_batch_plain(*targs), 1)}
    for name, row in large.items():
        print("%s: %.3f ms, plain %.3f ms%s" % (
            name, row["ms"], row["plain_ms"],
            ", its float64 products %.3f ms" % row["library_ms"] if "library_ms" in row
            else ""), flush=True)
    del targs, Xu

    if args.plans:
        from annchor_tpu_torch.ops import sinkhorn_cuda as sc

        n = int(Xd.shape[1])
        plans = {"resident": ("resident",)}
        plans.update({"streamed %d" % c: ("streamed", c) for c in sc.STREAM_COLS})
        out = report["plans"] = {}
        for B in BATCHES:
            IJ = torch.as_tensor(rng.integers(0, Xd.shape[0], size=(B, 2)), device="cuda")
            targs = (Xd, Xd, IJ[:, 0], IJ[:, 1], eng._K, eng._KC, eng.n_iter, w.TINY)
            out[B] = {name: cs._time(torch, lambda p=sc.exp_plan(B, n, *spec):
                                     sc.sinkhorn_exp_cuda(*targs, _plan=p), 5)
                      for name, spec in plans.items()}
            print("B %5d: %s" % (B, ", ".join("%s %.4f ms" % kv for kv in out[B].items())),
                  flush=True)
        tiles = report["tiles"] = {}
        for n, B, n_iter in LARGE + ((784, 130, 20), (300, 64, 300)):
            Xr, Cr = cs._k8_random(np, n, 200, n)
            er = w.SinkhornExpEngine(Cr, device="cuda")
            Xrd = er._table(Xr)
            IJ = torch.as_tensor(rng.integers(0, len(Xr), size=(B, 2)), device="cuda")
            targs = (Xrd, Xrd, IJ[:, 0], IJ[:, 1], er._K, er._KC, n_iter, w.TINY)
            name = "K8a n %d B %d n_iter %d" % (n, B, n_iter)
            tiles[name] = {c: cs._time(torch, lambda p=sc.exp_plan(B, n, "streamed", c):
                                       sc.sinkhorn_exp_cuda(*targs, _plan=p), 3)
                           for c in sc.STREAM_COLS}
            print("%s (plan: %d columns): %s" % (
                name, sc.exp_plan(B, n)["cols"],
                ", ".join("%d columns %.3f ms" % kv for kv in tiles[name].items())), flush=True)
            del er, Xrd, targs
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
