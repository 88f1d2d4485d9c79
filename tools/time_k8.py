"""Time K8a, the exp-domain Sinkhorn kernel, through its dispatch and in
each of its tiles against the batch size (the evidence behind
``sinkhorn_cuda.EXP_MEDIUM_MIN``, the launch plan's one rule), then K8 at
large n beside its plain version, as the annchor_tpu_torch package of one
checkout has it.

    python3 tools/time_k8.py [--root DIR] [--dispatch-only]

``--root`` is the checkout whose package is imported (default: the one
holding this script), so two versions are compared by running the script
once per checkout on the same card, in the order A, B, B, A (for example
the parent commit unpacked with ``git archive`` into an ignored
directory, and this tree); ``--dispatch-only`` times only the first
part, which any version of the package has.  The data is the digits (n
64) with their grid cost at the scout's n_iter 300, as ``chip_smoke.py``
phase 5 times them.  First ``wasserstein.sinkhorn_exp_chunk`` on a
1,797-pair anchor column (row 1126 against all), 256 and 8,192 random
pairs (numpy seed 5), the mean of CUDA events around 20 calls after one
warm-up call.  Then for each batch of random pairs (numpy seed 6) the
kernel in each tile (RC 2, 4 and 8 output columns a thread, forced
through the wrapper's ``_plan``), 5 calls each.  Then, on random
histograms and an asymmetric cost (``chip_smoke._k8_random``), K8a with
K read from global memory: at 300 and 784 bins (28 x 28 images) on
8,192 pairs at n_iter 20, at 2,100 bins (two column passes) and 7,200
(u and v in global memory) on 64 pairs at n_iter 2; and K8b at 14,401
bins (the potentials in global memory) on 2 pairs at n_iter 1, each
beside its plain version (one call each after a warm-up).  Prints the
card as ``nvidia-smi`` names it, a line for each shape, and one JSON
line {"root", "card", "dispatch": {shape: ms}, "ms": {B: {rc: ms}},
"large": {shape: {"ms", "plain_ms"}}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = (256, 1024, 1797, 2048, 3072, 4224, 6144, 8192)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--dispatch-only", action="store_true")
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
    from annchor_tpu_torch.ops import sinkhorn_cuda as sc
    from annchor_tpu_torch.ops import wasserstein as w

    card = cs._card(torch)
    X, _ = digit_images()
    eng = w.SinkhornExpEngine(grid_cost_matrix(), device="cuda")
    Xd = eng._table(X)
    n = int(Xd.shape[1])
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
    if args.dispatch_only:
        print(json.dumps(report))
        return 0

    rng = np.random.default_rng(6)
    out = report["ms"] = {}
    for B in BATCHES:
        IJ = torch.as_tensor(rng.integers(0, Xd.shape[0], size=(B, 2)), device="cuda")
        targs = (Xd, Xd, IJ[:, 0], IJ[:, 1], eng._K, eng._KC, eng.n_iter, w.TINY)
        out[B] = {rc: cs._time(torch, lambda p=sc.exp_plan(B, n, rc): sc.sinkhorn_exp_cuda(
            *targs, _plan=p), 5) for rc in sc.EXP_MAX_THREADS}
        print("B %5d (plan: rc %d): %s" % (
            B, sc.exp_plan(B, n)["rc"], ", ".join("rc %d %.4f ms" % kv for kv in out[B].items())),
            flush=True)
    large = report["large"] = {}
    for n, B, n_iter in ((300, 8192, 20), (784, 8192, 20), (2100, 64, 2), (7200, 64, 2)):
        Xr, Cr = cs._k8_random(np, n, 200, n)
        er = w.SinkhornExpEngine(Cr, device="cuda")
        Xrd = er._table(Xr)
        IJ = torch.as_tensor(rng.integers(0, len(Xr), size=(B, 2)), device="cuda")
        targs = (Xrd, Xrd, IJ[:, 0], IJ[:, 1], er._K, er._KC, n_iter)
        large["K8a n %d B %d" % (n, B)] = {
            "ms": cs._time(torch, lambda: w.sinkhorn_exp_chunk(*targs), 1),
            "plain_ms": cs._time(torch, lambda: w.sinkhorn_exp_chunk_plain(*targs), 1)}
        del er, Xrd, targs
    n, B = 14_401, 2
    Xr, Cr = cs._k8_random(np, n, 40, n)  # rows 0-15 are the zero and one-bin rows
    Xu = torch.as_tensor(w.unit_mass(Xr), device="cuda")
    targs = (Xu[20:22].contiguous(), Xu[30:32].contiguous(), torch.as_tensor(Cr, device="cuda"),
             float(np.float32(0.02 * Cr.max())), 1)
    large["K8b n %d B %d" % (n, B)] = {
        "ms": cs._time(torch, lambda: w.sinkhorn_batch(*targs), 1),
        "plain_ms": cs._time(torch, lambda: w.sinkhorn_batch_plain(*targs), 1)}
    for name, row in large.items():
        print("%s: %.3f ms, plain %.3f ms" % (name, row["ms"], row["plain_ms"]), flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
