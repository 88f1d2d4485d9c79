"""Time K8, the Sinkhorn kernels, through their dispatch at the main
path's shapes and at large n beside their plain versions (and K8a's
plain version's float64 products), as the annchor_tpu_torch package of
one checkout has them; with ``--plans``, in each forced launch plan and
tile (the evidence behind ``sinkhorn_cuda.exp_plan``'s and
``log_plan``'s choices); with ``--fit``, K8b's device time in the
``wasserstein_sinkhorn`` fit of ``chip_smoke.py`` phase 11(c).

    python3 tools/time_k8.py [--root DIR] [--plans] [--fit] [--extra] [--no-k8a]

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
2,100 and 7,200 bins on 64 pairs at n_iter 2, each beside its plain
version (the mean of 3 calls after a warm-up) and ``library_ms``, the
plain version's float64 ``torch.mm`` alone, (2 n_iter + 2) products of
(B, n) by (n, n); ``--no-k8a`` skips K8a.  K8b
(``wasserstein.sinkhorn_batch``) on a 4,096-pair digits chunk at the
metric's n_iter 200 (seed 5; 5 calls), at 300 and 784 bins on 8,192 pairs
at n_iter 20 and at 14,401 bins on 2 pairs at n_iter 1 (random
histograms without the zero rows and an asymmetric cost, seed 7; 3
calls), each beside its plain version (1 call) and its expf bound
(``chip_smoke.EXPF_PER_S``); ``--extra`` adds few-pair batches, 1, 20
and 300 pairs at 192, 300 and 784 bins at n_iter 200, and 4,096 and
8,192 pairs at 192 and 224 bins at n_iter 20 (seed n).
``--plans`` then times K8a at n 64 in each plan (resident, and streamed
in tiles of 64, 32 and 16 columns) for a range of batches (numpy seed
6), 5 calls each, and the large-n K8a shapes in each streamed tile; and
K8b in each path and thread tile at n 64 (n_iter 200) for the batches of
the ``wasserstein_sinkhorn`` fit and the chunk, at 100 and 144 bins
(n_iter 20) on 4,096 pairs, at the large-n shapes and with ``--extra``
at its shapes.  ``--fit`` runs that
fit (300 digits) once to warm up and once under ``torch.profiler``
(``chip_smoke._device_profile``): its wall, K8b's device ms, kernels and
launches.  Prints the card as ``nvidia-smi``
names it, a line for each shape, and one JSON line {"root", "card",
"dispatch": {shape: ms}, "large": {shape: {"ms", "plain_ms",
"library_ms"}}, "k8b": {shape: {"ms", "plain_ms", "bound_ms"}}, "plans":
{B: {plan: ms}}, "tiles": {shape: {cols: ms}}, "log_plans": {shape:
{plan: ms}}, "fit": {...}}; ``chip_smoke`` is always this checkout's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCHES = (256, 1024, 1797, 2048, 4224, 6144, 8192, 16384)
LARGE = ((300, 8192, 20), (784, 8192, 20), (2100, 64, 2), (7200, 64, 2))
LOG_BATCHES = (20, 300, 2000, 3538, 4096, 8192)  # the fit's launches and the chunks
EXTRA = tuple((n, B, 200) for n in (192, 300, 784) for B in (1, 20, 300)) + tuple(
    (n, B, 20) for n in (192, 224) for B in (4096, 8192))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--fit", action="store_true")
    ap.add_argument("--extra", action="store_true")
    ap.add_argument("--no-k8a", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import importlib.util

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_k8: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from annchor_tpu_torch.datasets import digit_images, grid_cost_matrix
    from annchor_tpu_torch.ops import wasserstein as w

    card = cs._card(torch)
    X, _ = digit_images()
    M = grid_cost_matrix()
    report = {"root": os.path.abspath(args.root), "card": card}
    if not args.no_k8a:
        k8a(args, cs, np, torch, w, X, M, report)

    # K8b through its dispatch: the digits chunk, then large n
    leng = w.SinkhornEngine(M, device="cuda")
    Xu = torch.as_tensor(w.unit_mass(X), device="cuda")
    IJ = np.random.default_rng(5).integers(0, len(X), size=(4096, 2))
    shapes = {"chunk": ((Xu[IJ[:, 0]].contiguous(), Xu[IJ[:, 1]].contiguous(),
                         torch.as_tensor(leng.C, device="cuda"), leng.eps, leng.n_iter), 5)}
    rng = np.random.default_rng(7)
    for n, B, n_iter in cs.K8B_LARGE:
        Xr, Cr = cs._k8_random(np, n, 40, n)  # rows 0-15 are the zero and one-bin rows
        Xr = torch.as_tensor(w.unit_mass(Xr), device="cuda")
        IJ = rng.integers(16, len(Xr), size=(B, 2))
        shapes["n %d B %d" % (n, B)] = ((Xr[IJ[:, 0]].contiguous(), Xr[IJ[:, 1]].contiguous(),
                                         torch.as_tensor(Cr, device="cuda"),
                                         float(np.float32(0.02 * Cr.max())), n_iter), 3)
    for n, B, n_iter in EXTRA if args.extra else ():
        shapes["n %d B %d n_iter %d" % (n, B, n_iter)] = (
            _random_case(cs, np, torch, w, n, B, n_iter), 3)
    k8b = report["k8b"] = {}
    for name, (targs, reps) in shapes.items():
        B, n = (int(s) for s in targs[0].shape)
        k8b[name] = {"pairs": B, "n": n, "n_iter": targs[4],
                     "ms": cs._time(torch, lambda: w.sinkhorn_batch(*targs), reps),
                     "plain_ms": cs._time(torch, lambda: w.sinkhorn_batch_plain(*targs), 1),
                     "bound_ms": B * (2 * targs[4] + 1) * n * n / cs.EXPF_PER_S * 1e3}
        torch.cuda.empty_cache()
        print("K8b %-14s %5d pairs, n %5d, n_iter %3d: %.4f ms, plain %.3f ms, expf bound "
              "%.4f ms" % (name, B, n, targs[4], k8b[name]["ms"], k8b[name]["plain_ms"],
                           k8b[name]["bound_ms"]), flush=True)

    if args.plans:
        from annchor_tpu_torch.ops import sinkhorn_cuda as sc

        out = report["log_plans"] = {}
        cases = [("n 64 B %d" % B, 64, B, leng.n_iter) for B in LOG_BATCHES]
        cases += [("n %d B 4096" % n, n, 4096, 20) for n in (100, 144)]
        cases += [("n %d B %d" % (n, B), n, B, it) for n, B, it in cs.K8B_LARGE]
        cases += [("n %d B %d n_iter %d" % c, *c) for c in (EXTRA if args.extra else ())]
        for name, n, B, n_iter in cases:
            if n == 64:
                idx = np.random.default_rng(B).integers(0, len(X), size=(B, 2))
                targs = (Xu[idx[:, 0]].contiguous(), Xu[idx[:, 1]].contiguous(),
                         torch.as_tensor(leng.C, device="cuda"), leng.eps, n_iter)
            else:
                targs = shapes.get(name, (None,))[0] or _random_case(cs, np, torch, w, n, B,
                                                                     n_iter)
            row = out[name] = {}
            for path, tile in sc.log_plans(B, n):
                plan = sc.log_plan(B, n, path, tile)
                row["%s %dx%d" % (path, *tile)] = cs._time(
                    torch, lambda p=plan: sc.sinkhorn_log_cuda(*targs, _plan=p),
                    1 if n > 1000 else 3)
            print("K8b %s (plan: %s): %s" % (name, cs._log_plan_name(sc.log_plan(B, n)),
                                             ", ".join("%s %.4f ms" % kv for kv in row.items())),
                  flush=True)
            del targs
            torch.cuda.empty_cache()

    if args.fit:
        import annchor_tpu_torch as att

        def fit():
            ann = att.Annchor(X[:300], "wasserstein_sinkhorn", func_kwargs={"cost_matrix": M},
                              n_anchors=15, n_neighbors=10, n_samples=2000, p_work=0.3,
                              random_seed=42, device="cuda")
            ann.fit()
            return ann

        from annchor_tpu_torch.ops.sinkhorn_cuda import K8

        evals = fit().evals
        K8.reset_counts()
        prof = cs._device_profile(torch, fit)
        report["fit"] = {k: prof[k] for k in ("wall_s", "device_ms", "kernels", "k8b_device_ms",
                                              "k8b_kernels")}
        report["fit"].update(evals=int(evals), k8b_launches=K8.mode_launches["log"])
        print("fit wasserstein_sinkhorn 300 digits: %d evals, %.3f s profiled, device %.3f ms "
              "in %d kernels, K8b %.3f ms in %d kernels of %d launches" % (
                  evals, prof["wall_s"], prof["device_ms"], prof["kernels"],
                  prof["k8b_device_ms"], prof["k8b_kernels"], K8.mode_launches["log"]),
              flush=True)
    print(json.dumps(report))
    return 0


def _random_case(cs, np, torch, w, n, B, n_iter):
    Xr, Cr = cs._k8_random(np, n, 40, n)
    Xr = torch.as_tensor(w.unit_mass(Xr), device="cuda")
    IJ = np.random.default_rng(n).integers(16, len(Xr), size=(B, 2))
    return (Xr[IJ[:, 0]].contiguous(), Xr[IJ[:, 1]].contiguous(),
            torch.as_tensor(Cr, device="cuda"), float(np.float32(0.02 * Cr.max())), n_iter)


def k8a(args, cs, np, torch, w, X, M, report):
    """K8a's rows: through its dispatch, at large n, and with ``--plans``
    in each plan and tile."""
    eng = w.SinkhornExpEngine(M, device="cuda")
    Xd = eng._table(X)
    report["dispatch"] = {}
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
    for name, row in large.items():
        print("%s: %.3f ms, plain %.3f ms, its float64 products %.3f ms" % (
            name, row["ms"], row["plain_ms"], row["library_ms"]), flush=True)
    if not args.plans:
        return
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


if __name__ == "__main__":
    sys.exit(main())
