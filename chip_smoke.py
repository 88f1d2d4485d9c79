"""Smoke run of the PyTorch/CUDA port (annchor_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path once, as a user would: the strings-1600
Levenshtein fit, ``Annchor(X, "levenshtein", n_neighbors=25,
p_work=0.12, random_seed=42)`` on the synthetic 1600-string set, scored
against the exact graph from the port's own ``BruteForce``.  Phases, each
of which exits non-zero when it fails:

1. device: the card's name and power limit, and the build of every
   kernel of the path from the sources in this checkout;
2. kernel check: the CUDA edit-distance kernel (K1) against its plain
   PyTorch version, bit for bit, on 71,200 pairs (empty strings, word
   boundaries, alphabets 2/4/26, the strings-1600 shapes, patterns of
   more than 64 words), then against the pure-Python DP on 64 sampled
   strings-1600 pairs, then a small fit on the card against the same
   fit on the CPU;
3. exact graph: ``BruteForce`` on strings-1600 (1,279,200 pairs);
4. fit: one warm-up fit, then one timed fit with the stage table, which
   must launch K1 and stay within the evaluation budget; then the same
   fit drawing its samples from the JAX package's stream
   (``jax_threefry_uniforms``), which must spend exactly the JAX
   package's evals on this set and score no more errors against the
   exact graph than the JAX package does;
5. timing: K1 against the plain version with CUDA events at the main
   path's batch shapes.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Details go to build/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

N_NEIGHBORS = 25
P_WORK = 0.12
# The JAX package's fit of this synthetic set (annchor_tpu.Annchor with
# the same arguments, on the CPU): its evals and its errors against the
# exact graph.  The set's star-shaped clusters put every intra-cluster
# distance in one narrow band, so it is far harder than the reference's
# bundled strings (158,716 evals, 0 errors there); the sampler's bins
# run short, hence fewer than 2 x 5,000 sample evals.
REFERENCE_EVALS = 157_793
REFERENCE_ERRORS = 1_297
REFINE_BATCH = 58_707  # the first refinement batch of that fit


def _phase(name):
    print("== %s" % name, flush=True)


def _card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return smi


def _random_strings(rng, n, lo, hi, alphabet):
    chars = list(alphabet)
    return [
        "".join(rng.choice(chars, size=int(rng.integers(lo, hi + 1))))
        for _ in range(n)
    ]


def _check_k1(torch, np, X):
    """K1 against the plain version on CUDA tensors, bit for bit.
    Returns (pairs compared, max |K1 - plain|)."""
    from annchor_tpu_torch.ops.levenshtein import encode_strings
    from annchor_tpu_torch.ops.levenshtein_myers import (
        MyersEncoding,
        myers_pairs,
        myers_pairs_plain,
    )

    rng = np.random.default_rng(0)
    cases = []
    for alphabet in ("ab", "ACGT", "abcdefghijklmnopqrstuvwxyz"):
        strs = _random_strings(rng, 256, 0, 140, alphabet)
        strs[:7] = ["", "a" * 33] + [
            "".join(rng.choice(list(alphabet), size=k)) for k in (31, 32, 33, 64, 65)
        ]
        cases.append((alphabet, strs, 16_384))
    cases.append(("strings-1600", list(X), 20_000))
    cases.append(("W>64", _random_strings(rng, 48, 2100, 2300, "ACGT"), 2_048))
    total, worst = 0, 0
    for name, strs, npairs in cases:
        enc = MyersEncoding.from_codes(*encode_strings(strs), "cuda")
        n = len(strs)
        I = torch.as_tensor(rng.integers(0, n, size=npairs), device="cuda")
        J = torch.as_tensor(rng.integers(0, n, size=npairs), device="cuda")
        I[: min(n, npairs)] = torch.arange(min(n, npairs), device="cuda")
        got = myers_pairs(enc, I, J)
        want = myers_pairs_plain(enc, I, J)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        print("  K1 vs plain  %-14s W=%-3d pairs=%-6d max|diff|=%d"
              % (name, enc.W, npairs, err), flush=True)
        if err != 0:
            raise SystemExit("K1 disagrees with its plain version on %s" % name)
        total += npairs
        worst = max(worst, err)
    return total, worst


def _check_oracle(torch, np, X):
    """K1 against the pure-Python DP on 64 sampled strings-1600 pairs."""
    from annchor_tpu_torch.ops.levenshtein import encode_strings, levenshtein_scalar
    from annchor_tpu_torch.ops.levenshtein_myers import MyersEncoding, myers_pairs

    rng = np.random.default_rng(1)
    enc = MyersEncoding.from_codes(*encode_strings(list(X)), "cuda")
    I = rng.integers(0, len(X), size=64)
    J = rng.integers(0, len(X), size=64)
    got = myers_pairs(
        enc, torch.as_tensor(I, device="cuda"), torch.as_tensor(J, device="cuda")
    ).tolist()
    want = [levenshtein_scalar(X[i], X[j]) for i, j in zip(I, J)]
    if got != want:
        raise SystemExit("K1 disagrees with the scalar oracle")
    print("  K1 vs scalar oracle: 64 strings-1600 pairs equal", flush=True)


def _check_small_fit(torch, np):
    """A small fit on the card equals the same fit on the CPU."""
    from annchor_tpu_torch import Annchor
    from annchor_tpu_torch.datasets import make_strings
    from annchor_tpu_torch.ops.device_pipeline import default_uniforms

    X, _ = make_strings(n=300, length=60, seed=7)
    kw = dict(n_anchors=12, n_neighbors=10, n_samples=800, p_work=0.3)

    def uniforms(seed, loop, m, device):
        return default_uniforms(seed, loop, m, "cpu").to(device)

    fits = []
    for dev in ("cpu", "cuda"):
        ann = Annchor(list(X), "levenshtein", device=dev, uniforms=uniforms, **kw)
        ann.fit()
        fits.append(ann)
    a, b = fits
    same = (
        np.array_equal(a.A, b.A)
        and a.evals == b.evals
        and np.array_equal(a.neighbor_graph[0], b.neighbor_graph[0])
        and np.array_equal(a.neighbor_graph[1], b.neighbor_graph[1])
    )
    if not same:
        raise SystemExit("the small fit differs between the card and the CPU")
    print("  small fit (n=300): card == CPU, %d evals" % b.evals, flush=True)


def _time(torch, fn, reps):
    """Mean ms per call, by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timings(torch, np, X, IJs):
    """K1 (through its wrapper, as the fit calls it) and the plain
    version at the main path's batch shapes."""
    from annchor_tpu_torch.ops.levenshtein import encode_strings
    from annchor_tpu_torch.ops.levenshtein_myers import (
        MyersEncoding,
        myers_pairs,
        myers_pairs_plain,
    )

    enc = MyersEncoding.from_codes(*encode_strings(list(X)), "cuda")
    rng = np.random.default_rng(2)
    n = len(X)
    ij = torch.as_tensor(IJs.astype(np.int64), device="cuda")
    shapes = {
        "anchor column (1,600 pairs)": (
            torch.full((n,), 1126, device="cuda"), torch.arange(n, device="cuda"), 20, 3),
        "sample batch (5,000 pairs)": (
            *ij[torch.as_tensor(rng.choice(len(IJs), 5000, replace=False))].T, 20, 2),
        "refine batch (58,707 pairs)": (
            *ij[torch.as_tensor(rng.choice(len(IJs), REFINE_BATCH, replace=False))].T,
            10, 1),
        "BruteForce (1,279,200 pairs)": (
            *torch.triu_indices(n, n, 1, device="cuda"), 3, 1),
    }
    rows = {}
    for name, (I, J, reps, plain_reps) in shapes.items():
        I, J = I.contiguous(), J.contiguous()
        ms = _time(torch, lambda: myers_pairs(enc, I, J), reps)
        plain_ms = _time(torch, lambda: myers_pairs_plain(enc, I, J), plain_reps)
        rows[name] = {"pairs": int(I.shape[0]), "ms": ms, "plain_ms": plain_ms}
        print("  %-30s K1 %10.3f ms   plain %10.3f ms" % (name, ms, plain_ms), flush=True)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    import annchor_tpu_torch as att
    from annchor_tpu_torch.datasets import make_strings
    from annchor_tpu_torch.ops.levenshtein_cuda import K1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}

    _phase("1. device")
    report["card"] = _card(torch)
    kind = torch.cuda.get_device_name(0)
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda, kind))
    t0 = time.perf_counter()
    K1.lib()
    report["k1_build_s"] = time.perf_counter() - t0
    print("  built %s in %.3f s" % (K1.name, report["k1_build_s"]))
    for line in K1.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("   ", line.strip())

    _phase("2. kernel check")
    X, _ = make_strings()
    X = list(X)
    report["k1_check_pairs"], max_err = _check_k1(torch, np, X)
    _check_oracle(torch, np, X)
    _check_small_fit(torch, np)

    _phase("3. exact graph")
    t0 = time.perf_counter()
    bf = att.BruteForce(X, "levenshtein", device="cuda")
    bf.fit()
    report["bruteforce_s"] = time.perf_counter() - t0
    gt = bf.neighbor_graph
    print("  BruteForce: %d x %d distances in %.3f s"
          % (len(X), len(X), report["bruteforce_s"]), flush=True)

    _phase("4. fit")
    from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms

    kw = dict(n_neighbors=N_NEIGHBORS, p_work=P_WORK, random_seed=42, device="cuda")
    att.Annchor(X, "levenshtein", **kw).fit()  # warm-up
    torch.cuda.synchronize()

    ann = att.Annchor(X, "levenshtein", verbose=True, **kw)
    K1.launches = 0
    t0 = time.perf_counter()
    ann.fit()
    torch.cuda.synchronize()
    report["fit_s"] = time.perf_counter() - t0
    launches = K1.launches
    errors = att.compare_neighbor_graphs(ann.neighbor_graph, gt, N_NEIGHBORS)
    ngi, ngd = ann.neighbor_graph
    report.update(evals=int(ann.evals), errors=int(errors), k1_launches=launches,
                  anchors=[int(a) for a in ann.A[:5]], m=int(ann.IJs.shape[0]))
    print("  fit: %.3f s, %d evals, %d errors, K1 launches %d, anchors %s..."
          % (report["fit_s"], ann.evals, errors, launches, report["anchors"]),
          flush=True)
    if launches == 0:
        raise SystemExit("the fit never launched K1")
    if ann.evals > 1.4 * P_WORK * ann.N + 2 * 5000:
        raise SystemExit("the fit overspent: %d evals" % ann.evals)
    if errors > 2 * REFERENCE_ERRORS:
        raise SystemExit("%d errors against the exact graph" % errors)
    if ngi.shape != (len(X), N_NEIGHBORS) or not np.isfinite(ngd).all():
        raise SystemExit("graph of shape %s or with non-finite distances" % (ngi.shape,))

    # the same fit drawing the JAX package's samples must reproduce the
    # JAX package's result on this set
    ref = att.Annchor(X, "levenshtein", uniforms=jax_threefry_uniforms, **kw)
    t0 = time.perf_counter()
    ref.fit()
    torch.cuda.synchronize()
    report["jax_stream_fit_s"] = time.perf_counter() - t0
    ref_errors = att.compare_neighbor_graphs(ref.neighbor_graph, gt, N_NEIGHBORS)
    report.update(jax_stream_evals=int(ref.evals), jax_stream_errors=int(ref_errors))
    print("  fit with the JAX sample stream: %.3f s, %d evals (JAX package: %d), "
          "%d errors (JAX package: %d)" % (report["jax_stream_fit_s"], ref.evals,
                                           REFERENCE_EVALS, ref_errors,
                                           REFERENCE_ERRORS), flush=True)
    if ref.evals != REFERENCE_EVALS:
        raise SystemExit("fit spent %d evals, the JAX package %d"
                         % (ref.evals, REFERENCE_EVALS))
    if ref_errors > REFERENCE_ERRORS:
        raise SystemExit("%d errors against the exact graph, the JAX package %d"
                         % (ref_errors, REFERENCE_ERRORS))

    _phase("5. timing (%s)" % report["card"])
    report["k1_timing"] = _timings(torch, np, X, ann.IJs)
    refine = report["k1_timing"]["refine batch (58,707 pairs)"]

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps({"kernels": [{
        "name": "levenshtein_myers (K1)",
        "route": "cuda",
        "source": "annchor_tpu_torch/csrc/levenshtein_myers.cu",
        "replaces": "annchor_tpu/ops/levenshtein_pallas.py:63",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": refine["ms"],
        "plain_ms": refine["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
