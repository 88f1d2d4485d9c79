"""Time the fits whose stages the dense tighten (K4) and the band build
(K9a) run, with their stage tables, as the annchor_tpu_torch package of
one checkout has them; or profile the 100k fit's pair build.

    python3 tools/time_fits.py [--root DIR] [--label NAME] [--profile-build]

``--root`` is the checkout whose package is imported (default: the one
holding this script), so two versions are compared by running the script
once per checkout on the same card, in the order A, B, B, A (for example
the parent commit unpacked with ``git archive`` into an ignored
directory, and this tree).  The fits, as ``chip_smoke.py`` runs them:
strings-1600 (phase 4's arguments), euclidean on 4,096 x 64 blobs (phase
6's, the JAX sample stream) and the 100,000-string default-constructor
fit (phase 9(b)'s), each after warm-up fits of strings-1600 and of 5,000
strings (phase 9(a)'s), which build every kernel they launch.  Each wall
is the host clock around ``fit()`` and a synchronise; the stage table is
the fit's own (``verbose=True``, synchronised per stage).  Prints the
card as ``nvidia-smi`` names it, the tables, and one JSON line {"label",
"card", "fits": {name: {"wall_s", "evals", "m", "stages": [[stage,
seconds], ...]}}}.

``--profile-build`` instead builds the 100,000-string fit's anchors, runs
its ``get_locality`` (the budgeted band build) twice, the first a
warm-up that builds K9a, and once more under ``torch.profiler``
(``chip_smoke._device_profile``): it prints the build's wall, the card's
busy time (the sum of its kernels' spans), its idle share of the
unprofiled wall and the kernels that take the most device time, and one
JSON line {"label", "card", "wall_s", "m", "pairs_sha256", "profile"}:
the hash of the pair list (its row and column ids as int32, in order)
shows two versions' builds equal.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_STAGE = re.compile(r"^\s*(\w+):\s+([\d.]+) \|")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--profile-build", action="store_true",
                    help="profile the 100k fit's get_locality instead of timing the fits")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("time_fits: no CUDA device", file=sys.stderr)
        return 2
    import annchor_tpu_torch as att
    from annchor_tpu_torch.datasets import make_strings
    from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms

    sys.path.insert(1, HERE)
    from chip_smoke import _device_profile, make_blobs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    label = args.label or args.root
    if args.profile_build:
        return _profile_build(torch, att, make_strings, _device_profile, card, label)

    X1600 = list(make_strings()[0])
    X5k = list(make_strings(n=5000, n_clusters=16, length=200, mutation_rate=0.01, seed=42,
                            evolve=True)[0])
    X64, _ = make_blobs(4096, 64, 10, 42)
    X100k = list(make_strings(n=100_000, n_clusters=32, length=400, mutation_rate=0.01,
                              seed=42, evolve=True)[0])
    kw1600 = dict(n_neighbors=25, p_work=0.12, random_seed=42)
    for X, kw in ((X1600, kw1600), (X5k, dict(n_neighbors=15, p_work=0.05,
                                                 random_seed=42))):
        att.Annchor(X, "levenshtein", device="cuda", **kw).fit()  # warm-up and builds
    torch.cuda.synchronize()

    fits = {}
    for name, X, metric, kw in (
        ("strings-1600", X1600, "levenshtein", kw1600),
        ("blobs 4096 x 64", X64, "euclidean",
         dict(n_neighbors=15, p_work=0.05, random_seed=42, uniforms=jax_threefry_uniforms)),
        ("strings-100k", X100k, "levenshtein",
         dict(n_neighbors=15, p_work=0.01, random_seed=42)),
    ):
        ann = att.Annchor(X, metric, device="cuda", verbose=True, **kw)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            ann.fit()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        stages = [[m.group(1), float(m.group(2))]
                  for m in map(_STAGE.match, out.getvalue().splitlines()) if m]
        m = int(ann._ij_dev[2]) if ann._ij_dev is not None else int(ann.IJs.shape[0])
        fits[name] = {"wall_s": wall, "evals": int(ann.evals), "m": m, "stages": stages}
        print("%s: %.3f s, %d evals, m %d" % (name, wall, ann.evals, m))
        for stage, sec in stages:
            print("  %-32s %7.3f" % (stage, sec))
        del ann
    print(json.dumps({"label": label, "card": card, "fits": fits}))
    return 0


def _profile_build(torch, att, make_strings, device_profile, card, label) -> int:
    """``--profile-build``: the 100k fit's ``get_locality`` timed, then
    profiled."""
    X = list(make_strings(n=100_000, n_clusters=32, length=400, mutation_rate=0.01, seed=42,
                          evolve=True)[0])
    ann = att.Annchor(X, "levenshtein", n_neighbors=15, p_work=0.01, random_seed=42,
                      device="cuda")
    ann.get_anchors()
    for run in ("warm-up", "timed"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ann.get_locality()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print("get_locality (%s): %.3f s, m %d" % (run, wall, ann._ij_dev[2]), flush=True)
    prof = device_profile(torch, ann.get_locality)
    print("profiled get_locality: %.3f s wall; device busy %.3f ms in %d kernels, %.1f %% "
          "idle over the unprofiled run's %.3f s; K9a %.3f ms in %d" % (
              prof["wall_s"], prof["device_ms"], prof["kernels"],
              100 * (1 - prof["device_ms"] / (wall * 1e3)), wall, prof["k9a_device_ms"],
              prof["k9a_kernels"]))
    for name, ms, n in prof["top"]:
        print("  %9.3f ms in %6d  %s" % (ms, n, name))
    ij_i, ij_j, m = ann._ij_dev[:3]
    digest = hashlib.sha256(ij_i.to(torch.int32).cpu().numpy().tobytes())
    digest.update(ij_j.to(torch.int32).cpu().numpy().tobytes())
    print("pair list: m %d, sha256 %s" % (m, digest.hexdigest()))
    print(json.dumps({"label": label, "card": card, "wall_s": wall, "m": m,
                      "pairs_sha256": digest.hexdigest(), "profile": prof}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
