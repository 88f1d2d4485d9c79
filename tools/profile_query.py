"""Where one ``Annchor.query`` call's time goes, on one NVIDIA card.

    python3 tools/profile_query.py [--scale]

Fits strings-1600 with chip_smoke.py phase 4's arguments (the JAX sample
stream) and queries 1,000 substitution copies of strings 0-999 (phase
10(a)); with ``--scale`` also the 100,000-string default-constructor fit
and 500 copies of 500 of its strings (phase 10(e)).  Each query runs
once to warm up, once timed, once under ``torch.profiler`` for the
device kernel time (its share of the timed wall: the card's busy
share), and once under ``cProfile`` for the host functions that take
the most time.
"""

from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import annchor_tpu_torch as att  # noqa: E402
import chip_smoke  # noqa: E402
from annchor_tpu_torch.datasets import make_strings  # noqa: E402
from annchor_tpu_torch.ops.device_pipeline import jax_threefry_uniforms  # noqa: E402


def profile(label, ann, Q, nn, p_work, top=14):
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    ann.query(Q, nn=nn, p_work=p_work)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ann.query(Q, nn=nn, p_work=p_work)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ann.query(Q, nn=nn, p_work=p_work)
        torch.cuda.synchronize()
    dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    k1_us = sum(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA and "k1_" in e.name)
    # the profiler slows the host side several-fold, so the busy share
    # is taken against the unprofiled wall
    print("%s: %d queries, wall %.4f s; under torch.profiler, device kernels %.3f ms "
          "(%.2f %% of that wall), K1 %.3f ms" % (label, len(Q), wall, dev_us / 1e3,
                                                  100 * dev_us / 1e6 / wall, k1_us / 1e3),
          flush=True)
    pr = cProfile.Profile()
    pr.enable()
    ann.query(Q, nn=nn, p_work=p_work)
    torch.cuda.synchronize()
    pr.disable()
    st = pstats.Stats(pr)
    total = sum(v[2] for v in st.stats.values())
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    print("  host, cProfile (%.3f s of own time in all): own s, cumulative s, calls, "
          "function" % total)
    for (fn, line, name), (cc, nc, tt, ct, _) in rows:
        print("  %8.3f %8.3f %7d  %s:%d %s" % (tt, ct, nc, os.path.basename(fn), line, name))
    sys.stdout.flush()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_query: no CUDA device")
    print(torch.cuda.get_device_name(0), flush=True)
    X, _ = make_strings()
    X = list(X)
    ann = att.Annchor(X, "levenshtein", n_neighbors=25, p_work=0.12, random_seed=42,
                      device="cuda", uniforms=jax_threefry_uniforms)
    ann.fit()
    profile("strings-1600", ann, chip_smoke.mutate_strings(X[:1000], 0.05, 7), 15, 0.2)
    if args.scale:
        big, _ = make_strings(n=100_000, n_clusters=32, length=400, mutation_rate=0.01,
                              seed=42, evolve=True)
        big = list(big)
        ann = att.Annchor(big, "levenshtein", n_neighbors=15, p_work=0.01,
                          random_seed=42, device="cuda")
        ann.fit()
        src = np.random.default_rng(11).choice(len(big), 500, replace=False)
        Q = chip_smoke.mutate_strings([big[i] for i in src], 0.01, 11)
        profile("strings-100k", ann, Q, 15, 0.01)


if __name__ == "__main__":
    main()
