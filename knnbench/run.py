"""Run one cell of the benchmark once and print its result as the last
line of standard output.

    python3 knnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  With ``--trace 0`` the result's metrics
are the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from a profiled window.  The numbers that decide
``correct`` are printed beside their limits as the last lines of
standard error and under the result's last key, ``checks``.  Exits
non-zero without a result when the cell's cards are missing, or when a
module of JAX or of the JAX package is loaded.
"""

import os
import time

_T0 = time.monotonic()


def _process_age():
    """Seconds since this process started (Linux; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout (the
    # program's own nvcc and g++ builds go to build/kernels and build/native)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    sys.path.insert(0, ROOT)
    import torch

    from knnbench import harness

    bench = harness.Bench()
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("knnbench: the cell needs %d CUDA device(s); torch sees %s" % (
            chips, torch.cuda.device_count() if torch.cuda.is_available() else "none"),
            file=sys.stderr)
        return 2
    result, rows, _ = harness.run_cell(
        bench, args.workload, args.seed, args.seconds, args.trace, device="cuda",
        started=lambda: _AGE0 + time.monotonic() - _T0)
    found = harness.forbidden_modules()
    if found:
        print("knnbench: modules of JAX or the JAX package were loaded: %s" % ", ".join(found),
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, v, lim in rows:
        print("check %s: %r (limit %r)" % (name, v, lim), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
