"""Time the edit-distance kernel K1 through its wrapper, ``myers_pairs``,
as the annchor_tpu_torch package of one checkout has it.

    python3 tools/time_k1_wrapper.py [--root DIR] [--label NAME]

``--root`` is the checkout whose package is imported (default: the one
holding this script), so two versions of the wrapper are compared by
running the script once per checkout on the same card, in the order
A, B, B, A (for example the parent commit unpacked with ``git archive``
into an ignored directory, and this tree).  The shapes: strings-1600's
anchor column, a 5,000-pair sample batch, a 58,707-pair refine batch and
BruteForce's 1,279,200 pairs; then the skewed set, strings-1600 plus one
2,100-character string, where K1 sizes its launches by the strings'
bulk: its anchor column, the column of the long string itself and its
BruteForce (1,280,800 pairs).  Random pairs come from numpy seed 2.
Each time is the mean of CUDA events around repeated calls after one
warm-up call.  Prints the card as ``nvidia-smi`` names it, then one JSON
line {"label", "card", "ms": {shape: ms}, "sums": {shape: sum of the
distances}}; two versions of an exact kernel print the same sums.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_k1_wrapper: no CUDA device", file=sys.stderr)
        return 2
    from annchor_tpu_torch.datasets import make_strings
    from annchor_tpu_torch.ops.levenshtein import encode_strings
    from annchor_tpu_torch.ops.levenshtein_myers import MyersEncoding, myers_pairs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    X = list(make_strings()[0])
    rng = np.random.default_rng(2)
    long_string = "".join(rng.choice(list("ACGT"), size=2100))
    enc = MyersEncoding.from_codes(*encode_strings(X), "cuda")
    skew = MyersEncoding.from_codes(*encode_strings(X + [long_string]), "cuda")
    n = len(X)

    def column(e, ix):
        return (torch.tensor(ix, device="cuda").expand(e.n),
                torch.arange(e.n, device="cuda"))

    def random_pairs(e, B):
        return (torch.as_tensor(rng.integers(0, e.n, size=B), device="cuda"),
                torch.as_tensor(rng.integers(0, e.n, size=B), device="cuda"))

    def triu(e):
        t = torch.triu_indices(e.n, e.n, 1, device="cuda")
        return t[0], t[1]

    shapes = {
        "anchor column": (enc, *column(enc, 1126), 50),
        "sample batch": (enc, *random_pairs(enc, 5_000), 50),
        "refine batch": (enc, *random_pairs(enc, 58_707), 20),
        "BruteForce": (enc, *triu(enc), 5),
        "skewed anchor column": (skew, *column(skew, 1126), 50),
        "skewed long-string column": (skew, *column(skew, n), 50),
        "skewed BruteForce": (skew, *triu(skew), 5),
    }
    ms, sums = {}, {}
    for name, (e, I, J, reps) in shapes.items():
        first = myers_pairs(e, I, J)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = myers_pairs(e, I, J)
        end.record()
        torch.cuda.synchronize()
        if not torch.equal(out, first):
            raise SystemExit("%s: repeated calls disagree" % name)
        ms[name] = start.elapsed_time(end) / reps
        sums[name] = int(first.long().sum())
        print("  %-26s %9d pairs  %10.4f ms" % (name, I.shape[0], ms[name]), flush=True)
    print(json.dumps({"label": args.label or os.path.abspath(args.root), "card": card,
                      "ms": ms, "sums": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
