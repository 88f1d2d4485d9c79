"""Time K10, the edit-distance kernel over more than 192 symbols, through
the Levenshtein entry point ``myers_pairs``, as the annchor_tpu_torch
package of one checkout has it.

    python3 tools/time_k10.py [--root DIR] [--label NAME]

``--root`` is the checkout whose package is imported (default: the one
holding this script), so two versions of the kernel are compared by
running the script once per checkout on the same card, in the order A,
B, B, A (for example the parent commit unpacked with ``git archive``
into an ignored directory, and this tree).  The data is strings-1600
over 256 code points (``make_strings(alphabet=...)``, as
``chip_smoke.py`` phase 12(c)); the shapes: a 58,707-pair refine batch
(random pairs, numpy seed 12), the anchor column of string 1126 and
BruteForce's 1,279,200 pairs.  Each time is the mean of CUDA events
around repeated calls after one warm-up call.  Prints the card as
``nvidia-smi`` names it, then one JSON line {"label", "card", "ms":
{shape: ms}, "sums": {shape: sum of the distances}}; two versions of an
exact kernel print the same sums.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHA256 = "".join(map(chr, range(0x100, 0x200)))
REFINE_BATCH = 58_707


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_k10: no CUDA device", file=sys.stderr)
        return 2
    from annchor_tpu_torch.datasets import make_strings
    from annchor_tpu_torch.ops.levenshtein import RowDPEncoding, encode_strings
    from annchor_tpu_torch.ops.levenshtein_myers import MyersEncoding, myers_pairs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    X = list(make_strings(alphabet=ALPHA256)[0])
    enc = MyersEncoding.from_codes(*encode_strings(X), "cuda")
    if not isinstance(enc, RowDPEncoding):
        raise SystemExit("256 symbols did not give K10's encoding")
    n = len(X)
    rng = np.random.default_rng(12)
    tri = torch.triu_indices(n, n, 1, device="cuda")
    shapes = {
        "refine batch": (torch.as_tensor(rng.integers(0, n, REFINE_BATCH), device="cuda"),
                         torch.as_tensor(rng.integers(0, n, REFINE_BATCH), device="cuda"), 10),
        "anchor column": (torch.tensor(1126, device="cuda").expand(n),
                          torch.arange(n, device="cuda"), 10),
        "BruteForce": (tri[0], tri[1], 3),
    }
    ms, sums = {}, {}
    for name, (I, J, reps) in shapes.items():
        first = myers_pairs(enc, I, J)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = myers_pairs(enc, I, J)
        end.record()
        torch.cuda.synchronize()
        if not torch.equal(out, first):
            raise SystemExit("%s: repeated calls disagree" % name)
        ms[name] = start.elapsed_time(end) / reps
        sums[name] = int(first.long().sum())
        print("  %-14s %9d pairs  %10.4f ms" % (name, I.shape[0], ms[name]), flush=True)
    print(json.dumps({"label": args.label or os.path.abspath(args.root), "card": card,
                      "ms": ms, "sums": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
