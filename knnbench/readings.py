"""The readings that the limits of ``correct`` are set from: the
program's numbers over many seeds (each a short run of the cell, all in
one process) and the control's, the plain reference put in the
program's place in the configuration's lower precision.

    python3 knnbench/readings.py --workload <cell> --seeds 1,2,3 [--seconds 1]
        [--control | --fault <name>]

Prints one JSON line per seed: {"seed", "who": "program", "control" or
the fault's name, "values": {number: reading}, "correct"}, on a card.
``--fault`` plants one of ``faults.py``'s faults in the program for the
whole process.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_answers(bench, cell_name, seed, device):
    """(config, check, index, Answers) of the control for the rows a run
    of the cell at ``seed`` judges (the loop's ``control_inputs``)."""
    from knnbench import harness, loops

    ctx = harness.Context(bench, cell_name, seed, 0, False, device, None)
    index, queries, k = bench.loop(ctx.traffic).control_inputs(ctx)
    ids, dists = bench.reference(ctx.config).control(index, queries, k,
                                                     harness.reference_params(ctx.config),
                                                     device)
    return ctx.config, ctx.check, index, loops.Answers(queries, [(ids, dists, None)])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", action="store_true", help="read the control, not the program")
    ap.add_argument("--fault", help="a fault of faults.py planted in the program")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from knnbench import faults, harness

    who = "control" if args.control else args.fault or "program"
    if args.fault:
        import pytest

        getattr(faults, args.fault)(pytest.MonkeyPatch())

    bench = harness.Bench()
    device = "cuda"
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.control:
            config, check, index, answers = control_answers(bench, args.workload, seed, device)
            values, ok, _ = harness.judge_answers(bench, config, check, answers, index, device)
        else:
            result, _, values = harness.run_cell(bench, args.workload, seed, args.seconds, 0,
                                                 device=device)
            ok = result["correct"]
        print(json.dumps({"seed": seed, "who": who,
                          "values": values, "correct": ok}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
