"""The control, the plain reference put in the program's place in the
configuration's lower precision, comes out as not correct under each
cell's limits (strings: saturating int8 DP lanes; digits: float32), at
sizes a test run holds; the same ids with their true distances show no
gap."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from knnbench import harness, loops, readings, tiny  # noqa: E402

# index sizes the CPU holds; the strings keep their 500 characters, so
# neighbours lie beyond int8's 127 as in the cell
CUTS = {"strings-1600": {"data": {"n": 48, "n_clusters": 2},
                         "annchor": {"n_neighbors": 25, "p_work": 0.12}},
        "digits-1797": {"data": {"n": 64},
                        "annchor": {"n_anchors": 25, "n_neighbors": 25, "n_samples": 5000,
                                    "p_work": 0.16}}}


@pytest.mark.parametrize("cell", ["strings-1600.fit", "strings-1600.query",
                                  "digits-1797.fit", "digits-1797.query"])
def test_control_fails(tmp_path, cell):
    root, renamed = tiny.make(tmp_path, cuts=CUTS, rows=3)
    bench = harness.Bench(root=root, bench_dir=os.path.join(root, "knnbench"))
    config, check, index, answers = readings.control_answers(bench, renamed[cell], 9, "cpu")
    values, ok, rows = harness.judge_answers(bench, config, check, answers, index, "cpu")
    assert not ok, rows
    ref = bench.reference(config)
    ids = answers.reported[0][0]
    (rep,), top = ref.judge(index, answers.queries, [ids], ids.shape[1],
                            harness.reference_params(config), "cpu")
    exact = loops.Answers(answers.queries, [(ids, rep, None)])
    values, ok, rows = harness.judge_answers(bench, config, check, exact, index, "cpu")
    assert values["dist_gap"] == 0
