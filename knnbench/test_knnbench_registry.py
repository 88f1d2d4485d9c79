"""Each configuration, data generator, traffic mix, kind of loop, check
and metric is found by name, and a new one dropped in as a file is
picked up with no file edited."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from knnbench import harness, readings, tiny  # noqa: E402


def test_everything_is_found_by_name():
    bench = harness.Bench()
    for w in bench.spec["workloads"]:
        conf = bench.config(w["config"])
        assert conf["name"] == w["config"]
        loop = bench.loop(bench.traffic(w["traffic"]))
        assert callable(loop.run) and callable(loop.control_inputs)
        assert callable(bench.module("generators", conf["data"]["generator"]).make)
        check = bench.check(w["name"])
        assert check["rows"] > 0 and check["limits"]
        ref = bench.reference(conf)
        assert callable(ref.judge) and callable(ref.control)
        for trace in (0, 1):
            for m in bench.metrics(w["name"], trace):
                mod = bench.module("layer_metrics" if trace else "e2e_metrics", m["name"])
                assert callable(mod.read)


def _add(root, spec_key, entry):
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec[spec_key].append(entry)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)


def _write(path, text):
    with open(path, "w") as fh:
        fh.write(text)


def test_a_dropped_in_mix_and_metric_are_picked_up(tmp_path):
    root, renamed = tiny.make(tmp_path)
    bdir = os.path.join(root, "knnbench")
    # a new mix (fewer neighbours a call), a new metric, a new cell: files and entries only
    with open(os.path.join(bdir, "traffic", "query-example.json")) as fh:
        mix = json.load(fh)
    mix.update(nn=5)
    with open(os.path.join(bdir, "traffic", "query-small.json"), "w") as fh:
        json.dump(mix, fh)
    _write(os.path.join(bdir, "e2e_metrics", "query_p50_ms.py"),
           "import numpy as np\n\n\ndef read(window):\n"
           "    return float(np.percentile(window['latencies_s'], 50)) * 1e3\n")
    with open(os.path.join(bdir, "cells", "strings-1600-tiny.small.json"), "w") as fh:
        json.dump({"rows": 3, "match_tol": 0, "limits": {"miss_share": 1.0}}, fh)
    _add(root, "workloads", {"name": "strings-1600-tiny.small", "config": "strings-1600-tiny",
                             "traffic": "query-small", "chips": 1, "why": "test"})
    _add(root, "end_to_end", {"name": "query_p50_ms", "unit": "ms", "better": "lower",
                              "bound": 0.1, "source": "host_clock",
                              "workloads": ["strings-1600-tiny.small"]})
    bench = harness.Bench(root=root, bench_dir=bdir)
    result, rows, values = harness.run_cell(bench, "strings-1600-tiny.small", 5, 0.2, 0,
                                            device="cpu")
    assert set(result["metrics"]) == {"query_p50_ms", "setup_s"}
    assert result["correct"] and [r[0] for r in rows] == ["miss_share"]


GENERATOR = """
import numpy as np


def make(spec, root):
    rng = np.random.default_rng(spec["data_seed"])
    lens = rng.integers(spec["min_length"], spec["max_length"] + 1, size=spec["n"])
    return ["".join(rng.choice(list(spec["alphabet"]), size=n)) for n in lens]
"""

LOOP = """
import time

from knnbench import datagen
from knnbench.loops import Answers


def control_inputs(ctx):
    data = ctx.make_data(ctx.seed)
    rows = list(range(ctx.check["rows"]))
    return data.index, datagen.take(data.index, rows), ctx.config["annchor"]["n_neighbors"]


def run(ctx):
    data = ctx.make_data(ctx.seed)
    ctx.start_window()
    t0 = time.perf_counter()
    ann = ctx.annchor(data.copy_index())
    ann.fit()
    ngi, ngd = ann.neighbor_graph
    rows = list(range(ctx.check["rows"]))
    window = {"setup_s": ctx.setup_s, "wall_s": time.perf_counter() - t0, "fits": 1,
              "attempted": 1, "failed": 0}
    return window, Answers(datagen.take(data.index, rows),
                           [(ngi[rows], ngd[rows], None)]), data.index, {}
"""


def test_a_dropped_in_generator_and_loop_are_picked_up(tmp_path):
    root, _ = tiny.make(tmp_path)
    bdir = os.path.join(root, "knnbench")
    # a new data generator, a new kind of loop, a configuration and a mix using them
    _write(os.path.join(bdir, "generators", "uniform_strings.py"), GENERATOR)
    _write(os.path.join(bdir, "loops", "fit_once.py"), LOOP)
    conf = {"name": "uniform-90", "reduced": [],
            "data": {"generator": "uniform_strings", "n": 90, "min_length": 20,
                     "max_length": 40, "alphabet": "AB", "data_seed": 3},
            "metric": {"func": "levenshtein", "func_kwargs": {}},
            "annchor": {"n_neighbors": 6, "p_work": 0.5, "n_anchors": 8, "n_samples": 600},
            "reference": {"module": "levenshtein", "params": {}}}
    with open(os.path.join(bdir, "configs", "uniform-90.json"), "w") as fh:
        json.dump(conf, fh)
    with open(os.path.join(bdir, "traffic", "one-fit.json"), "w") as fh:
        json.dump({"kind": "fit_once", "why": "test"}, fh)
    with open(os.path.join(bdir, "cells", "uniform-90.once.json"), "w") as fh:
        json.dump({"rows": 4, "match_tol": 0, "limits": {"dist_gap": 0, "miss_share": 1.0}}, fh)
    _add(root, "configs", {"name": "uniform-90", "source": "test",
                           "file": "knnbench/configs/uniform-90.json", "reduced": [],
                           "why": "test"})
    _add(root, "workloads", {"name": "uniform-90.once", "config": "uniform-90",
                             "traffic": "one-fit", "chips": 1, "why": "test"})
    _add(root, "end_to_end", {"name": "fit_once_s", "unit": "s", "better": "lower",
                              "bound": 0.1, "source": "host_clock",
                              "workloads": ["uniform-90.once"]})
    _write(os.path.join(bdir, "e2e_metrics", "fit_once_s.py"),
           "def read(window):\n    return window['wall_s']\n")
    bench = harness.Bench(root=root, bench_dir=bdir)
    result, rows, values = harness.run_cell(bench, "uniform-90.once", 7, 0.1, 0, device="cpu")
    assert set(result["metrics"]) == {"fit_once_s", "setup_s"}
    assert result["correct"] and values["dist_gap"] == 0, rows
    assert result["attempted"] == 1
    ctrl = readings.control_answers(bench, "uniform-90.once", 7, "cpu")
    assert len(ctrl[3].queries) == 4


@pytest.mark.parametrize("cell", ["strings-1600.fit", "digits-1797.query"])
def test_tiny_cells_run_on_the_cpu(tmp_path, cell):
    root, renamed = tiny.make(tmp_path)
    bench = harness.Bench(root=root, bench_dir=os.path.join(root, "knnbench"))
    result, rows, values = harness.run_cell(bench, renamed[cell], 2**33 + 1, 0.2, 0,
                                            device="cpu")
    assert result["correct"], (rows, values)
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in bench.metrics(renamed[cell], 0)}
    assert list(result)[-1] == "checks"
