"""A traced run of each tiny cell on the CPU reads every per-layer metric
of the program's spans (``source: program_span`` metrics that read
``program_spans``) that the cell lists."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from knnbench import harness, tiny  # noqa: E402


@pytest.mark.parametrize("cell", ["strings-1600.fit", "digits-1797.fit", "strings-1600.query",
                                  "digits-1797.query"])
def test_traced_tiny_cells_read_the_program_spans(tmp_path, cell):
    from annchor_tpu_torch import trace

    root, renamed = tiny.make(tmp_path)
    bench = harness.Bench(root=root, bench_dir=os.path.join(root, "knnbench"))
    want = set()
    for m in bench.metrics(renamed[cell], 1):
        with open(os.path.join(root, "knnbench", "layer_metrics", m["name"] + ".py")) as fh:
            if "program_spans" in fh.read():
                want.add(m["name"])
    assert want
    trace.reset()
    result, rows, _ = harness.run_cell(bench, renamed[cell], 2**33 + 3, 0.3, 1, device="cpu")
    trace.reset()
    assert result["correct"], rows
    got = {k: v["value"] for k, v in result["metrics"].items() if k in want}
    assert set(got) == want and all(v > 0 for v in got.values()), got
