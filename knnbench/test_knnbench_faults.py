"""A run with its timed path broken underneath comes out as not
correct: the harness's look for a card is skipped and the rest of a run
is driven on the CPU, at a small size, once for each fault the cells can
have (``faults.py``)."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import annchor_tpu_torch  # noqa: E402

from knnbench import faults, harness, tiny  # noqa: E402

FAULTS = [(cell, f) for cell, fs in faults.BY_CELL.items() for f in fs]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=["%s-%s" % (c, f.__name__)
                                                    for c, f in FAULTS])
def test_fault_is_not_correct(tmp_path, monkeypatch, cell, fault):
    root, renamed = tiny.make(tmp_path)
    bench = harness.Bench(root=root, bench_dir=os.path.join(root, "knnbench"))
    sound, _, _ = harness.run_cell(bench, renamed[cell], 21, 0.1, 0, device="cpu")
    assert sound["correct"], sound["checks"]
    fault(monkeypatch)
    result, rows, values = harness.run_cell(bench, renamed[cell], 21, 0.1, 0, device="cpu")
    assert not result["correct"], (rows, values)
    assert annchor_tpu_torch.__name__ == "annchor_tpu_torch"
