"""BENCHMARK.json keeps to the benchmark's contract of names, units,
keys and files."""

import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    assert 1 <= len(spec["command"]) <= 32 and all(_line(w) for w in spec["command"])
    assert 1 <= len(spec["paths"]) <= 16 and all(PATH.match(p) for p in spec["paths"])
    assert all(not w.startswith("/") and ".." not in w for w in spec["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entries(spec, section, keys):
    names = [e["name"] for e in spec[section]]
    assert len(names) == len(set(names))
    for e in spec[section]:
        assert set(e) <= keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_names_across_sections(spec):
    metric_names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    cells = {w["name"] for w in spec["workloads"]}
    configs = {c["name"] for c in spec["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in spec["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for c in spec["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in spec["workloads"])
        assert c["source"].startswith("https://")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    assert all(0.01 <= m["bound"] <= 0.25 for m in spec["end_to_end"])
    assert all(m["source"] in ("host_clock", "device_trace") for m in spec["end_to_end"])


def test_every_cell_reports_enough(spec):
    for w in spec["workloads"]:
        e2e = [m for m in spec["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert {"setup_s"} < {m["name"] for m in e2e}, w["name"]
        moved = {m["name"] for m in e2e}
        layer = [m for m in spec["per_layer"]
                 if (w["name"] in m["workloads"] if "workloads" in m else m["moves"] in moved)]
        assert layer, w["name"]
        assert all(m["moves"] in moved for m in layer), w["name"]


def test_files_are_named_from_names(spec):
    paths = spec["paths"]
    for c in spec["configs"]:
        assert any(c["file"].startswith(p + "/") for p in paths)
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in spec["workloads"]:
        assert os.path.exists(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(HERE, "cells", w["name"] + ".json"))
    for m in spec["end_to_end"]:
        assert os.path.exists(os.path.join(HERE, "e2e_metrics", m["name"] + ".py"))
    for m in spec["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "layer_metrics", m["name"] + ".py"))
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert "__pycache__" in rel or PATH.match(rel), rel


def test_layers_and_rooflines(spec):
    layers = {}
    for m in spec["per_layer"]:
        assert _line(m["layer"])
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%" and m["source"] == "device_trace"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
