"""Small copies of the benchmark for the CPU tests: the benchmark's
files copied into a temporary directory, with each configuration cut to
a size a CPU fits in a second or two, and cells of those copies.  A
configuration whose rows come from a file gets a file of its first
``n`` rows."""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the cuts: configuration -> keys of its file set anew
CUTS = {
    "strings-1600": {"data": {"n": 240, "length": 60, "n_clusters": 4},
                     "annchor": {"n_neighbors": 10, "p_work": 0.3, "n_anchors": 10,
                                 "n_samples": 1000}},
    "digits-1797": {"data": {"n": 160},
                    "annchor": {"n_anchors": 10, "n_neighbors": 10, "n_samples": 1000,
                                "p_work": 0.3}},
}
ROWS = 16


def tiny_name(name):
    return name + "-tiny"


def make(tmp, cuts=CUTS, rows=ROWS):
    """Copy the benchmark into ``tmp`` and add a tiny twin of each
    configuration, with a cell of it for each of its cells; returns the
    root of the copy."""
    root = str(tmp)
    shutil.copytree(HERE, os.path.join(root, "knnbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    bdir = os.path.join(root, "knnbench")
    renamed = {}
    for c in list(spec["configs"]):
        if c["name"] not in cuts:
            continue
        with open(os.path.join(root, c["file"])) as fh:
            conf = json.load(fh)
        for key, vals in cuts[c["name"]].items():
            conf[key] = {**conf.get(key, {}), **vals} if key != "annchor" else dict(vals)
        conf["name"] = tiny_name(c["name"])
        if "file" in conf["data"]:
            with np.load(os.path.join(root, conf["data"]["file"])) as z:
                arrays = {k: z[k][: conf["data"]["n"]] for k in z.files}
            conf["data"]["file"] = "knnbench/data/%s.npz" % conf["name"]
            np.savez(os.path.join(root, conf["data"]["file"]), **arrays)
        path = "knnbench/configs/%s.json" % conf["name"]
        with open(os.path.join(root, path), "w") as fh:
            json.dump(conf, fh)
        spec["configs"].append({**c, "name": conf["name"], "file": path})
    for w in list(spec["workloads"]):
        if w["config"] not in cuts:
            continue
        name = w["name"].replace(w["config"], tiny_name(w["config"]), 1)
        renamed[w["name"]] = name
        spec["workloads"].append({**w, "name": name, "config": tiny_name(w["config"])})
        with open(os.path.join(bdir, "cells", w["name"] + ".json")) as fh:
            check = json.load(fh)
        check["rows"] = rows
        with open(os.path.join(bdir, "cells", name + ".json"), "w") as fh:
            json.dump(check, fh)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [renamed[w] for w in m["workloads"] if w in renamed]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return root, renamed
