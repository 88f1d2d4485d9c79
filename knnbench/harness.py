"""One run of one cell: the cell, its configuration, its traffic mix,
its check and its metrics are all found by name.

* ``BENCHMARK.json`` (the checkout's root) lists the cells and metrics;
* a configuration is the file its entry names (``configs/<name>.json``),
  whose ``data.generator`` names ``generators/<name>.py``;
* a traffic mix is the data file ``traffic/<name>.json``, whose ``kind``
  names the loop that reads it, ``loops/<kind>.py``;
* a cell's check (rows judged, limits) is ``cells/<cell>.json``;
* an end-to-end metric is ``e2e_metrics/<name>.py`` and a per-layer one
  ``layer_metrics/<name>.py``, each with ``read(...)`` returning the
  number or None when there is nothing to read;
* a configuration's plain reference is ``reference/<module>.py``.

Each module is loaded from the benchmark's folder by its path, so a
later change adds a configuration, a generator, a mix, a loop, a cell
or a metric by adding files and entries, and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

from knnbench import datagen, judge

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no run may load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "annchor_tpu")


def _json(path):
    with open(path) as fh:
        return json.load(fh)


class Bench:
    """``BENCHMARK.json`` and the files it names; ``bench_dir`` holds
    the benchmark's own files (this folder, or a copy in a test)."""

    def __init__(self, root=ROOT, bench_dir=HERE):
        self.root = root
        self.dir = bench_dir
        self.spec = _json(os.path.join(root, "BENCHMARK.json"))
        self._modules = {}

    def cell(self, name):
        for c in self.spec["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError("no cell %r in BENCHMARK.json" % name)

    def config(self, name):
        for c in self.spec["configs"]:
            if c["name"] == name:
                rel = os.path.relpath(c["file"], os.path.basename(self.dir))
                return _json(os.path.join(self.dir, rel))
        raise KeyError("no configuration %r in BENCHMARK.json" % name)

    def traffic(self, name):
        return _json(os.path.join(self.dir, "traffic", name + ".json"))

    def check(self, cell):
        return _json(os.path.join(self.dir, "cells", cell + ".json"))

    def metrics(self, cell, trace):
        """The cell's end-to-end metrics, or with ``trace`` its per-layer
        ones: those whose ``workloads`` list it (an end-to-end metric
        without the key is every cell's)."""
        if trace:
            return [m for m in self.spec["per_layer"] if cell in m["workloads"]]
        return [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]

    def module(self, kind, name):
        """The module ``<kind>/<name>.py`` of the benchmark's folder
        (names may hold dots and dashes), loaded once."""
        key = (kind, name)
        if key not in self._modules:
            path = os.path.join(self.dir, kind, name + ".py")
            spec = importlib.util.spec_from_file_location(
                "knnbench_%s_%s" % (kind, re.sub(r"\W", "_", name)), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def loop(self, traffic):
        return self.module("loops", traffic["kind"])

    def reference(self, config):
        return self.module("reference", config["reference"]["module"])


class Context:
    """One run of one cell: what its loop needs."""

    def __init__(self, bench, cell_name, seed, seconds, trace, device, started):
        self.cell = bench.cell(cell_name)
        self.config = bench.config(self.cell["config"])
        self.traffic = bench.traffic(self.cell["traffic"])
        self.check = bench.check(cell_name)
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = device
        self.random_seed = int(seed) % (2**31)
        self._started = started
        self.setup_s = None
        data = self.config["data"]
        self._rows = bench.module("generators", data["generator"]).make(data, bench.root)

    def make_data(self, seed, queries=False):
        """The seed's index and, with ``queries``, its held-out pool."""
        return datagen.split(self._rows, self.config.get("queries") if queries else None, seed)

    def annchor(self, X):
        """A new index over X with the configuration's arguments."""
        import annchor_tpu_torch as att

        kw, _ = datagen.with_cost_matrix(self.config["metric"].get("func_kwargs", {}))
        return att.Annchor(X, self.config["metric"]["func"], func_kwargs=kw or None,
                           random_seed=self.random_seed, device=self.device,
                           **self.config["annchor"])

    def launch_counts(self):
        """The program's launch counters of the configuration's kernels
        (``kernels.<k>.counter``: module and object), where it keeps them."""
        out = {}
        for name, k in self.config.get("kernels", {}).items():
            mod, obj = k.get("counter", (None, None))
            try:
                out[name] = int(getattr(importlib.import_module(mod), obj).launches)
            except (ImportError, AttributeError, TypeError, ValueError):
                continue
        return out

    def synchronize(self):
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def start_window(self):
        """Set-up ends: every shape has been warmed up."""
        self.synchronize()
        self.setup_s = self._started()

    @staticmethod
    def warn(msg):
        print("knnbench: %s" % msg, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def reference_params(config):
    """The reference's parameters, with the grid's cost matrix built."""
    params, grid = datagen.with_cost_matrix(config["reference"].get("params", {}))
    if grid is not None:
        params["grid"] = grid
    return params


def judge_answers(bench, config, check, answers, index, device):
    """The numbers compared over every reported set of rows, and the
    verdict against the cell's limits."""
    if not answers.reported:
        return {}, False, []
    ref = bench.reference(config)
    distinct = {}
    for ids, _, _ in answers.reported:
        distinct.setdefault(np.asarray(ids).tobytes(), np.asarray(ids))
    keys = list(distinct)
    k = answers.reported[0][0].shape[1]
    reps, top = ref.judge(index, answers.queries, [distinct[x] for x in keys], k,
                          reference_params(config), device)
    rep_of = dict(zip(keys, reps))
    tol = float(check.get("match_tol", 0.0))
    values = judge.worst(judge.numbers(ids, d, x, rep_of[np.asarray(ids).tobytes()], top, tol)
                         for ids, d, x in answers.reported)
    ok, rows = judge.verdict(values, check["limits"])
    return values, ok, rows


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(bench, cell_name, seed, seconds, trace, device="cuda", started=None):
    """Run the cell once; returns (result dict, [(number, value, limit)],
    {number: value})."""
    import torch

    t_import = time.monotonic()
    started = started or (lambda: time.monotonic() - t_import)
    ctx = Context(bench, cell_name, seed, seconds, trace, device, started)
    cell, config = ctx.cell, ctx.config
    window, answers, index, records = bench.loop(ctx.traffic).run(ctx)

    cuda = device == "cuda"
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    metrics = {}
    for m in bench.metrics(cell_name, trace):
        mod = bench.module("layer_metrics" if trace else "e2e_metrics", m["name"])
        value = mod.read(records) if trace else mod.read(window)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": peak,
           "power_limit_w": power_limit() if cuda else None}
    result = {"correct": False, "attempted": window["attempted"], "failed": window["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        prof = records["profile"]
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        for name, k in config.get("kernels", {}).items():
            n = sum(v for key, v in prof["kernels"].items() if k["fragment"] in key)
            ctx.warn("%s: the profile recorded %d kernels; the program counted %s launches" % (
                name, n, records.get("launches", {}).get(name)))
        tables = records.get("stage_tables") or []
        for stage in dict.fromkeys(n for t in tables for n, _ in t):
            ctx.warn("stage %s: %s s a fit" % (stage, sum(s for t in tables for n, s in t
                                                         if n == stage) / len(tables)))
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    records.clear()
    if cuda:
        torch.cuda.empty_cache()

    values, ok, rows = judge_answers(bench, config, ctx.check, answers, index, device)
    result["correct"] = bool(ok and window["failed"] == 0)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result, rows, values
