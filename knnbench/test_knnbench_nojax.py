"""A process that sets up and runs each cell (at a small size, on the
CPU) loads no module whose top-level name is jax, jaxlib, flax or
annchor_tpu, and reads nothing of the repo's other benchmark tools."""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

SCRIPT = r"""
import json, sys
sys.path.insert(0, %(root)r)
from knnbench import harness, tiny
root, renamed = tiny.make(%(tmp)r)
bench = harness.Bench(root=root, bench_dir=root + "/knnbench")
for cell in sorted(renamed.values()):
    harness.run_cell(bench, cell, 11, 0.05, 0, device="cpu")
print(json.dumps({"modules": sorted({m.split(".")[0] for m in sys.modules}),
                  "files": sorted({getattr(m, "__file__", None) or "" for m in
                                   list(sys.modules.values())})}))
"""


def test_no_jax_in_any_cell(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS",)}
    out = subprocess.run([sys.executable, "-c", SCRIPT % {"root": ROOT, "tmp": str(tmp_path)}],
                         capture_output=True, text=True, env=env, timeout=900, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert "annchor_tpu_torch" in seen["modules"]
    assert not set(seen["modules"]) & {"jax", "jaxlib", "flax", "annchor_tpu"}
    for f in seen["files"]:
        rel = os.path.relpath(f, ROOT) if f.startswith(ROOT) else ""
        assert not rel.startswith(("benchmarks", "tools", "bench.py", "chip_smoke.py")), rel
