"""The benchmark of annchor_tpu_torch: cells of a configuration under a
traffic mix, each found by name from ``BENCHMARK.json``.  Run one cell
once with ``python3 knnbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``."""
