"""The benchmark of cerebra_torch on NVIDIA H100s.

`python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once and prints one JSON line. Everything
that belongs to one configuration, cell, metric or layer is a file of its
own under `configs/`, `workloads/`, `metrics/` and `layers/`, found by name.
"""
