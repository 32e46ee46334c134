"""A short run of each cell of BENCHMARK.json on the card, traced, through the benchmark's
own command: it prints one line with `correct` true and every per-layer
metric of the cell. Skips where there is no card."""

import json
import subprocess
import sys

import pytest

from perfbench.run import ROOT, cell_metrics, load_json

BENCH = load_json(ROOT, "BENCHMARK.json")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_short_traced_run(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", name, "--seed",
                          str(2 ** 31 + 5), "--seconds", "2", "--trace", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    wanted = {m["name"] for m in cell_metrics(BENCH, name, "per_layer")}
    assert set(line["metrics"]) == wanted
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
