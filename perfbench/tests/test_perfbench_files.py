"""Every configuration, cell, metric and layer of BENCHMARK.json is a file
of its own that the harness finds and reads by name, and keeps to the
format's limits: names, units, bounds, sizes."""

import json
import os
import re

import pytest

from perfbench import trace
from perfbench.run import HERE, ROOT, cell_metrics, load_cell, load_json, read_metric

BENCH = load_json(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
E2E = {m["name"] for m in BENCH["end_to_end"]}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"] and 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    cfg = load_json(ROOT, entry["file"])
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert os.path.exists(os.path.join(HERE, "drivers", f"{cfg['driver']}.py"))


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_file(entry):
    cell, cfg = load_cell(entry["name"])
    assert NAME.match(entry["name"]) and len(entry["why"]) <= 200
    assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert cfg["name"] in {c["name"] for c in BENCH["configs"]}
    assert cell["limits"] and all(v > 0 for v in cell["limits"].values())
    reported = [m["name"] for m in cell_metrics(BENCH, entry["name"], "end_to_end")]
    assert "setup_s" in reported and len(reported) >= 2
    assert cell_metrics(BENCH, entry["name"], "per_layer")


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader(metric):
    assert NAME.match(metric["name"]) and metric["better"] in ("lower", "higher")
    assert os.path.exists(os.path.join(HERE, "metrics", f"{metric['name']}.py"))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "moves" in metric:  # a per-layer metric moves an end-to-end metric of its cells
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
    else:
        assert 0 < metric["bound"] <= 0.25 and metric["source"] in ("host_clock", "device_trace")


def test_readers_read_a_record():
    """Each reader returns a number from a record with every field a run
    fills, or None where its layer has no time there."""
    record = {"cell": "c", "chips": 1, "batch": 8, "steps": 10, "window_s": 0.2,
              "step_ms": [20.0] * 10, "setup_s": 12.0, "dispatch_ms": [3.0, 4.0],
              "peak_window_bytes": 2 ** 30,
              "counts": {"lstm_flops": 1e9, "lstm_bytes": 1e6, "step_flops": 2e9,
                         "dtype": "bfloat16"},
              "trace": {"steps": 2, "stretch_s": 0.05, "busy_s": 0.03, "other_s": 0.01,
                        "layer_s": {"signal": 0.0, "lstm_stack": 0.02}}}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        value = read_metric(m["name"], record)
        assert value is None if m["name"].startswith("filter_ms") else value > 0, m["name"]


@pytest.mark.parametrize("layer", trace.load_layers(), ids=lambda l: l["name"])
def test_layer_file(layer):
    assert ("span" in layer) != ("kernels" in layer)
    assert NAME.match(layer["name"])
