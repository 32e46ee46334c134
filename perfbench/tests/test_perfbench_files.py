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
    assert cfg["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    assert all(isinstance(k, str) and NAME.match(k) for k in entry["reduced"])
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


LAYERS = trace.load_layers()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def record(layer_s: float) -> dict:
    """A run's record with every field a run fills: each layer of `layers/`
    `layer_s` device seconds over the traced steps, and operations and bytes
    in the counts."""
    return {"cell": "c", "chips": 1, "batch": 8, "steps": 10, "window_s": 0.2,
            "step_ms": [20.0] * 10, "setup_s": 12.0, "dispatch_ms": [3.0, 4.0],
            "peak_window_bytes": 2 ** 30,
            "counts": {"layers": {l["name"]: {"flops": 1e9, "bytes": 1e6} for l in LAYERS},
                       "step_flops": 2e9, "dtype": "bfloat16"},
            "trace": {"steps": 2, "stretch_s": 0.05, "busy_s": 0.03, "other_s": 0.01,
                      "layer_s": {l["name"]: layer_s for l in LAYERS}}}


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_readers_read_a_record(metric):
    """Each reader returns a number from a record in which every layer has
    time."""
    value = read_metric(metric["name"], record(0.004))
    assert value > 0


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_readers_of_a_layer_without_time_return_none(metric):
    """A reader that reads a layer's time (its number follows that time)
    returns None where every layer reads 0; the others read as before."""
    name, full = metric["name"], read_metric(metric["name"], record(0.004))
    reads_layers = read_metric(name, record(0.008)) != full
    assert read_metric(name, record(0.0)) == (None if reads_layers else full)


@pytest.mark.parametrize("layer", LAYERS, ids=lambda l: l["name"])
def test_layer_file(layer):
    """A layer is named as its file and is of one kind: a harness span, or
    program spans (names of the program's own), or kernel fragments."""
    assert NAME.match(layer["name"])
    assert os.path.exists(os.path.join(trace.LAYERS_DIR, f"{layer['name']}.json"))
    assert ("span" in layer) + ("program_spans" in layer) <= 1 and trace.kind(layer)
    if trace.kind(layer) == "program_spans":
        assert all(p.startswith(trace.PROGRAM) for p in layer["program_spans"])
