"""Cells at a size the CPU holds: the configurations' files with narrow
widths and short sequences, f32 (the CPU runs the kernels' plain
versions), and each cell's own limits. Each driver's sizes and faults are
in `tests/drivers/<driver>.py`, so a cell with a driver of its own adds a
file there. The DINO-LSTM's driver and reference have no cell in
BENCHMARK.json yet (PERF.md, Open questions: the fp8 control fails none of
these limits, which its readings on the card would set); they run here on
`DINO_B8`, the traffic of the CLI's batch of 8 that their cell would
carry."""

import importlib

import torch

from perfbench.run import HERE, load_cell, load_json

torch.set_num_threads(1)

DINO_B8 = {"config": "dino_lstm", "traffic": "b8", "chips": 1, "batch": 8, "corpus_trials": 4000,
           "start_step": 499, "check_steps": 3, "warmup_steps": 10, "trace_steps": 20,
           "libraries": ["lstm_stack"],
           "limits": {"loss_gap": 0.005, "grad_gap": 0.1, "update_gap": 0.05,
                      "teacher_gap": 0.05, "center_gap": 0.02}}


def small(name: str, dtype: str = "float32"):
    """The cell and its configuration at the size that its driver's module
    in `tests/drivers/` gives."""
    if name == "dino_lstm.b8":
        cell, cfg = dict(DINO_B8), load_json(HERE, "configs", "dino_lstm.json")
    else:
        cell, cfg = load_cell(name)
    return driver(cfg).small(cell, cfg, dtype)


def driver(cfg: dict):
    """`tests/drivers/<driver>.py` of a configuration: its CPU sizes and faults."""
    return importlib.import_module(f"perfbench.tests.drivers.{cfg['driver']}")


CELLS = ("lstm_distill_dinov2.b1024", "dino_lstm.b8")  # every driver
BENCHMARK_CELLS = tuple(w["name"] for w in load_json(HERE, "..", "BENCHMARK.json")["workloads"])

