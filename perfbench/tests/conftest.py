"""Cells at a size the CPU holds: the configurations' files with narrow
widths and short sequences, f32 (the CPU runs the kernels' plain
versions), and each cell's own limits. The DINO-LSTM's driver and
reference have no cell in BENCHMARK.json yet (PERF.md, Open questions:
the fp8 control fails none of these limits, which its readings on the
card would set); they run here on `DINO_B8`, the traffic of the CLI's
batch of 8 that their cell would carry."""

import torch

from perfbench.run import HERE, load_cell, load_json

torch.set_num_threads(1)

DINO_B8 = {"config": "dino_lstm", "traffic": "b8", "chips": 1, "batch": 8, "corpus_trials": 4000,
           "start_step": 499, "check_steps": 3, "warmup_steps": 10, "trace_steps": 20,
           "libraries": ["lstm_stack"],
           "limits": {"loss_gap": 0.005, "grad_gap": 0.1, "update_gap": 0.05,
                      "teacher_gap": 0.05, "center_gap": 0.02}}


def small(name: str, dtype: str = "float32"):
    if name == "dino_lstm.b8":
        cell, cfg = dict(DINO_B8), load_json(HERE, "configs", "dino_lstm.json")
    else:
        cell, cfg = load_cell(name)
    if cfg["driver"] == "feature_distill":
        cfg = dict(cfg, input_size=16, lstm_size=16, output_size=64, n_classes=8,
                   raw_samples=128, time_low=8, time_high=120, num_taps=33, dtype=dtype)
        cell = dict(cell, batch=16, corpus_trials=32, warmup_steps=1, trace_steps=2)
    else:  # the program fixes DINOHead's hidden and bottleneck widths
        cfg = dict(cfg, input_size=8, samples=40, embed_dim=16, out_dim=32, global_length=24,
                   local_length=16, epochs=4, warmup_epochs=1, dtype=dtype)
        cell = dict(cell, batch=4, corpus_trials=32, start_step=7, warmup_steps=1, trace_steps=2)
    return cell, cfg


CELLS = ("lstm_distill_dinov2.b1024", "dino_lstm.b8")  # every driver
BENCHMARK_CELLS = tuple(w["name"] for w in load_json(HERE, "..", "BENCHMARK.json")["workloads"])

