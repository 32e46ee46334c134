"""The step's matrix-product operations (`counts`: the model's forward, the
backward of what trains, the teacher's forward, the filter as its dense
product; no recompute) over the mean step time of the unprofiled window,
as a share of one H100's bf16 peak."""

from perfbench.counts import PEAKS


def read(record):
    step_s = record["window_s"] / record["steps"]
    return record["counts"]["step_flops"] / step_s / PEAKS["flops_per_s"]["bfloat16"] * 100
