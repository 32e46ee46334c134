"""The LSTM stack's least time on the chip (`counts.bound_s` of the
operations and bytes its forward and backward need, and the teacher's
forward) as a share of its kernels' device time."""

from perfbench import counts


def read(record):
    t = record.get("trace")
    s = t["layer_s"].get("lstm_stack", 0.0) if t else 0.0
    if s <= 0:
        return None
    c = record["counts"]
    return counts.bound_s(c["lstm_flops"], c["lstm_bytes"], c["dtype"]) / (s / t["steps"]) * 100
