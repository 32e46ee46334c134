"""The LSTM stack's least time on the chip (`counts.bound_s` of the
operations and bytes its forward and backward need, and the teacher's
forward) as a share of the device time of its program spans."""

from perfbench import counts


def read(record):
    return counts.layer_roofline(record, "lstm_stack")
