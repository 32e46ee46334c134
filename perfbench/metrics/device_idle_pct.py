"""The share of a step in which the device runs nothing: one less the
device's busy seconds a step (the union of its operations over the traced
steps) over the mean step of the unprofiled window. The traced stretch
itself is not the denominator: tracing slows a host-bound step by a third
or more (PERF.md), which would read as idle device time."""


def read(record):
    t = record.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    step_s = record["window_s"] / record["steps"]
    return max(0.0, 1.0 - t["busy_s"] / t["steps"] / step_s) * 100
