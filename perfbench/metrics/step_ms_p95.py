"""The 95th percentile (nearest rank) of every window step's time, each
taken between CUDA events at the step's two ends."""

import math


def read(record):
    ms = sorted(record["step_ms"])
    return ms[max(0, math.ceil(0.95 * len(ms)) - 1)]
