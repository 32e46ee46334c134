"""Device ms a step of the operations launched inside the harness's span
around `filtfilt_matmul` (layer `signal`)."""


def read(record):
    t = record.get("trace")
    s = t["layer_s"].get("signal", 0.0) if t else 0.0
    return s / t["steps"] * 1e3 if s > 0 else None
