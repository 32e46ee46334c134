"""Device ms a step of the LSTM stack's kernels (layer `lstm_stack`)."""


def read(record):
    t = record.get("trace")
    s = t["layer_s"].get("lstm_stack", 0.0) if t else 0.0
    return s / t["steps"] * 1e3 if s > 0 else None
