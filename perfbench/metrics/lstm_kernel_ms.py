"""Device ms a step of the operations launched inside the LSTM stack's
program spans, `cerebra_torch.lstm.fwd` and `cerebra_torch.lstm.bwd` with
what lies under them (layer `lstm_stack`)."""


def read(record):
    t = record.get("trace")
    s = t["layer_s"].get("lstm_stack", 0.0) if t else 0.0
    return s / t["steps"] * 1e3 if s > 0 else None
