"""Device ms a step not claimed by the filter or the LSTM stack: the head,
the loss, the optimizer, the EMA, the gathers and copies."""


def read(record):
    t = record.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    rest = t["other_s"] + sum(v for k, v in t["layer_s"].items()
                              if k not in ("signal", "lstm_stack"))
    return rest / t["steps"] * 1e3
