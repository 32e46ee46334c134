"""Device ms a step that no layer of `layers/` claims: the head, the loss,
the optimizer, the EMA, the gathers and copies, the stack's input copy and
weight casts (`cerebra_torch.lstm.prepare`)."""


def read(record):
    t = record.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return t["other_s"] / t["steps"] * 1e3
