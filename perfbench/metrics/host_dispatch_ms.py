"""Host ms of the harness's call of the step, each call alone after a
synchronise, so no full launch queue stalls it; the mean."""


def read(record):
    ms = record.get("dispatch_ms")
    return sum(ms) / len(ms) if ms else None
