"""Training windows a second: every step's batch completed in the window,
over the window's time (a synchronise to a synchronise)."""


def read(record):
    return record["steps"] * record["batch"] / record["window_s"]
