"""Set-up: from the process's start to the first timed step (the library's
load or build, the corpus and weights, the program's objects, the first
steps and the warm-up)."""


def read(record):
    return record["setup_s"]
