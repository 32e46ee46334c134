"""torch.cuda.max_memory_allocated over the window, after a reset at its
start: the most the process holds while the steps run (the corpus, the
weights and the optimizer's state with the steps' activations), in MiB."""


def read(record):
    b = record.get("peak_window_bytes")
    return b / 2 ** 20 if b else None
