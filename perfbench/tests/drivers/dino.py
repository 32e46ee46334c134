"""The DINO-LSTM step (`perfbench/drivers/dino.py`) in the CPU tests: its
sizes there, and its faults planted underneath the timed path."""

import torch


def small(cell: dict, cfg: dict, dtype: str):
    """The cell and configuration with narrow widths and short sequences
    (the program fixes DINOHead's hidden and bottleneck widths)."""
    cfg = dict(cfg, input_size=8, samples=40, embed_dim=16, out_dim=32, global_length=24,
               local_length=16, epochs=4, warmup_epochs=1, dtype=dtype)
    return dict(cell, batch=4, corpus_trials=32, start_step=7, warmup_steps=1,
                trace_steps=2), cfg


def plant(monkeypatch, fault: str) -> None:
    """`frozen`: the step returns its state unchanged; `half`: it trains on
    the first half of each batch."""
    import cerebra_torch.train.recipes as recipes

    make = recipes.make_dino_lstm

    def make_faulty(*args, **kwargs):
        state, step, niter = make(*args, **kwargs)
        if fault == "frozen":
            return state, lambda s, batch, gen: (s, {"loss": torch.zeros(())}), niter
        return state, lambda s, batch, gen: step(s, batch[:batch.shape[0] // 2], gen), niter

    monkeypatch.setattr(recipes, "make_dino_lstm", make_faulty)
