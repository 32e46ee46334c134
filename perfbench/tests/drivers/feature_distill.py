"""The LSTM→DINOv2 step (`perfbench/drivers/feature_distill.py`) in the
CPU tests: its sizes there, and its faults planted underneath the timed
path."""


def small(cell: dict, cfg: dict, dtype: str):
    """The cell and configuration with narrow widths and short sequences."""
    cfg = dict(cfg, input_size=16, lstm_size=16, output_size=64, n_classes=8,
               raw_samples=128, time_low=8, time_high=120, num_taps=33, dtype=dtype)
    return dict(cell, batch=16, corpus_trials=32, warmup_steps=1, trace_steps=2), cfg


def frozen_distill_step(model, opt, loss_fn, eeg, feats, labels, epoch):
    return loss_fn(*model(eeg), feats, labels, epoch).detach()


def plant(monkeypatch, fault: str) -> None:
    """`frozen`: the step returns its state unchanged; `half`: it trains on
    the first half of each batch, the mean taken over it."""
    import cerebra_torch.train.steps as steps

    whole = steps.feature_distill_step
    if fault == "frozen":
        step = frozen_distill_step
    else:
        def step(model, opt, loss_fn, eeg, feats, labels, epoch):
            n = eeg.shape[0] // 2
            return whole(model, opt, loss_fn, eeg[:n], feats[:n], labels[:n], epoch)
    monkeypatch.setattr(steps, "feature_distill_step", step)
