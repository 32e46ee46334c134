"""Precomputed schedule arrays (copy of cerebra/train/schedules.py::
cosine_scheduler and barlow_learning_rate, numpy): the recipes index them
by the step."""

from __future__ import annotations

import numpy as np


def cosine_scheduler(
    base_value: float,
    final_value: float,
    epochs: int,
    niter_per_ep: int,
    warmup_epochs: int = 0,
    start_warmup_value: float = 0.0,
) -> np.ndarray:
    """utils/utils.py:187-198: linear warmup, then a half-cosine decay; the
    length is exactly epochs·niter_per_ep."""
    warmup_iters = warmup_epochs * niter_per_ep
    warmup = (
        np.linspace(start_warmup_value, base_value, warmup_iters)
        if warmup_epochs > 0
        else np.array([])
    )
    iters = np.arange(epochs * niter_per_ep - warmup_iters)
    schedule = final_value + 0.5 * (base_value - final_value) * (
        1 + np.cos(np.pi * iters / len(iters))
    )
    out = np.concatenate((warmup, schedule))
    if len(out) != epochs * niter_per_ep:
        raise ValueError(f"schedule of {len(out)} steps for {epochs}x{niter_per_ep}")
    return out


def barlow_learning_rate(
    epochs: int, niter_per_ep: int, batch_size: int, warmup_epochs: int = 10
) -> np.ndarray:
    """EEG-BarlowNetworks/barlow_utils.py:8-21: base_lr = batch/256, a linear
    warmup over `warmup_epochs`, then a cosine to 0.001·base. Returned
    unscaled: the recipe multiplies it by each group's factor."""
    max_steps = epochs * niter_per_ep
    warmup_steps = warmup_epochs * niter_per_ep
    base_lr = batch_size / 256.0
    steps = np.arange(max_steps)
    warm = base_lr * steps / max(warmup_steps, 1)
    s = steps - warmup_steps
    denom = max(max_steps - warmup_steps, 1)
    q = 0.5 * (1 + np.cos(np.pi * s / denom))
    end_lr = base_lr * 0.001
    cos = base_lr * q + end_lr * (1 - q)
    return np.where(steps < warmup_steps, warm, cos)
