"""Precomputed schedule arrays (copy of cerebra/train/schedules.py::
cosine_scheduler, numpy): the recipes index them by the step."""

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
