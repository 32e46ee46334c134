"""The loss-NaN abort (port of cerebra/train/resume.py::check_finite_loss)."""

from __future__ import annotations

import math


def check_finite_loss(loss: float, step: int) -> None:
    """Loss-NaN abort (dino/main_dino.py:387-389)."""
    if not math.isfinite(loss):
        raise FloatingPointError(f"Loss is {loss} at step {step}, stopping training")
