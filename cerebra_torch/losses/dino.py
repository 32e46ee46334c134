"""The teacher-temperature schedule (port of
cerebra/losses/dino.py::teacher_temp_schedule, numpy)."""

from __future__ import annotations

import numpy as np


def teacher_temp_schedule(
    warmup_teacher_temp: float,
    teacher_temp: float,
    warmup_teacher_temp_epochs: int,
    nepochs: int,
) -> np.ndarray:
    """Per-epoch teacher temperature: linear warmup then constant
    (LstmDistillation.py:112-117). Negative warmup values are replicated
    as-is — it is a schedule, not a crash."""
    return np.concatenate(
        [
            np.linspace(warmup_teacher_temp, teacher_temp, warmup_teacher_temp_epochs),
            np.ones(max(nepochs - warmup_teacher_temp_epochs, 0)) * teacher_temp,
        ]
    )
