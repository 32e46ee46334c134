"""Teacher EMA update (port of cerebra/train/ema.py; LstmDistillation.py:
616-619, dino momentum schedule cosine → 1.0, dino/main_dino.py:269-270)."""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def ema_update(teacher: torch.nn.Module, student: torch.nn.Module, momentum: float) -> None:
    """teacher ← m·teacher + (1−m)·student over every parameter, in place.
    m and 1−m are taken in f32, as the JAX step indexes an f32 schedule."""
    m = np.float32(momentum)
    t = list(teacher.parameters())
    s = list(student.parameters())
    if len(t) != len(s):
        raise ValueError("teacher and student must have the same parameters")
    torch._foreach_mul_(t, float(m))
    torch._foreach_add_(t, s, alpha=float(np.float32(1.0) - m))
