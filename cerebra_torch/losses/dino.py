"""DINO self-distillation losses with explicit center state (port of
cerebra/losses/dino.py: teacher_temp_schedule, update_center,
dino_multicrop_loss; LstmDistillation.py:101-159, dino/main_dino.py:428-481).

The center is a (1, D) tensor returned beside the loss; multi-GPU averaging
of the batch center is not ported yet (one device).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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


def update_center(center: torch.Tensor, teacher_output: torch.Tensor,
                  center_momentum: float = 0.9) -> torch.Tensor:
    """Center EMA (LstmDistillation.py:146-159); teacher_output (M, D) is
    every teacher view flattened."""
    batch_center = teacher_output.mean(0, keepdim=True)
    return center * center_momentum + batch_center * (1.0 - center_momentum)


def dino_multicrop_loss(
    student_output: torch.Tensor,  # (n_crops, B, D): the student on all views
    teacher_output: torch.Tensor,  # (n_teacher, B, D): the teacher on global views
    center: torch.Tensor,  # (1, D)
    teacher_temp: float,
    student_temp: float = 0.1,
    center_momentum: float = 0.9,
    compat_reference_pairing: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-crop DINO cross-entropy → (loss, new_center).

    Canonical pairing (dino/main_dino.py:455-468): every (teacher view iq,
    student view v) pair except v == iq. `compat_reference_pairing`
    replicates LstmDistillation.py:128-145: only student view 0 is skipped
    and each remaining view pairs against the whole stacked teacher."""
    n_crops, n_teacher = student_output.shape[0], teacher_output.shape[0]
    student_log = torch.log_softmax(student_output / student_temp, dim=-1)
    teacher_probs = torch.softmax((teacher_output - center[None]) / teacher_temp, dim=-1).detach()
    total, n_terms = 0.0, 0
    if compat_reference_pairing:
        for v in range(1, n_crops):
            total = total + (-(teacher_probs * student_log[v][None]).sum(-1)).mean()
            n_terms += 1
    else:
        for iq in range(n_teacher):
            for v in range(n_crops):
                if v == iq:
                    continue
                total = total + (-(teacher_probs[iq] * student_log[v]).sum(-1)).mean()
                n_terms += 1
    if n_terms == 0:
        raise ValueError(
            "dino_multicrop_loss: no (teacher, student) pair survives the v == iq skip — "
            "need at least 2 crops (or 2 teacher views); got n_teacher=1, n_crops=1"
        )
    new_center = update_center(
        center, teacher_output.reshape(-1, teacher_output.shape[-1]).detach(), center_momentum)
    return total / n_terms, new_center
