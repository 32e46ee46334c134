"""DINO self-distillation losses with explicit center state (port of
cerebra/losses/dino.py: teacher_temp_schedule, update_center,
dino_multicrop_loss, dino_single_pair_loss; LstmDistillation.py:101-159, dino/main_dino.py:428-481).

The center is a (1, D) tensor returned beside the loss. Under a mesh,
`data_group` makes the loss the global batch's mean (a differentiable
pmean: DDP's mean of the ranks' gradients is then the global gradient) and
the batch center its mean over the data group (the reference's
all_reduce(center), dino/main_dino.py:477). With `model_group` the outputs
and the center hold a shard of the prototypes each (the DINO head sharded
over "model", `parallel/tp.py`): the teacher's centred, sharpened softmax
and the student's log-softmax take their max and their sum of
exponentials over the model group, and the cross-entropy's sum over
prototypes is one reduction over it, the identity backward (the
vocabulary-parallel cross-entropy).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cerebra_torch.parallel.collectives import pmax, pmean, psum, reduce_from_group


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
                  center_momentum: float = 0.9, data_group=None) -> torch.Tensor:
    """Center EMA (LstmDistillation.py:146-159); teacher_output (M, D) is
    every teacher view flattened; with `data_group` the batch center is the
    group's mean of the ranks' centers (equal batches: the global mean)."""
    batch_center = teacher_output.mean(0, keepdim=True)
    if data_group is not None:
        batch_center = pmean(batch_center, data_group)
    return center * center_momentum + batch_center * (1.0 - center_momentum)


def _softmax(x: torch.Tensor, model_group) -> torch.Tensor:
    """Softmax over the last dim, which the model group shards."""
    if model_group is None:
        return torch.softmax(x, dim=-1)
    e = torch.exp(x - pmax(x.amax(-1, keepdim=True), model_group))
    return e / psum(e.sum(-1, keepdim=True), model_group)


def _log_softmax(x: torch.Tensor, model_group) -> torch.Tensor:
    if model_group is None:
        return torch.log_softmax(x, dim=-1)
    m = pmax(x.amax(-1, keepdim=True), model_group)
    return x - (torch.log(psum(torch.exp(x - m).sum(-1, keepdim=True), model_group)) + m)


def dino_multicrop_loss(
    student_output: torch.Tensor,  # (n_crops, B, D): the student on all views
    teacher_output: torch.Tensor,  # (n_teacher, B, D): the teacher on global views
    center: torch.Tensor,  # (1, D)
    teacher_temp: float,
    student_temp: float = 0.1,
    center_momentum: float = 0.9,
    compat_reference_pairing: bool = False,
    data_group=None,
    model_group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-crop DINO cross-entropy → (loss, new_center).

    Canonical pairing (dino/main_dino.py:455-468): every (teacher view iq,
    student view v) pair except v == iq. `compat_reference_pairing`
    replicates LstmDistillation.py:128-145: only student view 0 is skipped
    and each remaining view pairs against the whole stacked teacher.
    `data_group` / `model_group`: the mesh's groups (module docstring)."""
    n_crops, n_teacher = student_output.shape[0], teacher_output.shape[0]
    student_log = _log_softmax(student_output / student_temp, model_group)
    with torch.no_grad():
        teacher_probs = _softmax((teacher_output - center[None]) / teacher_temp, model_group)

    terms = []  # each pair's cross-entropy per row, over this rank's prototypes
    if compat_reference_pairing:
        for v in range(1, n_crops):
            terms.append(-(teacher_probs * student_log[v][None]).sum(-1))
    else:
        for iq in range(n_teacher):
            for v in range(n_crops):
                if v == iq:
                    continue
                terms.append(-(teacher_probs[iq] * student_log[v]).sum(-1))
    if not terms:
        raise ValueError(
            "dino_multicrop_loss: no (teacher, student) pair survives the v == iq skip — "
            "need at least 2 crops (or 2 teacher views); got n_teacher=1, n_crops=1"
        )
    if model_group is not None:  # the sums over prototypes: one reduction
        flat = reduce_from_group(torch.cat([t.reshape(-1) for t in terms]), model_group)
        terms = [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in terms]), terms)]
    total = 0.0
    for t in terms:
        total = total + t.mean()
    loss = total / len(terms)
    if data_group is not None:
        loss = pmean(loss, data_group)
    new_center = update_center(center, teacher_output.reshape(-1, teacher_output.shape[-1]).detach(),
                               center_momentum, data_group)
    return loss, new_center


def dino_single_pair_loss(
    student_output: torch.Tensor,  # (B, D)
    teacher_output: torch.Tensor,  # (B, D)
    center: torch.Tensor,  # (1, D)
    teacher_temp: float,
    student_temp: float = 0.1,
    center_momentum: float = 0.9,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-pair variant (LstmDistillFromDinoV2Train.py:62-94): the cross
    entropy between the centred teacher softmax (no gradient) and the
    student's log-softmax → (loss, new center)."""
    student_log = torch.log_softmax(student_output / student_temp, dim=-1)
    teacher_probs = torch.softmax((teacher_output - center) / teacher_temp, dim=-1).detach()
    loss = torch.sum(-teacher_probs * student_log, dim=-1).mean()
    return loss, update_center(center, teacher_output.detach(), center_momentum)
