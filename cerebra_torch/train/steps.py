"""Training steps (port of cerebra/train/steps.py): the feature-distillation
step and the DINO step with its train state and scheduled optimizer."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from cerebra_torch.losses.dino import dino_multicrop_loss
from cerebra_torch.parallel.mesh import data_parallel
from cerebra_torch.parallel.tp import shard_dino_state
from cerebra_torch.signal.windows import multicrop_views
from cerebra_torch.train.ema import ema_update
from cerebra_torch.train.optim import ScheduledAdamW, cancel_last_layer_grads


def feature_distill_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable,
    eeg: torch.Tensor,
    teacher_feats: torch.Tensor,
    labels: torch.Tensor,
    epoch: int,
) -> torch.Tensor:
    """One step of LstmDistillFromDinoV2Train (SURVEY.md §3.1): LSTM forward
    on EEG, loss against cached teacher features, backward, update.

    loss_fn(feats, cls_pred, teacher_feats, labels, epoch) → scalar. Returns
    the detached loss without synchronising with the device."""
    optimizer.zero_grad(set_to_none=True)
    feats, cls_pred = model(eeg)
    loss = loss_fn(feats, cls_pred, teacher_feats, labels, epoch)
    loss.backward()
    optimizer.step()
    return loss.detach()


# ------------------------------------------------------------------- DINO
@dataclasses.dataclass
class DinoTrainState:
    """Student (with its optimizer), teacher and center — the reference
    checkpoint trio student/teacher/dino_loss (LstmDistillation.py:634-646).
    `step` counts the iterations taken; `forward`, when set, is what the step
    calls for the student (its DDP wrapper under a mesh)."""

    step: int
    student: torch.nn.Module
    teacher: torch.nn.Module
    optimizer: ScheduledAdamW
    center: torch.Tensor
    forward: Optional[torch.nn.Module] = None


def distribute_dino_state(mesh, state: DinoTrainState, out_dim: int) -> None:
    """The meshed DINO state (cerebra/train/recipes.py:441-497): rank 0's
    values everywhere, the head's prototypes sharded over a "model" axis
    (`shard_dino_state`), and the student wrapped in DDP over the data group
    as the step's `forward`. The teacher stays replicated because its
    student does."""
    shard_dino_state(mesh, state, out_dim=out_dim)
    state.forward = data_parallel(state.student, mesh)


def make_dino_step(
    lr_schedule,
    wd_schedule,
    momentum_schedule,
    teacher_temp_by_epoch,
    niter_per_ep: int,
    view_fn: Optional[Callable] = None,  # (generator, batch) -> [groups (n_v, B, ...)]
    global_length: int = 300,
    local_length: int = 200,
    n_global: int = 2,
    n_local: int = 4,
    student_temp: float = 0.1,
    center_momentum: float = 0.9,
    freeze_last_layer: int = 1,
    compat_reference_pairing: bool = False,
    data_group=None,
):
    """One DINO iteration (port of cerebra/train/steps.py::make_dino_step;
    SURVEY.md §3.2): views, the teacher on the first (global) group, the
    student on every group (one batched forward per group), the multi-crop
    loss, the last-layer cancel, the optimizer (clip, scheduled AdamW), the
    teacher EMA and the center EMA.

    The schedules are indexed by `state.step` (lr and wd by the optimizer's
    own count, which equals it). `view_fn` defaults to the temporal
    multi-crop. The student and teacher are MultiCropWrapper modules; the
    student is in training mode (drop path active), the teacher in eval.
    Under a mesh `batch` is this rank's rows, `data_group` the mesh's data
    group, and a head sharded over "model" names its group itself
    (`losses/dino.py`)."""
    lr_schedule = np.asarray(lr_schedule, dtype=np.float32)
    wd_schedule = np.asarray(wd_schedule, dtype=np.float32)
    momentum_schedule = np.asarray(momentum_schedule, dtype=np.float32)
    teacher_temp_by_epoch = np.asarray(teacher_temp_by_epoch, dtype=np.float32)

    if view_fn is None:
        def view_fn(generator, eeg):  # noqa: F811 — default temporal multicrop
            return list(multicrop_views(eeg, global_length, local_length, n_global, n_local,
                                        generator))

    def step(state: DinoTrainState, batch, generator=None):
        it = state.step
        epoch = it // niter_per_ep
        t_temp = float(teacher_temp_by_epoch[epoch])
        groups = view_fn(generator, batch)
        n_teacher, B = groups[0].shape[:2]
        n_crops = sum(int(g.shape[0]) for g in groups)

        # teacher: only the global group (LstmDistillation.py:584-586)
        with torch.no_grad():
            teacher_out = state.teacher([groups[0]]).reshape(n_teacher, B, -1).float()
        student_out = (state.forward or state.student)(groups).reshape(n_crops, B, -1).float()
        loss, new_center = dino_multicrop_loss(
            student_out, teacher_out, state.center, teacher_temp=t_temp,
            student_temp=student_temp, center_momentum=center_momentum,
            compat_reference_pairing=compat_reference_pairing, data_group=data_group,
            model_group=state.student.head.model_group,
        )
        state.optimizer.zero_grad()
        loss.backward()
        cancel_last_layer_grads(state.student, epoch, freeze_last_layer)
        state.optimizer.step()
        ema_update(state.teacher, state.student, float(momentum_schedule[it]))
        state.center = new_center
        state.step = it + 1
        return state, {"loss": loss.detach(), "lr": float(lr_schedule[it]),
                       "wd": float(wd_schedule[it]), "momentum": float(momentum_schedule[it])}

    return step


def make_scheduled_optimizer(name: str, model: torch.nn.Module, lr_schedule, wd_schedule,
                             clip_grad: Optional[float] = None) -> ScheduledAdamW:
    """AdamW whose lr and weight decay follow precomputed arrays indexed by
    the optimizer step, with the ndim>1 weight-decay rule (port of
    cerebra/train/steps.py::make_scheduled_optimizer, its AdamW branch)."""
    if name != "adamw":
        raise ValueError("scheduled weight decay is an AdamW recipe (dino/main_dino.py:245-267)")
    return ScheduledAdamW(model, lr_schedule, wd_schedule, clip_grad)
