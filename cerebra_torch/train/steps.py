"""The feature-distillation training step (port of
cerebra/train/steps.py::make_feature_distill_step)."""

from __future__ import annotations

from typing import Callable

import torch


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
