"""FeatureDistributionLoss v1 (port of cerebra/losses/feature_dist.py:18-39)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _softmax_ce_with_prob_targets(logits: torch.Tensor, target_probs: torch.Tensor) -> torch.Tensor:
    """torch F.cross_entropy(input, probability-targets):
    mean over batch of -sum(target * log_softmax(input))."""
    return torch.mean(torch.sum(-target_probs * F.log_softmax(logits, dim=-1), dim=-1))


def feature_distribution_loss_v1(
    student_outputs: torch.Tensor,  # (B, D) regressed features
    teacher_outputs: torch.Tensor,  # (B, D) frozen teacher features
    labels: torch.Tensor,  # (B,) int class ids
    pred_label_logits: torch.Tensor,  # (B, n_classes)
    temperature: float,
    alpha: float = 0.5,
    beta: float = 0.5,
) -> torch.Tensor:
    """LstmDistillFromDinoV2Train.py:107-140.

    term1 = α·CE(pred_label, label);
    term2 = β·CE(softmax(teacher/T), softmax(student/T)) — replicated as
    written: the teacher's *softmax output* is the CE input (re-softmaxed
    inside) with the student's softmax as probability targets.

    The temperature is an f32 scalar, as the JAX recipe's `temps[epoch]`
    array is, so both softmaxes of term2 run in f32 whatever the feature
    dtype.
    """
    onehot = F.one_hot(labels.long(), pred_label_logits.shape[-1]).to(pred_label_logits.dtype)
    term1 = alpha * _softmax_ce_with_prob_targets(pred_label_logits, onehot)
    teacher_soft = F.softmax(teacher_outputs.float() / temperature, dim=-1)
    student_soft = F.softmax(student_outputs.float() / temperature, dim=-1)
    term2 = beta * _softmax_ce_with_prob_targets(teacher_soft, student_soft)
    return term1.float() + term2
