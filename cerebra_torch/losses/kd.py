"""Knowledge-distillation losses, Hinton style (port of cerebra/losses/kd.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _soft_kl_terms(student_logits, teacher_logits, T):
    """p·(log p − log q) per element, p = softmax(t/T) clipped at 1e-30
    inside its log, q = softmax(s/T)."""
    p = F.softmax(teacher_logits / T, dim=-1)
    log_q = F.log_softmax(student_logits / T, dim=-1)
    return p * (torch.log(torch.clamp(p, min=1e-30)) - log_q)


def hinton_kd_loss(student_logits: torch.Tensor, labels: torch.Tensor,
                   teacher_logits: torch.Tensor, temperature: float,
                   alpha: float) -> torch.Tensor:
    """LstmDistillFromDinoV2TrainSpampinato.py:107-121:
    KLDiv(log_softmax(s/T), softmax(t/T))·(α·T²) + CE(s, labels)·(1−α).
    The KL is averaged over all B·D elements, as nn.KLDivLoss()'s default
    'mean' reduction does and the reference relies on."""
    T = temperature
    kld = torch.mean(_soft_kl_terms(student_logits, teacher_logits, T))
    onehot = F.one_hot(labels.long(), student_logits.shape[-1]).to(student_logits.dtype)
    ce = torch.mean(torch.sum(-onehot * F.log_softmax(student_logits, dim=-1), dim=-1))
    return kld * (alpha * T * T) + ce * (1.0 - alpha)


def _smooth_l1(x: torch.Tensor, y: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    d = torch.abs(x - y)
    return torch.mean(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta))


def kl_kd_smooth_l1_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                         temperature: float, soft_target_loss_weight: float,
                         ce_loss_weight: float) -> torch.Tensor:
    """LSTMDistillRetreival.py:40-70: the soft-target KL·T² (summed, over B)
    mixed with smooth-L1 on the raw features."""
    T = temperature
    B = student_logits.shape[0]
    soft = torch.sum(_soft_kl_terms(student_logits, teacher_logits, T)) / B * (T ** 2)
    return soft_target_loss_weight * soft + ce_loss_weight * _smooth_l1(student_logits,
                                                                        teacher_logits)
