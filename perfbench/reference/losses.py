"""The losses, plainly: FeatureDistributionLoss v1
(LstmDistillFromDinoV2Train.py:107-140, its term2 as written: the
teacher's softmax is the cross-entropy's input, the student's softmax its
target) and the DINO multi-crop cross-entropy with its center
(dino/main_dino.py:428-481: every teacher view against every other view)."""

import torch
import torch.nn.functional as F


def _soft_ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.sum(-target * F.log_softmax(logits, dim=-1), dim=-1))


def feature_distribution_v1(feats, teacher, labels, logits, temperature: float, alpha: float,
                            beta: float) -> torch.Tensor:
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    term1 = alpha * _soft_ce(logits, onehot)
    term2 = beta * _soft_ce(F.softmax(teacher / temperature, dim=-1),
                            F.softmax(feats / temperature, dim=-1))
    return term1 + term2


def dino_multicrop(student, teacher, center, teacher_temp: float, student_temp: float,
                   center_momentum: float):
    """student (n_crops, B, D), teacher (n_teacher, B, D), center (1, D) →
    (loss, new center)."""
    log_s = F.log_softmax(student / student_temp, dim=-1)
    probs_t = F.softmax((teacher - center[None]) / teacher_temp, dim=-1).detach()
    terms = [torch.sum(-probs_t[iq] * log_s[v], dim=-1).mean()
             for iq in range(teacher.shape[0]) for v in range(student.shape[0]) if v != iq]
    loss = sum(terms) / len(terms)
    batch_center = teacher.detach().reshape(-1, teacher.shape[-1]).mean(0, keepdim=True)
    return loss, center * center_momentum + batch_center * (1.0 - center_momentum)
