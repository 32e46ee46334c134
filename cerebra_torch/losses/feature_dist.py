"""FeatureDistributionLoss v1, v2 and v3 (port of
cerebra/losses/feature_dist.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cerebra_torch.parallel.collectives import psum


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


def feature_distribution_loss_v2(student_outputs: torch.Tensor,
                                 teacher_outputs: torch.Tensor, group=None) -> torch.Tensor:
    """LstmDistillation.py:161-172 (mean/std matching), port of
    cerebra/losses/feature_dist.py:46-54:
    0.4·MSE(σ_s,σ_t) + 0.4·MSE(μ_s,μ_t) + 0.2·MSE(s,t), the mean and std
    scalars over ALL elements, std unbiased (ddof = 1) in two passes as
    jnp.std takes it. With a process `group` (rows of a global batch on
    each rank) every statistic and the MSE are the global batch's, through
    differentiable all-reduces."""
    def total(x):  # the sum over the (global) batch
        return x.sum() if group is None else psum(x.sum(), group)

    n = total(torch.tensor(float(student_outputs.numel()), device=student_outputs.device))

    def mean_std(x):
        mean = total(x) / n
        return mean, torch.sqrt(total((x - mean) ** 2) / (n - 1))

    s_mean, s_std = mean_std(student_outputs)
    t_mean, t_std = mean_std(teacher_outputs)
    mse = total((student_outputs - teacher_outputs) ** 2) / n
    return 0.4 * (s_std - t_std) ** 2 + 0.4 * (s_mean - t_mean) ** 2 + 0.2 * mse


def feature_distribution_loss_v3(student_outputs: torch.Tensor, teacher_outputs: torch.Tensor,
                                 temperature: float) -> torch.Tensor:
    """LstmDistillFromDinoV2Eval.py:106-146 (soft-target KL · T²), port of
    cerebra/losses/feature_dist.py:57-71: sum(p_T·(log p_T − log q_T))/B·T².
    p is clipped at 1e-30 before its log, the JAX package's deliberate
    deviation: a teacher class that underflows to 0 adds 0, not NaN."""
    T = temperature
    p = F.softmax(teacher_outputs / T, dim=-1)
    log_q = F.log_softmax(student_outputs / T, dim=-1)
    B = student_outputs.shape[0]
    return torch.sum(p * (torch.log(torch.clamp(p, min=1e-30)) - log_q)) / B * (T ** 2)
