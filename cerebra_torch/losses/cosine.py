"""Cosine-similarity losses (port of cerebra/losses/cosine.py;
LSTMDistill.py:28-58)."""

from __future__ import annotations

import torch


def _cosine(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    num = torch.sum(a * b, dim=-1)
    den = torch.clamp(torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1), min=eps)
    return num / den


def cosine_similarity_loss(student_outputs: torch.Tensor, teacher_outputs: torch.Tensor,
                           negative_form: bool = False) -> torch.Tensor:
    """`1 − mean(cos(s, t))` (CosineSimilarityLoss, LSTMDistill.py:28-35);
    with `negative_form`, `−mean(cos)` (the functional variant, :37-58)."""
    c = torch.mean(_cosine(student_outputs, teacher_outputs))
    return -c if negative_form else 1.0 - c


def cosine_embedding_loss(x1: torch.Tensor, x2: torch.Tensor, target: torch.Tensor,
                          margin: float = 0.0) -> torch.Tensor:
    """torch `nn.CosineEmbeddingLoss` as the JAX package writes it: per pair
    `1 − cos` where target == 1, `max(0, cos − margin)` where target == −1;
    the mean over pairs."""
    c = _cosine(x1, x2)
    per_pair = torch.where(target == 1, 1.0 - c, torch.clamp(c - margin, min=0.0))
    return torch.mean(per_pair)
