"""Barlow Twins redundancy-reduction loss (port of cerebra/losses/barlow.py;
EEG-BarlowNetworks/net.py:33-42): c = BN(z1)ᵀ BN(z2) / B, then on-diag
(c_ii − 1)² + λ · off-diag c_ij², λ = 0.0051 (train.py:40).

One process: the JAX package's psum over a data axis (SyncBN statistics, the
reference's all_reduce(c)) waits for the multi-GPU port.
"""

from __future__ import annotations

from typing import Optional

import torch


def _batch_norm_nonaffine(z: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """nn.BatchNorm1d(affine=False) in training mode: per-feature
    standardisation across the batch with the biased variance, taken in one
    pass, E[z²] − E[z]², as the JAX package does (not torch's two-pass
    F.batch_norm)."""
    mean = z.mean(dim=0, keepdim=True)
    sq = (z * z).mean(dim=0, keepdim=True)
    var = sq - mean * mean
    return (z - mean) * torch.rsqrt(var + eps)


def barlow_twins_loss(z1: torch.Tensor, z2: torch.Tensor, lambd: float = 0.0051,
                      global_batch_size: Optional[int] = None) -> torch.Tensor:
    """z1, z2: (B, D) projector outputs of the image and the EEG branch."""
    if global_batch_size is None:
        global_batch_size = z1.shape[0]
    c = _batch_norm_nonaffine(z1).T @ _batch_norm_nonaffine(z2)
    c = c / global_batch_size
    diag = torch.diagonal(c)
    on_diag = torch.sum((diag - 1.0) ** 2)
    off_diag = torch.sum(c ** 2) - torch.sum(diag ** 2)
    return on_diag + lambd * off_diag
