"""Barlow Twins redundancy-reduction loss (port of cerebra/losses/barlow.py;
EEG-BarlowNetworks/net.py:33-42): c = BN(z1)ᵀ BN(z2) / B, then on-diag
(c_ii − 1)² + λ · off-diag c_ij², λ = 0.0051 (train.py:40).

With a process `group` (the data group of a mesh) the BatchNorm statistics
are the group's means (SyncBatchNorm, train.py:89) and c is summed over it
and divided by the global batch (the reference's all_reduce(c), net.py:38),
both differentiable: every rank holds the global loss.
"""

from __future__ import annotations

from typing import Optional

import torch

from cerebra_torch.parallel.collectives import axis_size, pmean, psum


def _batch_norm_nonaffine(z: torch.Tensor, eps: float = 1e-5, group=None) -> torch.Tensor:
    """nn.BatchNorm1d(affine=False) in training mode: per-feature
    standardisation across the batch with the biased variance, taken in one
    pass, E[z²] − E[z]², as the JAX package does (not torch's two-pass
    F.batch_norm); with `group` the statistics are its means."""
    mean = z.mean(dim=0, keepdim=True)
    sq = (z * z).mean(dim=0, keepdim=True)
    if group is not None:
        mean, sq = pmean(torch.cat([mean, sq]), group).chunk(2)
    var = sq - mean * mean
    return (z - mean) * torch.rsqrt(var + eps)


def barlow_twins_loss(z1: torch.Tensor, z2: torch.Tensor, lambd: float = 0.0051,
                      global_batch_size: Optional[int] = None, group=None) -> torch.Tensor:
    """z1, z2: (B, D) projector outputs of the image and the EEG branch
    (this rank's rows under `group`)."""
    if global_batch_size is None:
        global_batch_size = z1.shape[0] * (axis_size(group) if group is not None else 1)
    c = _batch_norm_nonaffine(z1, group=group).T @ _batch_norm_nonaffine(z2, group=group)
    c = c / global_batch_size
    if group is not None:
        c = psum(c, group)
    diag = torch.diagonal(c)
    on_diag = torch.sum((diag - 1.0) ** 2)
    off_diag = torch.sum(c ** 2) - torch.sum(diag ** 2)
    return on_diag + lambd * off_diag
