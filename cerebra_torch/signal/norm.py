"""Normalisation ops over (..., T, C) time-major EEG (port of
cerebra/signal/norm.py).

- `channel_wise_norm`: per-channel norm over time, `normlizeEEG`
  (utils/PerilsEEGDataset.py:454-461), all channels and trials at once;
- `z2_score_norm`: whole-sample norm (utils/PerilsEEGDataset.py:581-584);
- `global_scalar_norm`: corpus scalar stats (utils/PerilsEEGDataset.py:570-571);
- `random_channel_norm_view` and `three_view_augment`: the 3-view
  `data_augment_eeg` stack (utils/PerilsEEGDataset.py:575-587).

std is unbiased (ddof = 1, torch.Tensor.std's default, which the reference
relies on). Randomness is a `torch.Generator` or draws passed in, not a JAX
key: the two give different numbers from one seed, so tests hand both the
same draws.
"""

from __future__ import annotations

from typing import Optional

import torch


def channel_wise_norm(eeg: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Per-channel (over time) standardisation of (..., T, C) EEG."""
    mean = eeg.mean(dim=-2, keepdim=True)
    std = eeg.std(dim=-2, keepdim=True, correction=1)
    return (eeg - mean) / (std + eps)


def z2_score_norm(eeg: torch.Tensor) -> torch.Tensor:
    """Whole-sample scalar standardisation over each trial's (T, C)."""
    dims = (eeg.dim() - 2, eeg.dim() - 1)
    mean = eeg.mean(dim=dims, keepdim=True)
    std = eeg.std(dim=dims, keepdim=True, correction=1)
    return (eeg - mean) / std


def global_scalar_norm(eeg: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """(eeg - mean) / std with corpus scalar stats."""
    return (eeg - mean) / std


def random_channel_norm_view(eeg: torch.Tensor, n_channels: int = 32,
                             generator: Optional[torch.Generator] = None,
                             draws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalise a random subset of the channels of one (T, C) trial
    (utils/PerilsEEGDataset.py:576-580). The reference draws `n_channels`
    indices WITH replacement and normalises them one after another; a second
    normalisation of a standardised channel changes nothing, so this
    normalises the unique drawn set. `draws` (n_channels,) replaces the draw
    from `generator`."""
    C = eeg.shape[-1]
    if draws is None:
        draws = torch.randint(0, C, (n_channels,), generator=generator)
    mask = torch.zeros(C, dtype=torch.bool, device=eeg.device)
    mask[draws.to(eeg.device)] = True
    return torch.where(mask, channel_wise_norm(eeg), eeg)


def three_view_augment(eeg: torch.Tensor, generator: Optional[torch.Generator] = None,
                       draws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The `data_augment_eeg` 3-view stack of (B, T, C) → (B, 3, T, C):
    (chnorm, chnorm, z2(chnorm)). The reference's `channel_norm_eeg = eeg` is
    an alias that `normlizeEEG` mutates in place, so by stack time `eeg`
    itself is the channel-normed view and z2's stats come from it. `draws`
    (B, 32) replaces the draws from `generator`, one row a trial."""
    if draws is None:
        draws = torch.randint(0, eeg.shape[-1], (eeg.shape[0], 32), generator=generator)
    ch_view = torch.stack([random_channel_norm_view(e, draws=d) for e, d in zip(eeg, draws)])
    return torch.stack([ch_view, ch_view, z2_score_norm(ch_view)], dim=1)
