"""flax's Dropout with its masks as data (the Conformer and the
EEG-ChannelNet blocks): x/keep where the mask keeps, else 0.

A module in training mode takes `drop(x, rate)`: `dropout_from(generator)`
draws the masks from a torch.Generator; a test feeds masks it also gives the
JAX package. Without one, torch's F.dropout (the global generator)."""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

Drop = Callable[[torch.Tensor, float], torch.Tensor]


def dropout_from(generator: torch.Generator) -> Drop:
    """Bernoulli(keep) masks drawn from `generator` (on the tensors' device)."""
    def drop(x: torch.Tensor, rate: float) -> torch.Tensor:
        keep = 1.0 - rate
        mask = torch.empty(x.shape, device=x.device).bernoulli_(keep, generator=generator)
        return torch.where(mask.bool(), x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
    return drop


def _torch_dropout(x: torch.Tensor, rate: float) -> torch.Tensor:
    return F.dropout(x, rate, training=True)


def _identity(x: torch.Tensor, rate: float) -> torch.Tensor:
    return x


def active(drop: Optional[Drop], training: bool) -> Drop:
    """The dropout a module applies: `drop` (or F.dropout) in training, none
    in eval."""
    return (drop or _torch_dropout) if training else _identity
