"""Optimizers (port of cerebra/train/optim.py::make_optimizer, the rmsprop
branch that the LSTM→DINOv2 trainer uses)."""

from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                   learning_rate: float = 1e-3) -> torch.optim.Optimizer:
    """`rmsprop` is torch.optim.RMSprop with alpha 0.99 and eps 1e-8 added
    outside the sqrt — the rule the JAX package's optax chain was pinned to
    (cerebra/train/optim.py:86-91). Other optimizers are not ported yet."""
    if name == "rmsprop":
        return torch.optim.RMSprop(params, lr=learning_rate, alpha=0.99, eps=1e-8)
    raise NotImplementedError(f"optimizer {name!r} is not ported yet (rmsprop only)")
