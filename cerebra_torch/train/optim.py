"""Optimizers (port of cerebra/train/optim.py and
cerebra/train/steps.py::make_scheduled_optimizer): RMSprop for the
LSTM→DINOv2 trainer, and the DINO recipe's AdamW with per-step lr and weight
decay, the reference's param groups, per-parameter clipping and the
last-layer cancel."""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch
from torch import nn


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                   learning_rate: float = 1e-3) -> torch.optim.Optimizer:
    """`rmsprop` is torch.optim.RMSprop with alpha 0.99 and eps 1e-8 added
    outside the sqrt — the rule the JAX package's optax chain was pinned to
    (cerebra/train/optim.py:86-91). Other optimizers are not ported yet."""
    if name == "rmsprop":
        return torch.optim.RMSprop(params, lr=learning_rate, alpha=0.99, eps=1e-8)
    raise NotImplementedError(f"optimizer {name!r} is not ported yet (rmsprop only)")


def decays(name: str, p: torch.Tensor) -> bool:
    """Weight decay where the JAX tree's parameter has ndim > 1
    (utils/utils.py:636-647, `no_weight_decay_mask`). It decays pos_embed
    and cls_token and exempts biases, norms and the weight-norm gain g, which
    is 1-D in the JAX tree whatever shape the port stores it in."""
    return p.dim() > 1 and not name.endswith("weight_g")


@torch.no_grad()
def per_param_clip(params: Sequence[torch.nn.Parameter], clip: float) -> None:
    """Per-parameter L2-norm clip (utils/utils.py:132-141), in place: each
    gradient is scaled by min(1, clip/(‖g‖+1e-6)) on its own, not by a
    global norm."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norms = torch._foreach_norm([g.float() for g in grads])
    coefs = [torch.clamp(clip / (n + 1e-6), max=1.0) for n in norms]
    torch._foreach_mul_(grads, coefs)


@torch.no_grad()
def cancel_last_layer_grads(model: nn.Module, epoch: int, freeze_last_layer: int) -> None:
    """Zero the DINOHead last-layer gradients while epoch < freeze_last_layer
    (utils/utils.py:144-149). The JAX package multiplies them by 0 and optax
    still updates the parameter (AdamW decays last_layer.v); torch skips a
    parameter whose grad is None, so the grads are zeroed, not dropped."""
    if epoch >= freeze_last_layer:
        return
    for name, p in model.named_parameters():
        if "last_layer" in name.split(".") and p.requires_grad:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.zero_()


class ScheduledAdamW:
    """optax.adamw(lr, weight_decay=wd, mask=ndim>1) with lr and wd read from
    precomputed arrays at the optimizer's own step count (the reference's
    per-iteration param_group mutation, LstmDistillation.py:543-547), after a
    per-parameter clip when `clip_grad` is set. Parameters that do not
    require grad (a fixed weight-norm gain) are left out, as optax leaves
    them unchanged."""

    def __init__(self, model: nn.Module, lr_schedule, wd_schedule, clip_grad: Optional[float]):
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.params = [p for _, p in named]
        groups = [
            {"params": [p for n, p in named if decays(n, p)], "decay": True},
            {"params": [p for n, p in named if not decays(n, p)], "decay": False},
        ]
        self.lr = np.asarray(lr_schedule, dtype=np.float32)
        self.wd = np.asarray(wd_schedule, dtype=np.float32)
        self.clip = clip_grad
        self.count = 0
        self.inner = torch.optim.AdamW(groups, lr=float(self.lr[0]), betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=0.0)

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.clip is not None:
            per_param_clip(self.params, self.clip)
        i = min(self.count, len(self.lr) - 1)
        for group in self.inner.param_groups:
            group["lr"] = float(self.lr[i])
            group["weight_decay"] = float(self.wd[min(self.count, len(self.wd) - 1)]) \
                if group["decay"] else 0.0
        self.inner.step()
        self.count += 1
