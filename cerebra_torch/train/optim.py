"""Optimizers (port of cerebra/train/optim.py and
cerebra/train/steps.py::make_scheduled_optimizer): the reference zoo
{adamw, adam, sgd, rmsprop, lars} with its param groups and per-parameter
clipping, and the DINO recipes' AdamW with per-step lr and weight decay and
the last-layer cancel."""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


def decay_groups(params: Iterable[torch.nn.Parameter], weight_decay: float,
                 masked: bool) -> list:
    """The reference's two param groups (utils/utils.py:636-647): weight
    decay on the parameters with ndim > 1, none on biases and other 1-D
    parameters (`no_weight_decay_mask`), each group marked `decayed`. Not
    `masked`: one group of every parameter, with the decay. Empty groups
    are left out."""
    params = list(params)
    decayed = (lambda p: p.dim() > 1) if masked else (lambda p: True)
    groups = [{"params": [p for p in params if decayed(p)], "weight_decay": weight_decay,
               "decayed": True},
              {"params": [p for p in params if not decayed(p)], "weight_decay": 0.0,
               "decayed": False}]
    return [g for g in groups if g["params"]]


class Lars(torch.optim.Optimizer):
    """optax.lars in optax's order (cerebra/train/optim.py:98-105): the
    decayed weights (g + wd·p), then the trust ratio
    coefficient·‖p‖/(‖u‖ + eps), 1 where either norm is 0, then the
    learning rate (−lr·u), then momentum as a trace (t = u + m·t₋₁, the
    step adds t). A group's `trust_ratio` False skips the ratio (optax's
    `trust_ratio_mask`). torch has no LARS."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0, momentum: float = 0.9,
                 trust_coefficient: float = 1e-3, eps: float = 0.0, trust_ratio: bool = True):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, momentum=momentum,
                                      trust_coefficient=trust_coefficient, eps=eps,
                                      trust_ratio=trust_ratio))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                if group["trust_ratio"]:
                    p_norm, u_norm = torch.linalg.norm(p), torch.linalg.norm(u)
                    ratio = group["trust_coefficient"] * p_norm / (u_norm + group["eps"])
                    u = u * torch.where((p_norm == 0) | (u_norm == 0),
                                        torch.ones_like(ratio), ratio)
                u = -group["lr"] * u
                state = self.state[p]
                if "trace" in state:
                    u = u + group["momentum"] * state["trace"]
                state["trace"] = u
                p.add_(u)
        return loss


def make_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                   learning_rate: float = 1e-3, weight_decay: float = 0.0,
                   clip_grad: Optional[float] = None, momentum: float = 0.9,
                   masked: bool = False) -> torch.optim.Optimizer:
    """The reference optimizer zoo (port of cerebra/train/optim.py:61-110),
    name in {adamw, adam, sgd, rmsprop, lars}. `masked` is the port of the
    JAX function's `params_mask_source`: True masks the decay (and LARS's
    trust ratio) to ndim > 1; the default applies them to every parameter,
    as the JAX function does without a mask source (its recipes call it
    so, with no decay).

    - adamw: decoupled decay, torch.optim.AdamW (optax.adamw's order).
    - adam, sgd (momentum), rmsprop: decay *coupled* into the gradient
      before the moments, as optax chains `add_decayed_weights` ahead of the
      inner transform; torch's `weight_decay=` on these does the same.
      rmsprop is alpha 0.99, eps 1e-8 outside the sqrt.
    - lars: `Lars`, coefficient 1e-3, eps 0, the trust ratio masked like
      the decay, momentum `momentum`.
    With `clip_grad`, each parameter's gradient is clipped on its own
    (`per_param_clip`) ahead of every step, by a step pre-hook."""
    params = [p for p in params if p.requires_grad]
    groups = decay_groups(params, weight_decay, masked)
    if name == "adamw":
        opt = torch.optim.AdamW(groups, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    elif name == "adam":
        opt = torch.optim.Adam(groups, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    elif name == "sgd":
        opt = torch.optim.SGD(groups, lr=learning_rate, momentum=momentum)
    elif name == "rmsprop":
        opt = torch.optim.RMSprop(groups, lr=learning_rate, alpha=0.99, eps=1e-8)
    elif name == "lars":
        opt = Lars([dict(g, trust_ratio=g["decayed"]) for g in groups], lr=learning_rate,
                   momentum=momentum)
    else:
        raise ValueError(f"unknown optimizer: {name}")
    if clip_grad is not None:
        opt.register_step_pre_hook(lambda *_: per_param_clip(params, clip_grad))
    return opt


def decays(name: str, p: torch.Tensor) -> bool:
    """Weight decay where the JAX tree's parameter has ndim > 1
    (utils/utils.py:636-647, `no_weight_decay_mask`). It decays pos_embed
    and cls_token and exempts biases, norms and the weight-norm gain g, which
    is 1-D in the JAX tree whatever shape the port stores it in."""
    return p.dim() > 1 and not name.endswith("weight_g")


@torch.no_grad()
def per_param_clip(params: Sequence[torch.nn.Parameter], clip: float,
                   sharded=(), group=None) -> None:
    """Per-parameter L2-norm clip (utils/utils.py:132-141), in place: each
    gradient is scaled by min(1, clip/(‖g‖+1e-6)) on its own, not by a
    global norm. A parameter in `sharded` holds a shard over the process
    `group` (the DINO head's prototypes): its norm is the whole
    parameter's, the squares summed over the group, as GSPMD takes it."""
    with_grad = [p for p in params if p.grad is not None]
    if not with_grad:
        return
    grads = [p.grad for p in with_grad]
    norms = list(torch._foreach_norm([g.float() for g in grads]))
    shard_ids = {id(p) for p in sharded}
    split = [i for i, p in enumerate(with_grad) if id(p) in shard_ids]
    if split:
        sq = torch.stack([norms[i] for i in split]) ** 2
        dist.all_reduce(sq, group=group)
        for i, n in zip(split, sq.sqrt()):
            norms[i] = n
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
        self.sharded, self.model_group = (), None
        self.count = 0
        self.inner = torch.optim.AdamW(groups, lr=float(self.lr[0]), betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=0.0)

    def shard_group(self, group, params) -> None:
        """`params` hold shards over `group`: their clip norms are the whole
        parameters' (`per_param_clip`)."""
        self.sharded, self.model_group = list(params), group

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.clip is not None:
            per_param_clip(self.params, self.clip, self.sharded, self.model_group)
        i = min(self.count, len(self.lr) - 1)
        for group in self.inner.param_groups:
            group["lr"] = float(self.lr[i])
            group["weight_decay"] = float(self.wd[min(self.count, len(self.wd) - 1)]) \
                if group["decay"] else 0.0
        self.inner.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])
