"""Optimizer steps and schedules, plainly, on {name: tensor} dicts:
RMSprop (torch's, alpha 0.99, eps outside the root), AdamW (decoupled
decay, bias-corrected moments), the per-parameter norm clip
(utils/utils.py:132-141), the EMA teacher, and the cosine schedules
(utils/utils.py:187-198)."""

import numpy as np
import torch


@torch.no_grad()
def rmsprop(p: dict, grads: dict, state: dict, lr: float, alpha: float, eps: float) -> None:
    for k, g in grads.items():
        v = state.get(k, torch.zeros_like(g)) * alpha + (1.0 - alpha) * g * g
        state[k] = v
        p[k] -= lr * g / (v.sqrt() + eps)


@torch.no_grad()
def adamw(p: dict, grads: dict, state: dict, t: int, lr: float, wd: float, decayed,
          betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One step, the t-th of these moments (t from 1)."""
    b1, b2 = betas
    for k, g in grads.items():
        if k in decayed:
            p[k] *= 1.0 - lr * wd
        m = state.get((k, "m"), torch.zeros_like(g)) * b1 + (1.0 - b1) * g
        v = state.get((k, "v"), torch.zeros_like(g)) * b2 + (1.0 - b2) * g * g
        state[(k, "m")], state[(k, "v")] = m, v
        denom = v.sqrt() / np.sqrt(1.0 - b2 ** t) + eps
        p[k] -= (lr / (1.0 - b1 ** t)) * m / denom


@torch.no_grad()
def clip_each(grads: dict, clip: float) -> None:
    for k, g in grads.items():
        g *= torch.clamp(clip / (g.norm() + 1e-6), max=1.0)


@torch.no_grad()
def ema(teacher: dict, student: dict, momentum: float) -> None:
    m = np.float32(momentum)
    for k in teacher:
        teacher[k].mul_(float(m)).add_(student[k], alpha=float(np.float32(1.0) - m))


def cosine(base: float, final: float, epochs: int, niter: int, warmup_epochs: int = 0):
    warm = np.linspace(0.0, base, warmup_epochs * niter) if warmup_epochs > 0 else np.array([])
    iters = np.arange(epochs * niter - warmup_epochs * niter)
    rest = final + 0.5 * (base - final) * (1 + np.cos(np.pi * iters / len(iters)))
    return np.concatenate((warm, rest)).astype(np.float32)


def teacher_temps(warmup: float, temp: float, warmup_epochs: int, epochs: int) -> np.ndarray:
    return np.concatenate([np.linspace(warmup, temp, warmup_epochs),
                           np.ones(max(epochs - warmup_epochs, 0)) * temp]).astype(np.float32)
