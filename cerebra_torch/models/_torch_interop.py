"""Initializer and checkpoint-key helpers shared by the ViT modules (port of
cerebra/models/_torch_interop.py), and flax's default initialisers."""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

DEFAULT_STRIP_PREFIXES: Tuple[str, ...] = ("module.", "teacher.", "backbone.")
LECUN_STD_CORRECTION = 0.87962566103423978  # std of a unit normal truncated at ±2


def trunc_normal_init(tensor: torch.Tensor, std: float, a: float = -2.0, b: float = 2.0,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The reference's ``trunc_normal_`` (dino/utils.py:548-550), in place:
    ``a``/``b`` are ABSOLUTE truncation bounds, not multiples of σ — at
    std=.02 the default ±2 window is ±100σ, an effectively untruncated
    normal with std 0.02. Draws on the CPU from `generator`, then copies
    into `tensor` wherever it lives."""
    w = torch.empty(tensor.shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, mean=0.0, std=std, a=a, b=b, generator=generator)
    with torch.no_grad():
        tensor.copy_(w)
    return tensor


def strip_torch_prefixes(
    state_dict: Dict,
    prefixes: Sequence[str] = DEFAULT_STRIP_PREFIXES,
    dtype=np.float32,
) -> Dict[str, np.ndarray]:
    """{key: tensor} → {stripped key: np array}; each key loses every listed
    prefix it starts with (checked in order, once each, like the reference's
    sequential ``k.startswith`` loops)."""
    out = {}
    for k, v in state_dict.items():
        for pref in prefixes:
            if k.startswith(pref):
                k = k[len(pref):]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v, dtype=dtype) if dtype is not None else v
    return out


@torch.no_grad()
def flax_default_init(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """flax's default initialisers on every Conv2d and Linear in `module`:
    lecun_normal kernels (variance 1/fan_in, truncated at ±2σ) and zero
    biases. Norm layers keep torch's unit gains and zero biases, as flax's."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = math.sqrt(1.0 / m.weight[0].numel()) / LECUN_STD_CORRECTION
            trunc_normal_init(m.weight, std, -2 * std, 2 * std, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def conv_from_flax(prefix: str, d) -> Dict[str, torch.Tensor]:
    """A flax Conv's params (HWIO kernel, optional bias) → `prefix.weight`
    (OIHW) and `prefix.bias`."""
    out = {f"{prefix}.weight": _f32(np.transpose(np.asarray(d["kernel"]), (3, 2, 0, 1)))}
    if "bias" in d:
        out[f"{prefix}.bias"] = _f32(d["bias"])
    return out


def dense_from_flax(prefix: str, d) -> Dict[str, torch.Tensor]:
    """A flax Dense's params → `prefix.weight` (out, in) and `prefix.bias`."""
    out = {f"{prefix}.weight": _f32(np.asarray(d["kernel"]).T)}
    if "bias" in d:
        out[f"{prefix}.bias"] = _f32(d["bias"])
    return out


def norm_from_flax(prefix: str, d, stats=None) -> Dict[str, torch.Tensor]:
    """A flax LayerNorm's or BatchNorm's params (and a BatchNorm's
    `batch_stats` entry) → torch's keys under `prefix`."""
    out = {f"{prefix}.weight": _f32(d["scale"]), f"{prefix}.bias": _f32(d["bias"])}
    if stats is not None:
        out.update({f"{prefix}.running_mean": _f32(stats["mean"]),
                    f"{prefix}.running_var": _f32(stats["var"]),
                    f"{prefix}.num_batches_tracked": torch.tensor(0, dtype=torch.int64)})
    return out
