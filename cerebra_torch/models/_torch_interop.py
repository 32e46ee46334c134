"""Initializer and checkpoint-key helpers shared by the ViT modules (port of
cerebra/models/_torch_interop.py)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

DEFAULT_STRIP_PREFIXES: Tuple[str, ...] = ("module.", "teacher.", "backbone.")


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
