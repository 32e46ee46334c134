"""Projection heads: DINOHead with a weight-normalised prototype layer (port
of cerebra/models/heads.py; dino/vision_transformer.py:257-291).

Parameters are held under the reference names: `mlp.{0,2,4}.weight/bias`
(the Linear layers of the no-BN 3-layer MLP) and `last_layer.weight_v`
(out, in), `last_layer.weight_g` (out, 1), the layout of
`nn.utils.weight_norm(nn.Linear(..., bias=False))` and of the JAX package's
`.pth` export (cerebra/train/checkpoints.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from cerebra_torch.models._torch_interop import trunc_normal_init
from cerebra_torch.models.vit import dense


class WeightNormDense(nn.Module):
    """y = x @ (g · v / ||v||)ᵀ with each output row of v normalised; the gain
    g is fixed at 1 (not trained) when `norm_gain_fixed`, as the reference's
    weight_g.fill_(1) plus requires_grad False (:274-277)."""

    def __init__(self, in_features: int, features: int, norm_gain_fixed: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(features, in_features))
        self.weight_g = nn.Parameter(torch.ones(features, 1), requires_grad=not norm_gain_fixed)
        trunc_normal_init(self.weight_v, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = self.weight_v
        w = self.weight_g * v / (v.norm(dim=1, keepdim=True) + 1e-12)
        return x @ w.to(x.dtype).t()


class DINOHead(nn.Module):
    """nlayers-MLP (tanh-approximate GELU, flax `nn.gelu`'s default, where the
    reference uses exact GELU) → bottleneck → L2-normalise → WeightNormDense.

    `use_bn=True` raises: the JAX recipe builds the head with BatchNorm but
    applies it without its `batch_stats` collection, which fails in flax
    (ScopeCollectionNotFound), so the JAX package has no working BN head to
    match (ROADMAP queue 3)."""

    def __init__(self, in_dim: int, out_dim: int, use_bn: bool = False,
                 norm_last_layer: bool = True, nlayers: int = 3, hidden_dim: int = 2048,
                 bottleneck_dim: int = 256, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if use_bn:
            raise NotImplementedError(
                "use_bn_in_head: the JAX recipe fails on it (BatchNorm applied without "
                "batch_stats), so the port has no reference to match")
        self.dtype = dtype
        nlayers = max(nlayers, 1)
        dims = [in_dim] + [hidden_dim] * (nlayers - 1) + [bottleneck_dim]
        layers = []
        for i in range(nlayers):
            if i:
                layers.append(nn.GELU(approximate="tanh"))
            layers.append(nn.Linear(dims[i], dims[i + 1]))
        self.mlp = nn.Sequential(*layers)
        for lin in self.mlp:
            if isinstance(lin, nn.Linear):
                trunc_normal_init(lin.weight, 0.02, generator=generator)
                nn.init.zeros_(lin.bias)
        self.last_layer = WeightNormDense(bottleneck_dim, out_dim, norm_last_layer, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.mlp:
            x = dense(x, layer, self.dtype) if isinstance(layer, nn.Linear) else layer(x)
        x = x / (x.norm(dim=-1, keepdim=True) + 1e-12)
        return self.last_layer(x)


def params_from_jax(params) -> dict:
    """A flax DINOHead param tree (no BN) → this module's state dict (the
    mapping of cerebra/train/checkpoints.py::_head_to_torch)."""

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    dense_names = sorted((k for k in params if k.startswith("Dense_")),
                         key=lambda s: int(s.split("_")[1]))
    sd = {}
    for i, name in enumerate(dense_names):
        sd[f"mlp.{2 * i}.weight"] = t(np.asarray(params[name]["kernel"]).T)
        sd[f"mlp.{2 * i}.bias"] = t(params[name]["bias"])
    sd["last_layer.weight_v"] = t(np.asarray(params["last_layer"]["v"]).T)
    sd["last_layer.weight_g"] = t(np.asarray(params["last_layer"]["g"]).reshape(-1, 1))
    return sd
