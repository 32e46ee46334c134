"""EEG Conformer (port of cerebra/models/conformer.py; utils/Conformer.py:
68-219): a convolutional patch embedding over (B, 1, C, T) EEG, a
transformer encoder and a flatten head that returns (flat_tokens, features).

- PatchEmbedding: the temporal Conv(1→40, (1,25)) and the spatial
  Conv(40→40, (C,1)), BatchNorm, ELU, AvgPool (1,75)/(1,15), Dropout, a 1×1
  Conv to emb_size, tokens (B, N, E); N = 61 at (22, 1000). `fused` (the
  default, as in JAX) composes the two linear convolutions into one (C, 25)
  kernel, W[o,c,k] = Σ_m w1[m,k]·w2[o,m,c], and the biases likewise,
  computed in f32 and cast to the compute dtype.
- TransformerEncoderBlock: pre-LN (eps 1e-5) attention with separate
  queries/keys/values/projection layers, the logits scaled by √emb_size (the
  reference's, :115; not √head_dim), the softmax in f32; a pre-LN MLP ×4
  with the erf GELU; Dropout 0.5 in four places.
- Conformer: flatten → 1024 → ELU → Dropout 0.5 → 512 → ELU → Dropout 0.3
  → out_features.

`dtype` (bf16 or None) is flax's compute dtype: products and convolutions
run in it, parameters and BatchNorm statistics stay f32, LayerNorm and
BatchNorm normalise in f32, the softmax runs in f32. Dropout is flax's
(`models/dropout.py`): in training `forward(x, drop)` takes `drop(x, rate)`,
which `dropout_from(generator)` draws from a torch.Generator and a test can
feed masks through; in eval mode there is none. Plain XLA in the JAX
package, so stock PyTorch here.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cerebra_torch.models._torch_interop import (
    conv_from_flax,
    dense_from_flax,
    flax_default_init,
    norm_from_flax,
)
from cerebra_torch.models.batchnorm import BatchNorm2d
from cerebra_torch.models.dropout import Drop, active

LN_EPS = 1e-5


def _dense(lin: nn.Linear, x: torch.Tensor, dt: Optional[torch.dtype]) -> torch.Tensor:
    """flax's Dense at compute dtype `dt`: input, kernel and bias cast to it."""
    if dt is None:
        return lin(x)
    bias = None if lin.bias is None else lin.bias.to(dt)
    return F.linear(x.to(dt), lin.weight.to(dt), bias)


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dt: Optional[torch.dtype]) -> torch.Tensor:
    """flax's LayerNorm at compute dtype `dt`: statistics in f32 (or the
    input's wider dtype), output in dt."""
    xf = x.float() if x.dtype in (torch.float16, torch.bfloat16) else x
    y = F.layer_norm(xf, ln.normalized_shape, ln.weight, ln.bias, ln.eps)
    return y.to(dt or x.dtype)


class PatchEmbedding(nn.Module):
    def __init__(self, n_channels: int, emb_size: int = 40, pool_size: int = 75,
                 pool_stride: int = 15, dtype: Optional[torch.dtype] = None,
                 fused: bool = True):
        super().__init__()
        self.conv_0 = nn.Conv2d(1, 40, (1, 25))  # temporal
        self.conv_1 = nn.Conv2d(40, 40, (n_channels, 1))  # spatial
        self.bn = BatchNorm2d(40)
        self.projection = nn.Conv2d(40, emb_size, 1)
        self.pool = (pool_size, pool_stride)
        self.dtype, self.fused = dtype, fused

    def fused_kernel(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (C, 25) kernel (40, 1, C, 25) and bias of the two convolutions
        composed, in f32."""
        w1 = self.conv_0.weight[:, 0, 0, :]  # (m, k)
        w2 = self.conv_1.weight[..., 0]  # (o, m, c)
        w = torch.einsum("mk,omc->ock", w1, w2).unsqueeze(1)
        b = torch.einsum("m,omc->o", self.conv_0.bias, w2) + self.conv_1.bias
        return w, b

    def forward(self, x: torch.Tensor, drop: Optional[Drop] = None) -> torch.Tensor:
        """x (B, 1, C, T) → tokens (B, N, E)."""
        dt = self.dtype or x.dtype
        if self.fused:
            w, b = self.fused_kernel()
            x = F.conv2d(x.to(dt), w.to(dt)) + b.to(dt)[:, None, None]
        else:
            for conv in (self.conv_0, self.conv_1):
                x = F.conv2d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt))
        x = F.elu(self.bn(x))
        x = F.avg_pool2d(x, (1, self.pool[0]), (1, self.pool[1]))
        x = active(drop, self.training)(x.permute(0, 2, 3, 1), 0.5)  # NHWC, flax's layout
        w = self.projection.weight[:, :, 0, 0]  # the 1×1 convolution as a product
        x = F.linear(x.to(dt), w.to(dt), self.projection.bias.to(dt))
        return x.reshape(x.shape[0], -1, x.shape[-1])  # (B, 1, N, E) → (B, N, E)


class TransformerEncoderBlock(nn.Module):
    def __init__(self, emb_size: int, num_heads: int = 10, drop_p: float = 0.5,
                 forward_expansion: int = 4, forward_drop_p: float = 0.5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        E = emb_size
        self.ln_0 = nn.LayerNorm(E, eps=LN_EPS)
        self.queries, self.keys, self.values = nn.Linear(E, E), nn.Linear(E, E), nn.Linear(E, E)
        self.projection = nn.Linear(E, E)
        self.ln_1 = nn.LayerNorm(E, eps=LN_EPS)
        self.fc_0 = nn.Linear(E, forward_expansion * E)
        self.fc_1 = nn.Linear(forward_expansion * E, E)
        self.num_heads, self.drop_p, self.forward_drop_p = num_heads, drop_p, forward_drop_p
        self.dtype = dtype

    def forward(self, x: torch.Tensor, drop: Optional[Drop] = None) -> torch.Tensor:
        dt, E, nh = self.dtype, self.ln_0.normalized_shape[0], self.num_heads
        drop = active(drop, self.training)
        B, N, _ = x.shape
        h = _layer_norm(self.ln_0, x, dt)
        q, k, v = (_dense(lin, h, dt).reshape(B, N, nh, E // nh)
                   for lin in (self.queries, self.keys, self.values))
        energy = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        att = torch.softmax(energy / math.sqrt(E), dim=-1).to(q.dtype)
        att = drop(att, self.drop_p)
        h = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, N, E)
        h = _dense(self.projection, h, dt)
        x = x + drop(h, self.drop_p)
        h = _layer_norm(self.ln_1, x, dt)
        h = F.gelu(_dense(self.fc_0, h, dt))  # the reference's erf GELU (:146-148)
        h = drop(h, self.forward_drop_p)
        h = _dense(self.fc_1, h, dt)
        return x + drop(h, self.drop_p)


def n_tokens(n_samples: int, pool_size: int = 75, pool_stride: int = 15) -> int:
    """Tokens of a T-sample trial: (T − 24 − pool) // stride + 1."""
    return (n_samples - 24 - pool_size) // pool_stride + 1


class Conformer(nn.Module):
    """forward(x (B, 1, C, T), drop) → (flat_tokens, features), the
    reference head's contract (utils/Conformer.py:207-211). Unlike flax the
    head's width is fixed at construction, so it takes C and T."""

    def __init__(self, n_channels: int = 22, n_samples: int = 1000, emb_size: int = 40,
                 depth: int = 6, out_features: int = 384, pool_size: int = 75,
                 pool_stride: int = 15, dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.patch_embedding = PatchEmbedding(n_channels, emb_size, pool_size, pool_stride,
                                              dtype)
        self.blocks = nn.ModuleList(TransformerEncoderBlock(emb_size, dtype=dtype)
                                    for _ in range(depth))
        flat = n_tokens(n_samples, pool_size, pool_stride) * emb_size
        self.fc_0, self.fc_1 = nn.Linear(flat, 1024), nn.Linear(1024, 512)
        self.fc_2 = nn.Linear(512, out_features)
        self.dtype = dtype
        flax_default_init(self, generator)

    def forward(self, x: torch.Tensor, drop: Optional[Drop] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        tokens = self.patch_embedding(x, drop)
        for block in self.blocks:
            tokens = block(tokens, drop)
        flat = tokens.reshape(tokens.shape[0], -1)
        drop = active(drop, self.training)
        h = drop(F.elu(_dense(self.fc_0, flat, self.dtype)), 0.5)
        h = drop(F.elu(_dense(self.fc_1, h, self.dtype)), 0.3)
        return flat, _dense(self.fc_2, h, self.dtype)


def patch_embedding_from_jax(params, stats, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A flax PatchEmbedding's params and batch_stats → its keys here."""
    out: Dict[str, torch.Tensor] = {}
    for name, key in (("conv_0", "Conv_0"), ("conv_1", "Conv_1"), ("projection", "Conv_2")):
        out.update(conv_from_flax(f"{prefix}{name}", params[key]))
    out.update(norm_from_flax(f"{prefix}bn", params["BatchNorm_0"], stats["BatchNorm_0"]))
    return out


def params_from_jax(variables, depth: int = 6) -> Dict[str, torch.Tensor]:
    """A flax Conformer `{"params", "batch_stats"}` tree → this module's
    state dict (the fused path's Conv_0/Conv_1 are the same parameters as
    the unfused pair's)."""
    p, s = variables["params"], variables["batch_stats"]
    out = patch_embedding_from_jax(p["PatchEmbedding_0"], s["PatchEmbedding_0"],
                                   "patch_embedding.")
    for d in range(depth):
        bp, pre = p[f"TransformerEncoderBlock_{d}"], f"blocks.{d}"
        out.update(norm_from_flax(f"{pre}.ln_0", bp["LayerNorm_0"]))
        out.update(norm_from_flax(f"{pre}.ln_1", bp["LayerNorm_1"]))
        for name in ("queries", "keys", "values", "projection"):
            out.update(dense_from_flax(f"{pre}.{name}", bp[name]))
        out.update(dense_from_flax(f"{pre}.fc_0", bp["Dense_0"]))
        out.update(dense_from_flax(f"{pre}.fc_1", bp["Dense_1"]))
    for i in range(3):
        out.update(dense_from_flax(f"fc_{i}", p[f"Dense_{i}"]))
    return out
