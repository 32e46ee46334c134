"""XCiT, the Cross-Covariance Image Transformer backbones of the DINO hub
(port of cerebra/models/xcit.py; dino/hubconf.py:98-151 registers four
DINO-pretrained XCiTs and takes the architecture from the upstream
facebookresearch/xcit repo; El-Nouby et al., 2021, arXiv:2106.09681).

The modules carry the upstream state-dict names (`patch_embed.proj.{0,2,4,6}.
{0,1}`, `pos_embeder.token_projection`, `blocks.{i}.{norm1,attn,norm3,
local_mp,norm2,mlp,gamma1..3}`, `cls_attn_blocks.{i}`, `cls_token`, `norm`),
so `import_xcit_torch` checks keys rather than renaming them.

- ConvPatchEmbed: stride-2 [Conv3x3 (no bias) + BatchNorm] stages with GELU
  between: 4 stages for patch 16 (3→D/8→D/4→D/2→D), 3 for patch 8.
- Fourier positional encoding of the (y, x) grid (hidden 32 each,
  temperature 10000), projected to D by a 1×1 conv.
- XCABlocks: x += γ1·XCA(LN1 x); x += γ3·LPI(LN3 x); x += γ2·MLP(LN2 x).
  XCA attends over channels: per head q, k, v of shape (d_head, N), q and k
  L2-normalised along N, logits scaled by a learned per-head temperature.
  LPI is depthwise Conv3x3 → GELU → BatchNorm → depthwise Conv3x3 on the
  token grid.
- The CLS token joins after the XCA stack, then two class-attention blocks
  (only the CLS token queries). Upstream's final residual there is
  `x_res + cat([γ2·MLP(cls), x[:, 1:]])`, which doubles the patch tokens;
  the published weights were trained with it, so it is kept.
- A final LayerNorm; the backbone returns the CLS feature.

The JAX package computes all of this as plain XLA, so this is stock PyTorch
(cuDNN convolutions, torch matmuls). BatchNorm is flax's
(`models/batchnorm.py`): running statistics in eval, batch statistics in
training (`use_running_average=not train`), the biased variance folded into
the running one. Inputs are NHWC, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cerebra_torch.models._torch_interop import strip_torch_prefixes, trunc_normal_init
from cerebra_torch.models.batchnorm import BatchNorm2d

LN_EPS = 1e-6
_LECUN_STD_CORRECTION = 0.87962566103423978  # std of a unit normal truncated at ±2


def fourier_pos_encoding(gh: int, gw: int, hidden_dim: int = 32,
                         temperature: float = 10000.0) -> np.ndarray:
    """(gh·gw, 2·hidden_dim) sinusoidal grid encoding before the learned
    1×1 projection: upstream PositionalEncodingFourier's 1-based positions
    normalised to (0, 2π], sin/cos interleaved per axis, y before x."""
    eps, scale = 1e-6, 2 * math.pi
    y = (np.arange(1, gh + 1, dtype=np.float32) / (gh + eps) * scale)[:, None]
    x = (np.arange(1, gw + 1, dtype=np.float32) / (gw + eps) * scale)[None, :]
    y = np.broadcast_to(y, (gh, gw))
    x = np.broadcast_to(x, (gh, gw))
    dim_t = np.arange(hidden_dim, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / hidden_dim)
    pos_x = x[:, :, None] / dim_t  # (gh, gw, hidden)
    pos_y = y[:, :, None] / dim_t

    def interleave(p):
        return np.stack([np.sin(p[..., 0::2]), np.cos(p[..., 1::2])], axis=-1).reshape(
            gh, gw, -1)

    pos = np.concatenate([interleave(pos_y), interleave(pos_x)], axis=-1)
    return pos.reshape(gh * gw, 2 * hidden_dim)


def _bn(dim: int) -> BatchNorm2d:
    return BatchNorm2d(dim)


class ConvPatchEmbed(nn.Module):
    """Stride-2 conv tower: 4 stages for patch 16, 3 for patch 8."""

    def __init__(self, embed_dim: int, patch_size: int):
        super().__init__()
        D = embed_dim
        if patch_size == 16:
            widths = (D // 8, D // 4, D // 2, D)
        elif patch_size == 8:
            widths = (D // 4, D // 2, D)
        else:
            raise ValueError(f"XCiT supports patch 8/16, got {patch_size}")
        layers, c_in = [], 3
        for i, w in enumerate(widths):
            layers.append(nn.Sequential(nn.Conv2d(c_in, w, 3, 2, 1, bias=False), _bn(w)))
            if i < len(widths) - 1:
                layers.append(nn.GELU())
            c_in = w
        self.proj = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor):
        """x (B, 3, H, W) → tokens (B, gh·gw, D), gh, gw."""
        x = self.proj(x)
        gh, gw = x.shape[2], x.shape[3]
        return x.flatten(2).transpose(1, 2), gh, gw


class PositionalEncodingFourier(nn.Module):
    def __init__(self, dim: int, hidden_dim: int = 32):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.token_projection = nn.Conv2d(2 * hidden_dim, dim, 1)

    def forward(self, gh: int, gw: int) -> torch.Tensor:
        """(gh·gw, D): the grid encoding through the 1×1 projection."""
        w = self.token_projection.weight
        pos = torch.from_numpy(fourier_pos_encoding(gh, gw, self.hidden_dim)).to(w.device)
        return F.linear(pos, w[:, :, 0, 0], self.token_projection.bias)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))  # exact erf


class XCA(nn.Module):
    """Cross-covariance attention: (d_head × d_head) logits over the
    channel axis from L2-normalised q and k, times a learned per-head
    temperature."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        H = self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, H, D // H).permute(2, 0, 3, 4, 1)  # (3, B, H, d, N)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = F.normalize(q, dim=-1)
        k = F.normalize(k, dim=-1)
        attn = torch.softmax((q @ k.transpose(-2, -1)) * self.temperature, dim=-1)
        out = (attn @ v).permute(0, 3, 1, 2).reshape(B, N, D)
        return self.proj(out)


class LPI(nn.Module):
    """Local patch interaction: two depthwise 3×3 convs over the token grid
    with GELU and BatchNorm between."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)
        self.bn = _bn(dim)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
        B, N, D = x.shape
        h = x.transpose(1, 2).reshape(B, D, gh, gw)
        h = self.conv2(self.bn(F.gelu(self.conv1(h))))
        return h.reshape(B, D, N).transpose(1, 2)


def _drop_path(y: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    if rate == 0.0 or not training:
        return y
    keep = 1.0 - rate
    mask = torch.rand(y.shape[0], device=y.device) < keep
    return y * mask.reshape((-1,) + (1,) * (y.dim() - 1)) / keep


class XCABlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, eta: float = 1.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = XCA(dim, num_heads)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.local_mp = LPI(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.gamma1 = nn.Parameter(torch.full((dim,), eta))
        self.gamma2 = nn.Parameter(torch.full((dim,), eta))
        self.gamma3 = nn.Parameter(torch.full((dim,), eta))

    def forward(self, x: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
        dp, tr = self.drop_path, self.training
        x = x + _drop_path(self.gamma1 * self.attn(self.norm1(x)), dp, tr)
        x = x + _drop_path(self.gamma3 * self.local_mp(self.norm3(x), gh, gw), dp, tr)
        return x + _drop_path(self.gamma2 * self.mlp(self.norm2(x)), dp, tr)


class ClassAttention(nn.Module):
    """CaiT class attention: only the CLS token queries; the patch tokens
    pass through unchanged (the block adds its own residual)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        H, d = self.num_heads, D // self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, H, d).permute(2, 0, 3, 1, 4)  # (3, B, H, N, d)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.softmax((q[:, :, :1] * k).sum(-1) * d ** -0.5, dim=-1)  # (B, H, N)
        cls = (attn[:, :, None, :] @ v).transpose(1, 2).reshape(B, 1, D)
        return torch.cat([self.proj(cls), x[:, 1:]], dim=1)


class ClassAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, eta: float = 1.0,
                 tokens_norm: bool = True):
        super().__init__()
        self.tokens_norm = tokens_norm
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = ClassAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.gamma1 = nn.Parameter(torch.full((dim,), eta))
        self.gamma2 = nn.Parameter(torch.full((dim,), eta))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.gamma1 * self.attn(self.norm1(x))
        if self.tokens_norm:
            x = self.norm2(x)
        else:
            x = torch.cat([self.norm2(x[:, :1]), x[:, 1:]], dim=1)
        # upstream's residual re-adds the whole sequence: the patch tokens
        # double while only the CLS token takes the MLP
        cls = self.gamma2 * self.mlp(x[:, :1])
        return x + torch.cat([cls, x[:, 1:]], dim=1)


class XCiT(nn.Module):
    def __init__(self, patch_size: int = 16, embed_dim: int = 384, depth: int = 12,
                 num_heads: int = 8, mlp_ratio: float = 4.0, eta: float = 1.0,
                 tokens_norm: bool = True, cls_attn_layers: int = 2,
                 drop_path_rate: float = 0.0, pos_hidden_dim: int = 32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.patch_size, self.embed_dim, self.depth = patch_size, embed_dim, depth
        self.cls_attn_layers = cls_attn_layers
        self.patch_embed = ConvPatchEmbed(embed_dim, patch_size)
        self.pos_embeder = PositionalEncodingFourier(embed_dim, pos_hidden_dim)
        self.blocks = nn.ModuleList([
            XCABlock(embed_dim, num_heads, mlp_ratio, eta, drop_path_rate) for _ in range(depth)])
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.cls_attn_blocks = nn.ModuleList([
            ClassAttentionBlock(embed_dim, num_heads, mlp_ratio, eta, tokens_norm)
            for _ in range(cls_attn_layers)])
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self._init(generator)

    @torch.no_grad()
    def _init(self, generator) -> None:
        """The JAX package's initializers: trunc_normal(.02) for dense layers
        and the CLS token, lecun_normal for convolutions, zero biases."""
        trunc_normal_init(self.cls_token, 0.02, generator=generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                trunc_normal_init(m.weight, 0.02, generator=generator)
            elif isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / _LECUN_STD_CORRECTION
                trunc_normal_init(m.weight, std, -2 * std, 2 * std, generator=generator)
            else:
                continue
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        # the 1×1 projection is a flax Dense in the JAX package
        trunc_normal_init(self.pos_embeder.token_projection.weight, 0.02, generator=generator)

    def forward(self, x: torch.Tensor, return_all_tokens: bool = False) -> torch.Tensor:
        """x (B, H, W, 3) NHWC → the CLS feature (B, D), or all tokens."""
        B = x.shape[0]
        tokens, gh, gw = self.patch_embed(x.permute(0, 3, 1, 2))
        tokens = tokens + self.pos_embeder(gh, gw)[None]
        for blk in self.blocks:
            tokens = blk(tokens, gh, gw)
        tokens = torch.cat([self.cls_token.expand(B, 1, -1), tokens], dim=1)
        for blk in self.cls_attn_blocks:
            tokens = blk(tokens)
        tokens = self.norm(tokens)
        return tokens if return_all_tokens else tokens[:, 0]


def xcit_small_12_p16(**kw) -> XCiT:
    """dino_xcit_small_12_p16 backbone (dino/hubconf.py:98-110)."""
    return XCiT(patch_size=16, embed_dim=384, depth=12, num_heads=8, eta=1.0, **kw)


def xcit_small_12_p8(**kw) -> XCiT:
    """dino_xcit_small_12_p8 backbone (dino/hubconf.py:112-124)."""
    return XCiT(patch_size=8, embed_dim=384, depth=12, num_heads=8, eta=1.0, **kw)


def xcit_medium_24_p16(**kw) -> XCiT:
    """dino_xcit_medium_24_p16 backbone (dino/hubconf.py:126-138)."""
    return XCiT(patch_size=16, embed_dim=512, depth=24, num_heads=8, eta=1e-5, **kw)


def xcit_medium_24_p8(**kw) -> XCiT:
    """dino_xcit_medium_24_p8 backbone (dino/hubconf.py:140-151)."""
    return XCiT(patch_size=8, embed_dim=512, depth=24, num_heads=8, eta=1e-5, **kw)


XCIT_CONSTRUCTORS = {
    "xcit_small_12_p16": xcit_small_12_p16,
    "xcit_small_12_p8": xcit_small_12_p8,
    "xcit_medium_24_p16": xcit_medium_24_p16,
    "xcit_medium_24_p8": xcit_medium_24_p8,
}

_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def _xcit_keys(depth: int, patch_size: int, cls_attn_layers: int):
    """(parameter and running-stat keys, BatchNorm prefixes) of an XCiT."""
    keys, bns = ["cls_token", "norm.weight", "norm.bias", "pos_embeder.token_projection.weight",
                 "pos_embeder.token_projection.bias"], []
    for i in range(4 if patch_size == 16 else 3):
        keys.append(f"patch_embed.proj.{2 * i}.0.weight")
        bns.append(f"patch_embed.proj.{2 * i}.1")
    lin = ("weight", "bias")
    for i in range(depth):
        b = f"blocks.{i}."
        keys += [b + g for g in ("gamma1", "gamma2", "gamma3", "attn.temperature")]
        keys += [b + f"{m}.{p}" for m in ("norm1", "norm2", "norm3", "attn.qkv", "attn.proj",
                                          "local_mp.conv1", "local_mp.conv2", "mlp.fc1",
                                          "mlp.fc2") for p in lin]
        bns.append(b + "local_mp.bn")
    for i in range(cls_attn_layers):
        b = f"cls_attn_blocks.{i}."
        keys += [b + "gamma1", b + "gamma2"]
        keys += [b + f"{m}.{p}" for m in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1",
                                          "mlp.fc2") for p in lin]
    keys += [f"{bn}.{p}" for bn in bns for p in _BN_KEYS]
    return keys, bns


def import_xcit_torch(state_dict, depth: int = 12, patch_size: int = 16,
                      cls_attn_layers: int = 2) -> Dict[str, torch.Tensor]:
    """An upstream facebookresearch/xcit state dict → this module's state
    dict (the same names: the keys are checked, `module.`/`teacher.`/
    `backbone.` prefixes stripped, other keys ignored; BatchNorms'
    `num_batches_tracked` kept or set to 0). Raises KeyError for a missing
    key."""
    sd = strip_torch_prefixes(state_dict, dtype=None)
    keys, bns = _xcit_keys(depth, patch_size, cls_attn_layers)
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"XCiT state dict lacks {missing[:4]} ({len(missing)} keys)")
    out = {k: torch.as_tensor(np.asarray(sd[k], dtype=np.float32)) for k in keys}
    for bn in bns:
        n = sd.get(bn + ".num_batches_tracked", 0)
        out[bn + ".num_batches_tracked"] = torch.as_tensor(np.asarray(n, dtype=np.int64))
    return out


def params_from_jax(variables, depth: int, patch_size: int = 16,
                    cls_attn_layers: int = 2) -> Dict[str, torch.Tensor]:
    """A flax XCiT `{"params", "batch_stats"}` tree (numpy or jax arrays) →
    this module's state dict (the inverse of
    `cerebra.models.xcit.import_xcit_torch`)."""
    p, s = variables["params"], variables["batch_stats"]

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def dense(d):
        return {"weight": t(np.asarray(d["kernel"]).T), "bias": t(d["bias"])}

    def ln(d):
        return {"weight": t(d["scale"]), "bias": t(d["bias"])}

    def bn(pd, sd_):
        return {"weight": t(pd["scale"]), "bias": t(pd["bias"]), "running_mean": t(sd_["mean"]),
                "running_var": t(sd_["var"]),
                "num_batches_tracked": torch.tensor(0, dtype=torch.int64)}

    def conv(d):  # HWIO → OIHW
        return t(np.transpose(np.asarray(d["kernel"]), (3, 2, 0, 1)))

    out: Dict[str, torch.Tensor] = {"cls_token": t(p["cls_token"])}

    def put(prefix, d):
        out.update({f"{prefix}.{k}": v for k, v in d.items()})

    for i in range(4 if patch_size == 16 else 3):
        out[f"patch_embed.proj.{2 * i}.0.weight"] = conv(p["patch_embed"][f"conv_{i}"])
        put(f"patch_embed.proj.{2 * i}.1",
            bn(p["patch_embed"][f"bn_{i}"], s["patch_embed"][f"bn_{i}"]))
    tp = p["token_projection"]
    out["pos_embeder.token_projection.weight"] = t(np.asarray(tp["kernel"]).T[:, :, None, None])
    out["pos_embeder.token_projection.bias"] = t(tp["bias"])
    for i in range(depth):
        bp, b = p[f"block_{i}"], f"blocks.{i}"
        for g in ("gamma1", "gamma2", "gamma3"):
            out[f"{b}.{g}"] = t(bp[g])
        out[f"{b}.attn.temperature"] = t(bp["attn"]["temperature"])
        for n in ("norm1", "norm2", "norm3"):
            put(f"{b}.{n}", ln(bp[n]))
        put(f"{b}.attn.qkv", dense(bp["attn"]["qkv"]))
        put(f"{b}.attn.proj", dense(bp["attn"]["proj"]))
        for c in ("conv1", "conv2"):
            put(f"{b}.local_mp.{c}", {"weight": conv(bp["local_mp"][c]),
                                      "bias": t(bp["local_mp"][c]["bias"])})
        put(f"{b}.local_mp.bn", bn(bp["local_mp"]["bn"], s[f"block_{i}"]["local_mp"]["bn"]))
        put(f"{b}.mlp.fc1", dense(bp["mlp_fc1"]))
        put(f"{b}.mlp.fc2", dense(bp["mlp_fc2"]))
    for i in range(cls_attn_layers):
        bp, b = p[f"cls_block_{i}"], f"cls_attn_blocks.{i}"
        out[f"{b}.gamma1"], out[f"{b}.gamma2"] = t(bp["gamma1"]), t(bp["gamma2"])
        put(f"{b}.norm1", ln(bp["norm1"]))
        put(f"{b}.norm2", ln(bp["norm2"]))
        put(f"{b}.attn.qkv", dense(bp["attn"]["qkv"]))
        put(f"{b}.attn.proj", dense(bp["attn"]["proj"]))
        put(f"{b}.mlp.fc1", dense(bp["mlp_fc1"]))
        put(f"{b}.mlp.fc2", dense(bp["mlp_fc2"]))
    put("norm", ln(p["norm"]))
    return out
