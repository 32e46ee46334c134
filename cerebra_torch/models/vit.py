"""DINO Vision Transformer (port of cerebra/models/vit.py;
dino/vision_transformer.py:134-254).

timm-style ViT with the DINO extras: attention maps of the last block,
normalised outputs of the last n blocks, bicubic positional-embedding
interpolation for off-grid input sizes, per-block stochastic depth,
LayerScale (DINOv2 blocks), and the vit_tiny/small/base and DINOv2
ViT-S/14 constructors.

Parameters are held under the reference timm names (`patch_embed.proj.*`,
`cls_token`, `pos_embed`, `blocks.{i}.norm1.*`, `blocks.{i}.attn.qkv.*`,
`blocks.{i}.attn.proj.*`, `blocks.{i}.mlp.fc1.*`, `blocks.{i}.ls1.gamma`,
`norm.*`); `params_from_jax` maps the JAX package's flax tree onto them,
and `import_vit_torch` / `import_dinov2_vit_torch` check torch-layout
checkpoints (DINO v1, torch.hub dinov2_vits14) against them.

Numerics follow flax's `dtype=` semantics: with a compute dtype each dense
layer casts its input, weight and bias to it, LayerNorm computes in f32
(eps 1e-6) and returns the compute dtype, while the token stream that
`tokens + pos` starts stays f32. Inputs are NHWC, as in the JAX package.

Each block's two halves take the fused kernels (models/vit_attn.py,
models/vit_mlp.py) when `use_fused_attn` / `use_fused_mlp` are on; None
("auto") turns them on for CUDA tensors. With the flags off a block runs the
JAX package's own unfused path (its XLA formulas), not a fallback.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from cerebra_torch.models._torch_interop import strip_torch_prefixes, trunc_normal_init
from cerebra_torch.models.vit_attn import flash_mha, fused_attn_residual
from cerebra_torch.models.vit_mlp import LN_EPS, fused_mlp_residual

_LECUN_STD_CORRECTION = 0.87962566103423978  # std of a unit normal truncated at ±2


def _compute_dtype(x: torch.Tensor, w: torch.Tensor, dtype: Optional[torch.dtype]):
    return dtype or torch.promote_types(x.dtype, w.dtype)


def dense(x: torch.Tensor, lin: nn.Linear, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax `nn.Dense(dtype=...)`: input, weight and bias in the compute
    dtype (default: the promotion of input and weight)."""
    cdt = _compute_dtype(x, lin.weight, dtype)
    bias = None if lin.bias is None else lin.bias.to(cdt)
    return F.linear(x.to(cdt), lin.weight.to(cdt), bias)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax `nn.LayerNorm(dtype=...)`: statistics and affine in f32 with eps
    1e-6, the result in the compute dtype."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(),
                     eps=LN_EPS)
    return y.to(_compute_dtype(x, norm.weight, dtype))


def _init_linear(lin: nn.Linear, generator) -> None:
    trunc_normal_init(lin.weight, 0.02, generator=generator)
    if lin.bias is not None:
        nn.init.zeros_(lin.bias)


def _fused_on(flag: Optional[bool], x: torch.Tensor) -> bool:
    return x.is_cuda if flag is None else flag


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int = 6, qkv_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, use_flash: bool = False,
                 flash_min_seq: int = 512):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.use_flash, self.flash_min_seq = use_flash, flash_min_seq
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, need_weights: bool = True):
        """(out, attn) like the reference Attention (:68-92); attn is None on
        the flash path (`use_flash`, N ≥ flash_min_seq, no map asked for):
        K15, `vit_attn.flash_mha`, on K5/K6's attention cores."""
        B, N, D = x.shape
        H = self.num_heads
        qkv = dense(x, self.qkv, self.dtype).reshape(B, N, 3, H, D // H)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each (B, H, N, dh)
        scale = (D // H) ** -0.5
        if self.use_flash and not need_weights and N >= self.flash_min_seq:
            out, attn = flash_mha(q, k, v, scale), None
        else:
            attn = torch.softmax((q * scale) @ k.transpose(-2, -1), dim=-1)
            out = attn @ v
        out = out.transpose(1, 2).reshape(B, N, D)
        return dense(out, self.proj, self.dtype), attn


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 layer_scale: bool = False, layer_scale_init: float = 1e-5,
                 dtype: Optional[torch.dtype] = None, use_flash: bool = False,
                 use_fused_mlp: Optional[bool] = None, use_fused_attn: Optional[bool] = None,
                 fused_attn_pad: int = 16, fused_mlp_tile_m: int = 256, fused_min_seq: int = 0):
        super().__init__()
        self.dim, self.num_heads, self.drop_path, self.dtype = dim, num_heads, drop_path, dtype
        self.use_fused_mlp, self.use_fused_attn = use_fused_mlp, use_fused_attn
        self.fused_attn_pad, self.fused_mlp_tile_m = fused_attn_pad, fused_mlp_tile_m
        self.fused_min_seq = fused_min_seq
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads, dtype=dtype, use_flash=use_flash)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.layer_scale = layer_scale
        if layer_scale:
            self.ls1 = LayerScale(dim, layer_scale_init)
            self.ls2 = LayerScale(dim, layer_scale_init)

    def forward(self, x: torch.Tensor, return_attention: bool = False):
        B, N, D = x.shape
        seq_gate = N >= self.fused_min_seq
        if _fused_on(self.use_fused_attn, x) and seq_gate and not return_attention:
            wproj, bproj = self.attn.proj.weight.t(), self.attn.proj.bias
            if self.layer_scale:
                # fold the residual-branch gamma into proj (the kernel adds
                # the residual): proj(o)·ls1 = o @ (Wp·ls1) + bp·ls1
                wproj = wproj * self.ls1.gamma[None, :]
                bproj = bproj * self.ls1.gamma
            x = fused_attn_residual(
                x, self.norm1.weight, self.norm1.bias, self.attn.qkv.weight.t(),
                self.attn.qkv.bias, wproj, bproj, self.num_heads, self.fused_attn_pad,
                self.dtype, self._drop_path_scale(B, x.device),
            )
        else:
            y, attn = self.attn(layer_norm(x, self.norm1, self.dtype),
                                need_weights=return_attention)
            if return_attention:
                return attn
            if self.layer_scale:
                y = y * self.ls1.gamma
            x = x + self._drop_path(y)
        if _fused_on(self.use_fused_mlp, x) and seq_gate:
            w2, b2 = self.mlp.fc2.weight.t(), self.mlp.fc2.bias
            if self.layer_scale:
                w2 = w2 * self.ls2.gamma[None, :]
                b2 = b2 * self.ls2.gamma
            scale = self._drop_path_scale(B, x.device)
            if scale is not None:
                scale = scale.repeat_interleave(N)  # per row, b-major like the reshape
            return fused_mlp_residual(
                x.reshape(B * N, D), self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight.t(),
                self.mlp.fc1.bias, w2, b2, self.fused_mlp_tile_m, self.dtype, scale,
            ).reshape(B, N, D)
        h = dense(layer_norm(x, self.norm2, self.dtype), self.mlp.fc1, self.dtype)
        h = dense(F.gelu(h), self.mlp.fc2, self.dtype)  # exact erf, torch nn.GELU's default
        if self.layer_scale:
            h = h * self.ls2.gamma
        return x + self._drop_path(h)

    def _mask(self, batch: int, device):
        keep = 1.0 - self.drop_path
        return torch.rand(batch, device=device) < keep, keep

    def _drop_path(self, y: torch.Tensor) -> torch.Tensor:
        if self.drop_path == 0.0 or not self.training:
            return y
        mask, keep = self._mask(y.shape[0], y.device)
        return y * mask.reshape(-1, 1, 1) / keep

    def _drop_path_scale(self, batch: int, device) -> Optional[torch.Tensor]:
        """The per-sample mask/keep factor of `_drop_path` as a (B,) f32
        vector for the fused kernels' branch scale; the same draw."""
        if self.drop_path == 0.0 or not self.training:
            return None
        mask, keep = self._mask(batch, device)
        return mask.float() / keep


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)


class VisionTransformer(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 16, embed_dim: int = 384,
                 depth: int = 12, num_heads: int = 6, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.0, layer_scale: bool = False,
                 dtype: Optional[torch.dtype] = None, use_flash: bool = False,
                 use_fused_mlp: Optional[bool] = None, use_fused_attn: Optional[bool] = None,
                 fused_attn_pad: int = 16, fused_mlp_tile_m: int = 256, fused_min_seq: int = 0,
                 remat: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.img_size, self.patch_size, self.embed_dim = img_size, patch_size, embed_dim
        self.depth, self.num_heads, self.dtype, self.remat = depth, num_heads, dtype, remat
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        n_patches = (img_size // patch_size) ** 2
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_patches + 1, embed_dim))
        dpr = np.linspace(0, drop_path_rate, depth)
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, mlp_ratio, float(dpr[i]), layer_scale=layer_scale,
                  dtype=dtype, use_flash=use_flash, use_fused_mlp=use_fused_mlp,
                  use_fused_attn=use_fused_attn, fused_attn_pad=fused_attn_pad,
                  fused_mlp_tile_m=fused_mlp_tile_m, fused_min_seq=fused_min_seq)
            for i in range(depth)
        ])
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self._init(generator)

    @torch.no_grad()
    def _init(self, generator) -> None:
        """The JAX package's initializers: trunc_normal(.02) for dense
        layers, cls and pos; lecun_normal for the patch conv; zero biases;
        unit LayerNorm gains."""
        w = self.patch_embed.proj.weight
        std = math.sqrt(1.0 / (w.shape[1] * w.shape[2] * w.shape[3])) / _LECUN_STD_CORRECTION
        trunc_normal_init(w, std, -2 * std, 2 * std, generator=generator)
        nn.init.zeros_(self.patch_embed.proj.bias)
        trunc_normal_init(self.cls_token, 0.02, generator=generator)
        trunc_normal_init(self.pos_embed, 0.02, generator=generator)
        for blk in self.blocks:
            for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
                _init_linear(lin, generator)

    def forward(self, x: torch.Tensor, return_all_tokens: bool = False,
                return_attention_of_last_block: bool = False, n_intermediate: int = 0):
        """x (B, H, W, 3) NHWC → the CLS feature (B, D) by default."""
        conv = self.patch_embed.proj
        cdt = _compute_dtype(x, conv.weight, self.dtype)
        # unpadded, floor-truncating like torch Conv2d (flax VALID)
        patches = F.conv2d(x.permute(0, 3, 1, 2).to(cdt), conv.weight.to(cdt), conv.bias.to(cdt),
                           stride=self.patch_size)
        B, D, gh, gw = patches.shape
        tokens = patches.flatten(2).transpose(1, 2)
        stream = torch.promote_types(tokens.dtype, self.cls_token.dtype)
        tokens = torch.cat([self.cls_token.expand(B, 1, D).to(stream), tokens.to(stream)], 1)
        tokens = tokens + _interpolate_pos_embed(self.pos_embed, gh, gw)

        intermediates: List[torch.Tensor] = []
        for i, blk in enumerate(self.blocks):
            if return_attention_of_last_block and i == self.depth - 1:
                return blk(tokens, return_attention=True)
            if self.remat and torch.is_grad_enabled():
                tokens = checkpoint(blk, tokens, use_reentrant=False)
            else:
                tokens = blk(tokens)
            if n_intermediate and self.depth - n_intermediate <= i < self.depth - 1:
                # the reference norms every returned layer (:232)
                intermediates.append(layer_norm(tokens, self.norm, self.dtype))
        tokens = layer_norm(tokens, self.norm, self.dtype)
        if n_intermediate:
            return intermediates + [tokens]
        if return_all_tokens:
            return tokens
        return tokens[:, 0]  # CLS feature (the reference forward, :211-214)


def _interpolate_pos_embed(pos_embed: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """Bicubic pos-embed interpolation (dino/vision_transformer.py:174-194)
    as `jax.image.resize(..., "bicubic")`, whose antialias defaults to True:
    torch's bicubic without antialias differs by up to 2.1 at a 28→12 grid,
    with it by under 1e-6."""
    n = pos_embed.shape[1] - 1
    if gh * gw == n and gh == gw:
        # the reference short-circuits only for npatch == N AND w == h
        return pos_embed
    cls_pos, patch_pos = pos_embed[:, :1], pos_embed[:, 1:]
    g0 = int(math.sqrt(n))
    grid = patch_pos.reshape(1, g0, g0, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", align_corners=False,
                         antialias=True)
    return torch.cat([cls_pos, grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], 1)


def vit_tiny(patch_size: int = 16, **kw) -> VisionTransformer:
    return VisionTransformer(patch_size=patch_size, embed_dim=192, depth=12, num_heads=3, **kw)


def vit_small(patch_size: int = 16, **kw) -> VisionTransformer:
    return VisionTransformer(patch_size=patch_size, embed_dim=384, depth=12, num_heads=6, **kw)


def vit_base(patch_size: int = 16, **kw) -> VisionTransformer:
    return VisionTransformer(patch_size=patch_size, embed_dim=768, depth=12, num_heads=12, **kw)


def vit_small_dinov2(img_size: int = 518, **kw) -> VisionTransformer:
    """DINOv2 ViT-S/14, the reference's frozen teacher
    (LstmDistillFromDinoV2Train.py:144-146: torch.hub dinov2_vits14): patch
    14, LayerScale blocks, a 37×37 pos grid at the 518-px training size;
    other input sizes (224 px: 16×16) interpolate it as upstream does."""
    return VisionTransformer(img_size=img_size, patch_size=14, embed_dim=384, depth=12,
                             num_heads=6, layer_scale=True, **kw)


_BLOCK_KEYS = ("norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
               "attn.proj.weight", "attn.proj.bias", "norm2.weight", "norm2.bias",
               "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")


def import_vit_torch(state_dict, depth: int = 12, layer_scale: bool = False) -> dict:
    """A timm-layout torch ViT state dict → this module's state dict (the
    port keeps the timm names, so this selects and checks keys). One importer
    for both reference teacher families: DINO v1
    (dino/vision_transformer.py:134-254) and, with `layer_scale`, the
    torch.hub dinov2_vits14 layout, which adds `blocks.{i}.ls{1,2}.gamma`
    and an inference-unused `mask_token` (skipped). `module.`, `teacher.`
    and `backbone.` prefixes are stripped (utils/DinoModel.py:60-78); keys
    the model does not have are ignored. Raises KeyError for a missing key
    and ValueError where the gammas are present without `layer_scale`."""
    sd = strip_torch_prefixes(state_dict)
    has_gamma = any(k.endswith(("ls1.gamma", "ls2.gamma")) for k in sd)
    if has_gamma and not layer_scale:
        raise ValueError("LayerScale gammas (ls1/ls2.gamma) in a state dict imported "
                         "without layer_scale: a DINOv2 checkpoint needs "
                         "import_dinov2_vit_torch")
    keys = ["cls_token", "pos_embed", "patch_embed.proj.weight", "patch_embed.proj.bias",
            "norm.weight", "norm.bias"]
    block_keys = _BLOCK_KEYS + (("ls1.gamma", "ls2.gamma") if layer_scale else ())
    keys += [f"blocks.{i}.{k}" for i in range(depth) for k in block_keys]
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"ViT state dict lacks {missing[:4]} ({len(missing)} keys)")
    return {k: torch.from_numpy(sd[k]) for k in keys}


def import_dino_vit_torch(state_dict, depth: int = 12) -> dict:
    """The DINO v1 layout (no LayerScale); see import_vit_torch."""
    return import_vit_torch(state_dict, depth=depth, layer_scale=False)


def import_dinov2_vit_torch(state_dict, depth: int = 12) -> dict:
    """The DINOv2 torch.hub layout (LayerScale); see import_vit_torch."""
    return import_vit_torch(state_dict, depth=depth, layer_scale=True)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def block_params_from_jax(blk, layer_scale: bool = False) -> dict:
    """One flax Block's params → a `Block` state dict (timm names)."""
    sd = {}
    for name in ("norm1", "norm2"):
        sd[name + ".weight"] = _t(blk[name]["scale"])
        sd[name + ".bias"] = _t(blk[name]["bias"])
    dense_names = {"attn.qkv": blk["attn"]["qkv"], "attn.proj": blk["attn"]["proj"],
                   "mlp.fc1": blk["mlp_fc1"], "mlp.fc2": blk["mlp_fc2"]}
    for name, p in dense_names.items():
        sd[name + ".weight"] = _t(np.asarray(p["kernel"]).T)
        sd[name + ".bias"] = _t(p["bias"])
    if layer_scale:
        sd["ls1.gamma"] = _t(blk["ls1_gamma"])
        sd["ls2.gamma"] = _t(blk["ls2_gamma"])
    return sd


def params_from_jax(params, depth: int, layer_scale: bool = False) -> dict:
    """A flax VisionTransformer param tree (numpy or jax arrays) → this
    module's state dict under the reference timm names (the inverse of
    `cerebra.models.vit.import_vit_torch`)."""
    t = _t
    sd = {
        "cls_token": t(params["cls_token"]),
        "pos_embed": t(params["pos_embed"]),
        # HWIO → (out, in, h, w)
        "patch_embed.proj.weight": t(np.transpose(np.asarray(params["patch_embed"]["kernel"]),
                                                  (3, 2, 0, 1))),
        "patch_embed.proj.bias": t(params["patch_embed"]["bias"]),
        "norm.weight": t(params["norm"]["scale"]),
        "norm.bias": t(params["norm"]["bias"]),
    }
    for i in range(depth):
        blk = block_params_from_jax(params[f"block_{i}"], layer_scale)
        sd.update({f"blocks.{i}.{k}": v for k, v in blk.items()})
    return sd
