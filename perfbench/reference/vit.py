"""DINO's ViT, plainly (dino/vision_transformer.py:134-254, `vit_small`
at patch 8): the patch convolution, the CLS token, the position grid
(resized bicubically for views off the training grid), pre-LN blocks with
explicit softmax attention and exact GELU, stochastic depth from given
masks, and the final LayerNorm; the CLS feature out. EEG trials become
images as utils/EEGDataset.py:248-303 tiles them. Parameters are a {name:
tensor} dict under the timm names; `q` rounds every product's operands
(`precision.py`)."""

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.nets import linear
from perfbench.reference.precision import f32, mm

LN_EPS = 1e-6  # vit_small's partial(nn.LayerNorm, eps=1e-6)


def eeg_images(eeg: torch.Tensor, starts: torch.Tensor, size: int) -> torch.Tensor:
    """Trials eeg (B, T, C) as 3-channel images (n_views·B, 3, size, size),
    view by view: each trial's (C, T) rows repeated size // C + 1 times and
    columns size // T + 1 times, the rows cut to size, then the size-wide
    column window at starts[v, b]."""
    B, T, C = eeg.shape
    rows = eeg.transpose(1, 2).repeat_interleave(size // C + 1, 1)[:, :size]
    tiled = rows.repeat_interleave(size // T + 1, 2)
    out = [tiled[b, :, s:s + size] for view in starts.tolist() for b, s in enumerate(view)]
    return torch.stack(out)[:, None].expand(-1, 3, size, size)


def drop_path_keeps(rate: float, depth: int):
    """Each block's keep probability: its drop rate rises linearly from 0 to
    `rate` over the blocks (:149)."""
    return [1.0 - float(r) for r in np.linspace(0, rate, depth)]


def position_grid(pos: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """The CLS position and the patch grid resized to (gh, gw): bicubic with
    antialiasing (the JAX package's `jax.image.resize`), kept as it is on
    the square grid it was trained on."""
    n = pos.shape[1] - 1
    if gh * gw == n and gh == gw:
        return pos
    g0 = int(round(np.sqrt(n)))
    grid = pos[:, 1:].reshape(1, g0, g0, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", align_corners=False,
                         antialias=True)
    return torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], 1)


def layer_norm(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps=LN_EPS)


def _drop(y: torch.Tensor, mask, keep: float) -> torch.Tensor:
    """The branch of each sample kept and scaled by 1 / keep, or dropped."""
    return y if mask is None else y * (mask.float() / keep)[:, None, None]


def block(x: torch.Tensor, p: dict, name: str, heads: int, keep: float, masks=(None, None),
          q=f32) -> torch.Tensor:
    """x + attn(norm1(x)), then + mlp(norm2(·)), each branch through its
    mask of `masks` (None: kept)."""
    n, N, D = x.shape
    qkv = linear(layer_norm(x, p, f"{name}.norm1"), p, f"{name}.attn.qkv", q)
    qh, kh, vh = qkv.reshape(n, N, 3, heads, D // heads).permute(2, 0, 3, 1, 4)
    attn = torch.softmax(mm(qh, kh.transpose(-2, -1), q) * (D // heads) ** -0.5, dim=-1)
    o = mm(attn, vh, q).transpose(1, 2).reshape(n, N, D)
    x = x + _drop(linear(o, p, f"{name}.attn.proj", q), masks[0], keep)
    h = F.gelu(linear(layer_norm(x, p, f"{name}.norm2"), p, f"{name}.mlp.fc1", q))
    return x + _drop(linear(h, p, f"{name}.mlp.fc2", q), masks[1], keep)


def vit_cls(images: torch.Tensor, p: dict, prefix: str, cfg: dict, masks=None,
            q=f32) -> torch.Tensor:
    """The CLS feature (n, D) of images (n, 3, S, S). masks[i] is block i's
    (attention, MLP) pair of per-image keep masks, or None for no drop."""
    w, b = p[f"{prefix}patch_embed.proj.weight"], p[f"{prefix}patch_embed.proj.bias"]
    x = F.conv2d(q(images), q(w), b, stride=cfg["patch_size"])
    n, D, gh, gw = x.shape
    x = torch.cat([p[f"{prefix}cls_token"].expand(n, 1, D), x.flatten(2).transpose(1, 2)], 1)
    x = x + position_grid(p[f"{prefix}pos_embed"], gh, gw)
    keeps = drop_path_keeps(cfg["drop_path_rate"], cfg["depth"])
    for i, keep in enumerate(keeps):
        x = block(x, p, f"{prefix}blocks.{i}", cfg["num_heads"], keep,
                  (masks[i] if masks else None) or (None, None), q)
    return layer_norm(x[:, 0], p, f"{prefix}norm")
