"""Image augmentations of the DINO image pipeline (port of
cerebra/signal/image_aug.py; dino/main_dino.py:484-522 DataAugmentationDINO).

The reference composes torchvision RandomResizedCrop, HorizontalFlip,
ColorJitter, GaussianBlur and Solarization on the host, image by image. Here
each op is a function of its random draws, given as data (one value per view
and sample), over a batch of views (V, B, H, W, 3) NHWC on the tensors'
device: no per-image loop. `draw_crop` draws them from a torch.Generator on
the host; the JAX package draws the same quantities from its keys, so its
draws can be fed in and the ops compared.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
_LUMA = (0.299, 0.587, 0.114)  # ITU-R 601, torchvision's rgb_to_grayscale
_RGB2YIQ = ((0.299, 0.587, 0.114), (0.5959, -0.2746, -0.3213), (0.2115, -0.5227, 0.3112))
_YIQ2RGB = ((1.0, 0.956, 0.619), (1.0, -0.272, -0.647), (1.0, -1.106, 1.703))


def _per_view(v: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """A (V, B) draw broadcast over each view's (H, W, 3)."""
    return v.to(img.device).reshape(v.shape + (1,) * (img.dim() - v.dim()))


def normalize(img: torch.Tensor) -> torch.Tensor:
    """ImageNet normalisation (the reference's `normalize` transform)."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=img.device)
    std = torch.as_tensor(IMAGENET_STD, device=img.device)
    return (img - mean) / std


def crop_box(H: int, W: int, area: torch.Tensor,
             log_ratio: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """torchvision RandomResizedCrop's box size from the drawn area (in
    pixels) and log aspect ratio, in f32, clipped to [8, side] and truncated
    to int32 → (h, w)."""
    aspect = torch.exp(log_ratio.float())
    area = area.float()
    w = torch.clamp(torch.sqrt(area * aspect), 8, W).to(torch.int32)
    h = torch.clamp(torch.sqrt(area / aspect), 8, H).to(torch.int32)
    return h, w


def random_resized_crop(imgs: torch.Tensor, out_size: int, area: torch.Tensor,
                        log_ratio: torch.Tensor, top: torch.Tensor,
                        left: torch.Tensor) -> torch.Tensor:
    """imgs (B, H, W, C) → (V, B, out, out, C): view v of sample b is the box
    of `crop_box(area[v, b], log_ratio[v, b])` at (top, left), resized by
    gathering output pixel i from source row top + ⌊i·h/out⌋ (the JAX
    package's gather crop; the reference resizes bicubically)."""
    B, H, W, _ = imgs.shape
    dev = imgs.device
    h, w = crop_box(H, W, area, log_ratio)
    i = torch.arange(out_size, device=dev)
    ys = top.to(dev)[..., None] + (i * h.to(dev)[..., None]) // out_size  # (V, B, out)
    xs = left.to(dev)[..., None] + (i * w.to(dev)[..., None]) // out_size
    b = torch.arange(B, device=dev)[None, :, None, None]
    return imgs[b, ys[..., :, None].long(), xs[..., None, :].long()]


def random_hflip(img: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of the views whose `flip` bit is set."""
    return torch.where(_per_view(flip, img), img.flip(-2), img)


def color_jitter(img: torch.Tensor, brightness: torch.Tensor, contrast: torch.Tensor,
                 saturation: torch.Tensor, theta: Optional[torch.Tensor],
                 apply: torch.Tensor) -> torch.Tensor:
    """ColorJitter (dino/main_dino.py:488-490) with the drawn factors:
    brightness, contrast and saturation multipliers and a hue angle `theta`
    (radians; None: no hue step), on the views whose `apply` bit is set.
    Hue rotates the (I, Q) chroma plane of YIQ, the JAX package's formula
    (an HSV hue shift up to gamut clipping), then the result clips to [0, 1]."""
    dt = img.dtype
    luma = torch.tensor(_LUMA, dtype=dt, device=img.device)
    out = img * _per_view(brightness, img)
    mean = out.mean(dim=(-3, -2), keepdim=True)
    out = (out - mean) * _per_view(contrast, img) + mean
    gray = (out * luma).sum(-1, keepdim=True)
    out = (out - gray) * _per_view(saturation, img) + gray
    if theta is not None:
        rgb2yiq = torch.tensor(_RGB2YIQ, dtype=dt, device=img.device)
        yiq2rgb = torch.tensor(_YIQ2RGB, dtype=dt, device=img.device)
        yiq = out @ rgb2yiq.T
        cos_t = _per_view(torch.cos(theta), img)[..., 0]
        sin_t = _per_view(torch.sin(theta), img)[..., 0]
        rot = torch.stack([
            yiq[..., 0],
            cos_t * yiq[..., 1] - sin_t * yiq[..., 2],
            sin_t * yiq[..., 1] + cos_t * yiq[..., 2],
        ], dim=-1)
        out = rot @ yiq2rgb.T
    return torch.where(_per_view(apply, img), out.clamp(0.0, 1.0), img)


def random_grayscale(img: torch.Tensor, gray_bit: torch.Tensor) -> torch.Tensor:
    """RandomGrayscale (dino/main_dino.py:491) on the views whose bit is set."""
    luma = torch.tensor(_LUMA, dtype=img.dtype, device=img.device)
    gray = (img * luma).sum(-1, keepdim=True).expand_as(img)
    return torch.where(_per_view(gray_bit, img), gray, img)


def blur_kernel(sigma: torch.Tensor) -> torch.Tensor:
    """(..., 9) normalised Gaussian taps at offsets -4..4."""
    xs = torch.arange(-4, 5, dtype=torch.float32, device=sigma.device)
    kern = torch.exp(-0.5 * (xs / sigma.float()[..., None]) ** 2)
    return kern / kern.sum(-1, keepdim=True)


def gaussian_blur(img: torch.Tensor, sigma: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    """Separable 9-tap Gaussian blur, along H then W, on the views whose
    `apply` bit is set: `correlate(mode="same")`, which pads with zeros."""
    kern = blur_kernel(sigma.to(img.device))
    taps = [_per_view(kern[..., j], img) for j in range(9)]
    blurred = img
    for axis in (-3, -2):
        n = blurred.shape[axis]
        padded = torch.nn.functional.pad(blurred, [0, 0] * (-axis - 1) + [4, 4])
        acc = torch.zeros_like(blurred)
        for j in range(9):
            acc = acc + taps[j] * padded.narrow(axis, j, n)
        blurred = acc
    return torch.where(_per_view(apply, img), blurred, img)


def solarization(img: torch.Tensor, bit: torch.Tensor) -> torch.Tensor:
    return torch.where(_per_view(bit, img), torch.where(img >= 0.5, 1.0 - img, img), img)


@dataclasses.dataclass
class CropDraws:
    """One crop recipe's draws, each (V, B): the crop's area in pixels, log
    aspect ratio, top and left; the flip bit; the jitter's factors, hue
    angle and bit; the gray bit; the blur's sigma and bit; the solarize bit
    (None: the recipe does not solarize)."""

    area: torch.Tensor
    log_ratio: torch.Tensor
    top: torch.Tensor
    left: torch.Tensor
    flip: torch.Tensor
    brightness: torch.Tensor
    contrast: torch.Tensor
    saturation: torch.Tensor
    theta: torch.Tensor
    jitter: torch.Tensor
    gray: torch.Tensor
    sigma: torch.Tensor
    blur: torch.Tensor
    solarize: Optional[torch.Tensor] = None


def draw_crop(generator: Optional[torch.Generator], shape: Tuple[int, ...], H: int, W: int,
              scale: Tuple[float, float], blur_p: float, solarize_p: float = 0.0) -> CropDraws:
    """The draws of `dino_global_crop` / `dino_local_crop` for `shape`
    (V, B) crops of H × W images, from `generator` on the host, with the
    JAX package's distributions: aspect ratio in [3/4, 4/3] on a log scale,
    top and left uniform over [0, side − h], ColorJitter(0.4, 0.4, 0.2,
    0.1) with p 0.8, grayscale p 0.2, sigma in [0.1, 2]."""
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=generator)

    def bit(p):
        return torch.rand(shape, generator=generator) < p

    area = H * W * u(*scale)
    log_ratio = u(math.log(3 / 4), math.log(4 / 3))
    h, w = crop_box(H, W, area, log_ratio)
    top = (torch.rand(shape, generator=generator) * (H - h + 1).clamp_min(1)).long()
    left = (torch.rand(shape, generator=generator) * (W - w + 1).clamp_min(1)).long()
    return CropDraws(
        area=area, log_ratio=log_ratio, top=top, left=left, flip=bit(0.5),
        brightness=1.0 + u(-0.4, 0.4), contrast=1.0 + u(-0.4, 0.4),
        saturation=1.0 + u(-0.2, 0.2), theta=2.0 * math.pi * u(-0.1, 0.1),
        jitter=bit(0.8), gray=bit(0.2), sigma=u(0.1, 2.0), blur=bit(blur_p),
        solarize=bit(solarize_p) if solarize_p > 0 else None,
    )


def _crop_pipeline(imgs: torch.Tensor, out_size: int, d: CropDraws) -> torch.Tensor:
    out = random_resized_crop(imgs, out_size, d.area, d.log_ratio, d.top, d.left)
    out = random_hflip(out, d.flip)
    out = color_jitter(out, d.brightness, d.contrast, d.saturation, d.theta, d.jitter)
    out = random_grayscale(out, d.gray)
    out = gaussian_blur(out, d.sigma, d.blur)
    if d.solarize is not None:
        out = solarization(out, d.solarize)
    return normalize(out)


def dino_global_crop(imgs: torch.Tensor, draws: CropDraws, out_size: int = 224) -> torch.Tensor:
    """imgs (B, H, W, 3) in [0, 1] → (V, B, out, out, 3) normalised global
    crops: crop, flip, jitter, gray, blur, solarize when drawn. Draw with
    `draw_crop(..., scale=(0.4, 1.0), blur_p=1.0)`."""
    return _crop_pipeline(imgs, out_size, draws)


def dino_local_crop(imgs: torch.Tensor, draws: CropDraws, out_size: int = 96) -> torch.Tensor:
    """imgs (B, H, W, 3) in [0, 1] → (V, B, out, out, 3) normalised local
    crops: crop, flip, jitter, gray, blur. Draw with
    `draw_crop(..., scale=(0.05, 0.4), blur_p=0.5)`."""
    return _crop_pipeline(imgs, out_size, draws)
