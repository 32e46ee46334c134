"""DinoModel: an inference wrapper around a DINO ViT backbone and an optional
DINOHead, with checkpoint import and the DINO-v1 image preprocessing (port of
cerebra/models/dino_model.py; utils/DinoModel.py:37-100 and the dino_args
defaults :11-34).

Weights come from a local reference-layout checkpoint (`from_torch_checkpoint`)
or a seeded random init; nothing is downloaded. Inference runs under
`torch.inference_mode()`; on a CUDA device every block takes the fused
attention and MLP forwards (K5, K7), as the port's ViT does by default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from cerebra_torch.models.heads import DINOHead
from cerebra_torch.models.vit import vit_base, vit_small, vit_tiny
from cerebra_torch.signal.image_aug import IMAGENET_MEAN, IMAGENET_STD
from cerebra_torch.signal.windows import tile_eeg_views, window_starts

_ARCHS = {"vit_tiny": vit_tiny, "vit_small": vit_small, "vit_base": vit_base}


def dino_image_transform(image, image_size: int = 224) -> np.ndarray:
    """Resize the short side to max(256, image_size) → centre crop →
    ImageNet-normalise (utils/DinoModel.py:83-88 and the torch.hub DINOv2
    default transform), (H, W, 3) in, NHWC-row numpy out. Pixel values above
    2 are taken as 0-255. The resize is bilinear with antialiasing, as
    `jax.image.resize` does (the long side truncates, torchvision Resize
    semantics)."""
    img = torch.from_numpy(np.array(image, dtype=np.float32))
    if img.max() > 2.0:
        img = img / 255.0
    H, W = img.shape[:2]
    target = max(256, int(image_size))
    if H <= W:
        new_h, new_w = target, int(target * W / H)
    else:
        new_h, new_w = int(target * H / W), target
    img = F.interpolate(img.permute(2, 0, 1)[None], size=(new_h, new_w), mode="bilinear",
                        align_corners=False, antialias=True)[0].permute(1, 2, 0)
    top = (new_h - image_size) // 2
    left = (new_w - image_size) // 2
    img = img[top:top + image_size, left:left + image_size]
    return ((img - torch.from_numpy(IMAGENET_MEAN)) / torch.from_numpy(IMAGENET_STD)).numpy()


@dataclasses.dataclass
class DinoArgs:
    """dino_args defaults (utils/DinoModel.py:11-34)."""

    arch: str = "vit_small"
    patch_size: int = 8
    out_dim: int = 65536
    image_size: int = 224
    use_head: bool = True
    norm_last_layer: bool = True
    use_bn_in_head: bool = False


class DinoModel:
    """The backbone (and the head, when `args.use_head` and, for a loaded
    checkpoint, when it holds one) on `device`, weights from `seed`."""

    def __init__(self, args: DinoArgs = DinoArgs(), seed: int = 0, device="cpu"):
        gen = torch.Generator().manual_seed(seed)
        self.args = args
        self.device = torch.device(device)
        self.backbone = _ARCHS[args.arch](patch_size=args.patch_size, img_size=args.image_size,
                                          generator=gen).to(self.device).eval()
        self.head = None
        if args.use_head:
            self.head = DINOHead(self.backbone.embed_dim, args.out_dim, use_bn=args.use_bn_in_head,
                                 norm_last_layer=args.norm_last_layer,
                                 generator=gen).to(self.device).eval()

    @torch.inference_mode()
    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, 3) NHWC, already preprocessed → features."""
        feats = self.backbone(images.to(self.device, torch.float32))
        return self.head(feats) if self.head is not None else feats

    def dinov1_transform(self, image) -> np.ndarray:
        """Resize-256 → centre-crop → ImageNet-normalise, NHWC numpy."""
        return dino_image_transform(image, self.args.image_size)

    def features_from_eeg(self, eeg: torch.Tensor, starts: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """EEG (B, T, C) → tiled EEG images → DINO features (transformEEGDataDino
        pass_eeg=True, utils/PerilsEEGDataset.py:410-449). `starts` (B,) are
        the images' column-window starts, drawn from `generator` when None
        (`signal/windows.py::window_starts`)."""
        eeg = torch.as_tensor(eeg, dtype=torch.float32).to(self.device)
        B, T, C = eeg.shape
        size = self.args.image_size
        if starts is None:
            starts = window_starts((B,), C, T, size, generator)
        return self(tile_eeg_views(eeg, torch.as_tensor(starts)[None], size)[0])

    @staticmethod
    def from_torch_checkpoint(path: str, args: DinoArgs = DinoArgs(),
                              checkpoint_key: str = "teacher", device="cpu") -> "DinoModel":
        """A reference-layout checkpoint (its `checkpoint_key` entry when
        present): `module.` stripped; `backbone.`-prefixed or bare keys to the
        ViT, `head.` keys to the DINOHead (utils/DinoModel.py:60-78). Keys the
        ViT does not have are ignored; a checkpoint without head keys gives a
        model without a head. The pos-embed keeps the checkpoint's grid (the
        ViT interpolates it at other input sizes)."""
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(ckpt, dict) and checkpoint_key in ckpt:
            ckpt = ckpt[checkpoint_key]
        cleaned = {(k[len("module."):] if k.startswith("module.") else k): torch.as_tensor(v)
                   for k, v in ckpt.items()}
        backbone_sd = {(k[len("backbone."):] if k.startswith("backbone.") else k): v
                       for k, v in cleaned.items() if not k.startswith("head.")}
        head_sd = {k[len("head."):]: v for k, v in cleaned.items() if k.startswith("head.")}
        model = DinoModel(args, device=device)
        vit = model.backbone
        vit.pos_embed = torch.nn.Parameter(torch.empty_like(backbone_sd["pos_embed"]))
        vit.load_state_dict({k: backbone_sd[k] for k in vit.state_dict()}, strict=True)
        vit.to(model.device)
        if head_sd and model.head is not None:
            model.head.load_state_dict(head_sd, strict=True)
        else:
            model.head = None
        return model
