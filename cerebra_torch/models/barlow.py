"""Cross-modal Barlow Twins (port of cerebra/models/barlow.py;
EEG-BarlowNetworks/net.py:11-42).

Two towers: images → ResNet-50 (`backbone_image`); the EEG's mel
spectrogram stack → a 1×1 Conv(96→3) with padding 1 (`eeg_stem`, as the
reference has it: (N, 224, 8, 96) → (N, 226, 10, 3)) → ResNet-50
(`backbone_eeg`). Both pool their features (the reference's
`self.backbone.fc` is an AttributeError on its own class, SURVEY.md §7.2).
One projector 2048→8192→8192→8192 (Linear without bias, BatchNorm, ReLU
between) serves both towers, so its running statistics move twice a step,
the image pass first, as flax chains them. The loss is
`cerebra_torch.losses.barlow_twins_loss`. Plain XLA in the JAX package, so
stock PyTorch here (cuDNN convolutions, torch matmuls).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from cerebra_torch.models import resnet as _resnet
from cerebra_torch.models._torch_interop import (
    conv_from_flax,
    dense_from_flax,
    flax_default_init,
    norm_from_flax,
)
from cerebra_torch.models.batchnorm import BatchNorm1d

TOWERS = ("backbone_image", "backbone_eeg")


class Projector(nn.Sequential):
    """Linear (no bias) → BatchNorm1d → ReLU between the layers, a last
    Linear; torch keys `projector.{0,1,3,4,6}` as the reference's
    nn.Sequential has them."""

    def __init__(self, in_dim: int = 2048, sizes: Sequence[int] = (8192, 8192, 8192)):
        layers = []
        for s in sizes[:-1]:
            layers += [nn.Linear(in_dim, s, bias=False), BatchNorm1d(s), nn.ReLU()]
            in_dim = s
        layers.append(nn.Linear(in_dim, sizes[-1], bias=False))
        super().__init__(*layers)


class BarlowTwins(nn.Module):
    """forward(y1 images NHWC, y2 EEG spectrograms NHWC with C = 96) →
    (z1, z2) projector outputs."""

    def __init__(self, projector_sizes: Sequence[int] = (8192, 8192, 8192),
                 eeg_in_channels: int = 96, remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone_image = _resnet.resnet50(zero_init_residual=True, remat=remat,
                                               generator=generator)
        self.eeg_stem = nn.Conv2d(eeg_in_channels, 3, 1, padding=1, bias=False)
        self.backbone_eeg = _resnet.resnet50(zero_init_residual=True, remat=remat,
                                             generator=generator)
        self.projector = Projector(2048, tuple(projector_sizes))
        flax_default_init(self.eeg_stem, generator)
        flax_default_init(self.projector, generator)

    def forward(self, y1: torch.Tensor, y2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        f1 = self.backbone_image(y1)
        stem = self.eeg_stem(y2.permute(0, 3, 1, 2))  # NCHW; the tower takes NHWC views
        f2 = self.backbone_eeg(stem.permute(0, 2, 3, 1))
        return self.projector(f1), self.projector(f2)


def graft_pretrained_towers(model: BarlowTwins, path: str) -> BarlowTwins:
    """Both towers take a local torchvision resnet50 checkpoint's weights
    and running statistics (the optional `--pretrained_backbone` extension;
    the reference's towers start from random init, net.py:15-19). The stem
    and the projector keep theirs."""
    sd = _resnet.load_pretrained_resnet50(path)
    for tower in TOWERS:
        getattr(model, tower).load_state_dict(sd)
    return model


def projector_from_jax(params, stats, depth: int = 3, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A flax Projector's params and batch_stats (`depth` sizes) → its keys
    here."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(depth):
        out.update(dense_from_flax(f"{prefix}{3 * i}", params[f"Dense_{i}"]))
        if i < depth - 1:
            out.update(norm_from_flax(f"{prefix}{3 * i + 1}", params[f"BatchNorm_{i}"],
                                      stats[f"BatchNorm_{i}"]))
    return out


def params_from_jax(variables, projector_depth: int = 3) -> Dict[str, torch.Tensor]:
    """A flax BarlowTwins `{"params", "batch_stats"}` tree → this module's
    state dict (`projector_depth` = the number of projector sizes)."""
    p, s = variables["params"], variables["batch_stats"]
    out: Dict[str, torch.Tensor] = {}
    for tower, name in zip(TOWERS, ("ResNet_0", "ResNet_1")):
        sd = _resnet.params_from_jax({"params": p[name], "batch_stats": s[name]})
        out.update({f"{tower}.{k}": v for k, v in sd.items()})
    out.update(conv_from_flax("eeg_stem", p["eeg_stem"]))
    out.update(projector_from_jax(p["projector"], s["projector"], projector_depth, "projector."))
    return out
