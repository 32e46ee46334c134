"""ResNet-50 (port of cerebra/models/resnet.py): the DINO hub's `dino_resnet50`
backbone, and the tower of ResnetFeatureRegressor
(utils/ResnetFeatureRegressor.py:6-35) and Barlow Twins
(EEG-BarlowNetworks/net.py:15-20) in the JAX package.

A standard bottleneck ResNet under torchvision's names (`conv1`, `bn1`,
`layer{1..4}.{j}.conv{1..3}`, `.bn{1..3}`, `.downsample.{0,1}`, `fc`), so
`import_torchvision_resnet50` selects keys. Inputs are NHWC, as in the JAX
package. BatchNorm is flax's (`models/batchnorm.py`): batch statistics in
training, with the biased variance folded into the running one; running
statistics in eval. `remat` checkpoints as the JAX ResNet does: each
stage, and inside a stage's recompute each block (torch.utils.checkpoint,
non-reentrant, nested); every recompute leaves the running statistics as
the first pass left them, as flax's remat does. Plain XLA in the JAX
package, so stock PyTorch here.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from cerebra_torch.models._torch_interop import (
    conv_from_flax,
    dense_from_flax,
    flax_default_init,
    norm_from_flax,
)
from cerebra_torch.models.batchnorm import BatchNorm2d, update_once


def _bn(dim: int) -> BatchNorm2d:
    return BatchNorm2d(dim)


class BottleneckBlock(nn.Module):
    def __init__(self, in_dim: int, features: int, stride: int = 1,
                 zero_init_residual: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_dim, features, 1, bias=False)
        self.bn1 = _bn(features)
        # explicit padding 1 (torch's symmetric grid, also at stride 2)
        self.conv2 = nn.Conv2d(features, features, 3, stride, 1, bias=False)
        self.bn2 = _bn(features)
        self.conv3 = nn.Conv2d(features, features * 4, 1, bias=False)
        self.bn3 = _bn(features * 4)
        if zero_init_residual:
            nn.init.zeros_(self.bn3.weight)
        self.downsample = None
        if stride != 1 or in_dim != features * 4:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_dim, features * 4, 1, stride, bias=False), _bn(features * 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


def _checkpointed_stage(stage: nn.Sequential):
    """The stage as checkpoint's function, each block checkpointed inside
    it: the backward keeps the stage's input, and in the stage's recompute
    each block's input. A block's forward starts up to three times (the
    forward, the stage's recompute, its own recompute; a recompute stops
    once it has the tensors it needs); only the first moves the running
    statistics."""
    blocks = [update_once(b, b) for b in stage]

    def run(y):
        for b in blocks:
            y = checkpoint(b, y, use_reentrant=False)
        return y

    return update_once(run, stage)


class ResNet(nn.Module):
    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3), num_classes: int = 0,
                 zero_init_residual: bool = False, width: int = 64, remat: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.remat = remat
        self.conv1 = nn.Conv2d(3, width, 7, 2, 3, bias=False)
        self.bn1 = _bn(width)
        in_dim = width
        for i, n_blocks in enumerate(stage_sizes):
            blocks = []
            for j in range(n_blocks):
                blocks.append(BottleneckBlock(in_dim, width * 2 ** i,
                                              2 if i > 0 and j == 0 else 1, zero_init_residual))
                in_dim = width * 2 ** i * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.fc = nn.Linear(in_dim, num_classes) if num_classes else None
        flax_default_init(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) NHWC → pooled (B, 2048) features (or logits)."""
        y = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        y = F.max_pool2d(y, 3, 2, 1)
        for i in range(self.n_stages):
            stage = getattr(self, f"layer{i + 1}")
            if self.remat and torch.is_grad_enabled():
                y = checkpoint(_checkpointed_stage(stage), y, use_reentrant=False)
            else:
                y = stage(y)
        y = y.mean(dim=(2, 3))  # global average pool
        return self.fc(y) if self.fc is not None else y


def resnet50(num_classes: int = 0, zero_init_residual: bool = False, remat: bool = False,
             generator: Optional[torch.Generator] = None) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes, zero_init_residual, remat=remat,
                  generator=generator)


def _resnet_keys(stage_sizes: Sequence[int], num_classes: int):
    keys, bns = ["conv1.weight"], ["bn1"]
    for s, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            t = f"layer{s + 1}.{j}"
            keys += [f"{t}.conv{c}.weight" for c in (1, 2, 3)]
            bns += [f"{t}.bn{c}" for c in (1, 2, 3)]
            if j == 0:  # every stage's first block changes width or stride
                keys.append(f"{t}.downsample.0.weight")
                bns.append(f"{t}.downsample.1")
    if num_classes:
        keys += ["fc.weight", "fc.bias"]
    return keys, bns


def import_torchvision_resnet50(state_dict, num_classes: int = 0,
                                stage_sizes: Sequence[int] = (3, 4, 6, 3)
                                ) -> Dict[str, torch.Tensor]:
    """A torchvision `resnet50().state_dict()` → this module's state dict
    (the pretrained backbone of utils/ResnetFeatureRegressor.py:11-12).
    `num_classes=0` drops the classifier (the reference strips it, :15).
    Values may be tensors or numpy arrays; raises KeyError for a missing
    key."""
    keys, bns = _resnet_keys(stage_sizes, num_classes)
    bn_keys = [f"{bn}.{p}" for bn in bns for p in ("weight", "bias", "running_mean",
                                                      "running_var")]
    missing = [k for k in keys + bn_keys if k not in state_dict]
    if missing:
        raise KeyError(f"ResNet state dict lacks {missing[:4]} ({len(missing)} keys)")
    out = {k: torch.as_tensor(np.asarray(state_dict[k], dtype=np.float32))
           for k in keys + bn_keys}
    for bn in bns:
        n = state_dict.get(bn + ".num_batches_tracked", 0)
        out[bn + ".num_batches_tracked"] = torch.as_tensor(np.asarray(n, dtype=np.int64))
    return out


def load_pretrained_resnet50(path: str, num_classes: int = 0) -> Dict[str, torch.Tensor]:
    """A locally saved torchvision resnet50 checkpoint (.pth state dict, the
    stand-in for ResNet50_Weights.DEFAULT; nothing is downloaded) → this
    module's state dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return import_torchvision_resnet50(sd, num_classes=num_classes)


def params_from_jax(variables, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                    num_classes: int = 0) -> Dict[str, torch.Tensor]:
    """A flax ResNet `{"params", "batch_stats"}` tree → this module's state
    dict (the inverse of `cerebra.models.resnet.import_torchvision_resnet50`)."""
    p, s = variables["params"], variables["batch_stats"]
    out = dict(conv_from_flax("conv1", p["Conv_0"]))
    out.update(norm_from_flax("bn1", p["BatchNorm_0"], s["BatchNorm_0"]))
    k = 0
    for stage, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            tp, bp, bs = f"layer{stage + 1}.{j}", p[f"BottleneckBlock_{k}"], \
                s[f"BottleneckBlock_{k}"]
            for c in range(3):
                out.update(conv_from_flax(f"{tp}.conv{c + 1}", bp[f"Conv_{c}"]))
                out.update(norm_from_flax(f"{tp}.bn{c + 1}", bp[f"BatchNorm_{c}"],
                                          bs[f"BatchNorm_{c}"]))
            if "downsample_conv" in bp:
                out.update(conv_from_flax(f"{tp}.downsample.0", bp["downsample_conv"]))
                out.update(norm_from_flax(f"{tp}.downsample.1", bp["downsample_bn"],
                                          bs["downsample_bn"]))
            k += 1
    if num_classes:
        out.update(dense_from_flax("fc", p["Dense_0"]))
    return out

class ResnetFeatureRegressor(nn.Module):
    """ResNet-50 (trainable) and a linear regression head
    (utils/ResnetFeatureRegressor.py:6-35): NHWC images → (B, output_size)."""

    def __init__(self, output_size: int, num_features: int = 2048,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = resnet50(generator=generator)
        self.fc = nn.Linear(num_features, output_size)
        flax_default_init(self.fc, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.backbone(x))


def init_feature_regressor(output_size: int, pretrained_path: Optional[str] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> ResnetFeatureRegressor:
    """A ResnetFeatureRegressor; with `pretrained_path` (a local torchvision
    resnet50 .pth, the reference's `resnet50(weights=ResNet50_Weights.
    DEFAULT)`, :11-12) the backbone takes its weights and running
    statistics, and the head keeps its fresh init (the reference's new
    nn.Linear, :22)."""
    model = ResnetFeatureRegressor(output_size, generator=generator)
    if pretrained_path:
        model.backbone.load_state_dict(load_pretrained_resnet50(pretrained_path))
    return model


def regressor_params_from_jax(variables) -> Dict[str, torch.Tensor]:
    """A flax ResnetFeatureRegressor `{"params", "batch_stats"}` tree → this
    module's state dict."""
    p, s = variables["params"], variables["batch_stats"]
    out = {f"backbone.{k}": v for k, v in
           params_from_jax({"params": p["ResNet_0"], "batch_stats": s["ResNet_0"]}).items()}
    out.update(dense_from_flax("fc", p["fc"]))
    return out
