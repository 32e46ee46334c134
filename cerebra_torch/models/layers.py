"""EEG-ChannelNet-style convolution blocks (port of cerebra/models/layers.py;
the reference's layers.py:5-105, which nothing in the reference imports).
Inputs and outputs are NHWC, as in the JAX package; the convolutions run
NCHW inside.

- ConvLayer2D: BatchNorm → ReLU → Conv → Dropout 0.2 (pre-activation,
  layers.py:5-15).
- TemporalBlock: parallel temporal convolutions, one a dilation,
  concatenated on channels (:17-45), each padded as the reference pads it.
- SpatialBlock: parallel spatial convolutions of heights H, H/2, ...,
  concatenated on channels (:47-82).
- ResidualBlock: two 3×3 convolutions with BatchNorm and a skip, a 1×1
  `downsample` convolution on the skip where the stride or the width
  changes (:84-105).

BatchNorm is flax's (`models/batchnorm.py`), dropout flax's
(`models/dropout.py`), the initialisers flax's defaults. f32 only: no CLI
reaches these blocks.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cerebra_torch.models._torch_interop import conv_from_flax, flax_default_init, norm_from_flax
from cerebra_torch.models.batchnorm import BatchNorm2d
from cerebra_torch.models.dropout import Drop, active

Pair = Tuple[int, int]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ConvLayer2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel: Pair,
                 strides: Pair = (1, 1), padding: Pair = (0, 0), dilation: Pair = (1, 1),
                 drop_p: float = 0.2, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bn = BatchNorm2d(in_channels)
        self.conv = nn.Conv2d(in_channels, out_channels, tuple(kernel), tuple(strides),
                              tuple(padding), tuple(dilation))
        self.drop_p = drop_p
        flax_default_init(self, generator)

    def forward(self, x: torch.Tensor, drop: Optional[Drop] = None) -> torch.Tensor:
        y = _nhwc(self.conv(F.relu(self.bn(_nchw(x)))))
        return active(drop, self.training)(y, self.drop_p)


def temporal_padding(kernel_width: int, dilation: int) -> int:
    """The reference's padding of a dilated temporal convolution (:29-31)."""
    filter_size = kernel_width * dilation - 1
    return math.floor((filter_size - 1) / 2) - 1 * (dilation // 2 - 1)


class TemporalBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_layers: int, kernel_size: Pair,
                 strides: Pair, dilation_list: Sequence[Pair],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dilations = list(dilation_list)
        if len(dilations) < n_layers:
            dilations += [dilations[-1]] * (n_layers - len(dilations))
        self.layers = nn.ModuleList(
            ConvLayer2D(in_channels, out_channels, kernel_size, strides,
                        (0, temporal_padding(kernel_size[1], d[1])), d, generator=generator)
            for d in dilations[:n_layers])

    def forward(self, x: torch.Tensor, drop: Optional[Drop] = None) -> torch.Tensor:
        return torch.cat([layer(x, drop) for layer in self.layers], dim=-1)


class SpatialBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_spatial_layers: int,
                 strides: Pair, input_height: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = []
        for i in range(num_spatial_layers):
            kernel = (input_height // (i + 1), 1)
            layers.append(ConvLayer2D(in_channels, out_channels, kernel, strides,
                                      (math.floor((kernel[0] - 1) / 2), 0), (1, 1),
                                      generator=generator))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, drop: Optional[Drop] = None) -> torch.Tensor:
        return torch.cat([layer(x, drop) for layer in self.layers], dim=-1)


class ResidualBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, strides: Pair = (1, 1),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_0 = nn.Conv2d(in_channels, out_channels, 3, tuple(strides), 1, bias=False)
        self.bn_0 = BatchNorm2d(out_channels)
        self.conv_1 = nn.Conv2d(out_channels, out_channels, 3, 1, 1, bias=False)
        self.bn_1 = BatchNorm2d(out_channels)
        self.downsample = None
        if in_channels != out_channels or tuple(strides) != (1, 1):
            self.downsample = nn.Conv2d(in_channels, out_channels, 1, tuple(strides), bias=False)
        flax_default_init(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _nchw(x)
        y = F.relu(self.bn_0(self.conv_0(x)))
        y = self.bn_1(self.conv_1(y))
        if self.downsample is not None:
            x = self.downsample(x)
        return _nhwc(F.relu(y + x))


def _conv_layer_from_jax(prefix: str, p, s) -> Dict[str, torch.Tensor]:
    """A flax ConvLayer2D's params and batch_stats → this module's keys."""
    out = norm_from_flax(f"{prefix}bn", p["BatchNorm_0"], s["BatchNorm_0"])
    out.update(conv_from_flax(f"{prefix}conv", p["Conv_0"]))
    return out


def params_from_jax(module: str, variables) -> Dict[str, torch.Tensor]:
    """A flax `ConvLayer2D`, `TemporalBlock`, `SpatialBlock` or
    `ResidualBlock` `{"params", "batch_stats"}` tree → that module's state
    dict here."""
    p, s = variables["params"], variables["batch_stats"]
    if module == "ConvLayer2D":
        return _conv_layer_from_jax("", p, s)
    if module in ("TemporalBlock", "SpatialBlock"):
        out = {}
        for i in range(len(p)):
            out.update(_conv_layer_from_jax(f"layers.{i}.", p[f"ConvLayer2D_{i}"],
                                           s[f"ConvLayer2D_{i}"]))
        return out
    if module == "ResidualBlock":
        out = {}
        for i in range(2):
            out.update(conv_from_flax(f"conv_{i}", p[f"Conv_{i}"]))
            out.update(norm_from_flax(f"bn_{i}", p[f"BatchNorm_{i}"], s[f"BatchNorm_{i}"]))
        if "downsample" in p:
            out.update(conv_from_flax("downsample", p["downsample"]))
        return out
    raise ValueError(f"unknown block {module!r}")
