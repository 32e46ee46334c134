"""Multi-crop forwarding (port of cerebra/models/multicrop.py;
utils/utils.py:598-633 MultiCropWrapper).

Crops arrive stacked per resolution group ((n_views, B, ...) tensors), so
each group is one batched backbone forward and the head runs once on the
concatenation, in group-then-view order.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn


def multicrop_forward(
    backbone: Callable[[torch.Tensor], torch.Tensor],
    head: Callable[[torch.Tensor], torch.Tensor],
    view_groups: Sequence[torch.Tensor],
) -> torch.Tensor:
    """Run `backbone` once per same-shape view group and `head` once on the
    concatenated features → (total_views · B, out_dim), views ordered
    group by group, then view by view (the reference's cat order)."""
    feats = []
    for group in view_groups:
        n_views, B = group.shape[:2]
        feats.append(backbone(group.reshape((n_views * B,) + tuple(group.shape[2:]))))
    return head(torch.cat(feats, 0))


class MultiCropWrapper(nn.Module):
    """Backbone plus head under the reference checkpoint prefixes
    `backbone.*` and `head.*`."""

    def __init__(self, backbone: nn.Module, head: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, view_groups: Sequence[torch.Tensor]) -> torch.Tensor:
        return multicrop_forward(self.backbone, self.head, view_groups)
