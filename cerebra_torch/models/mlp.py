"""CustomModel (port of cerebra/models/mlp.py; utils/CustomModel.py:4-17):
the image-feature → EEG regressor MLP in → 2000 → 2000 → out with ReLUs,
flax's default initialisers."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from cerebra_torch.models._torch_interop import dense_from_flax, flax_default_init


class CustomModel(nn.Module):
    def __init__(self, input_size: int, output_size: int, hidden: int = 2000,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc_0 = nn.Linear(input_size, hidden)
        self.fc_1 = nn.Linear(hidden, hidden)
        self.fc_2 = nn.Linear(hidden, output_size)
        flax_default_init(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc_2(F.relu(self.fc_1(F.relu(self.fc_0(x)))))


def params_from_jax(params) -> Dict[str, torch.Tensor]:
    """A flax CustomModel's `params` → this module's state dict."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(3):
        out.update(dense_from_flax(f"fc_{i}", params[f"Dense_{i}"]))
    return out
