"""`Model` — the LSTM encoder of the LSTM→DINOv2 trainer (port of
cerebra/models/lstm.py: LSTMStack, Model, export/import of the `.pth`
layout).

Parameters are held under the reference `.pth` names — `lstm.weight_ih_l{k}`
(4H, in), `lstm.weight_hh_l{k}` (4H, H), `lstm.bias_ih_l{k}`,
`lstm.bias_hh_l{k}`, `fc.weight`/`fc.bias`, `head.weight`/`head.bias` — so a
checkpoint is `state_dict()`, the layout that
`cerebra.models.lstm.export_torch_state_dict` writes and
`import_torch_state_dict` reads.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cerebra_torch.models.lstm_stack import lstm_stack_last


def _uniform(shape, bound, generator, device):
    w = torch.empty(shape, device="cpu")
    nn.init.uniform_(w, -bound, bound, generator=generator)
    return nn.Parameter(w.to(device))


class LSTMStack(nn.Module):
    """Multi-layer LSTM over (B, T, C) returning the top layer's h[T−1]
    (B, H). Runs time-major inside; the bias is b_ih + b_hh; weights and
    input are cast to `dtype` (the stream dtype; None = the input's) while
    the cell state stays f32 inside the kernels."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dtype = dtype
        H = hidden_size
        bound = 1.0 / math.sqrt(H)  # torch nn.LSTM's default init range
        for l in range(num_layers):
            in_dim = input_size if l == 0 else H
            self.register_parameter(f"weight_ih_l{l}", _uniform((4 * H, in_dim), bound, generator, device))
            self.register_parameter(f"weight_hh_l{l}", _uniform((4 * H, H), bound, generator, device))
            self.register_parameter(f"bias_ih_l{l}", _uniform((4 * H,), bound, generator, device))
            self.register_parameter(f"bias_hh_l{l}", _uniform((4 * H,), bound, generator, device))

    def prepare(self, x: torch.Tensor):
        """(x (T, B, C), layers) in the stream dtype, as the kernels take
        them: w_ih (in, 4H), w_hh (H, 4H), b (4H,)."""
        cd = self.dtype or x.dtype
        x_t = x.to(cd).transpose(0, 1).contiguous()
        layers = []
        for l in range(self.num_layers):
            w_ih = getattr(self, f"weight_ih_l{l}")
            w_hh = getattr(self, f"weight_hh_l{l}")
            b = getattr(self, f"bias_ih_l{l}") + getattr(self, f"bias_hh_l{l}")
            layers.append((w_ih.t().to(cd).contiguous(), w_hh.t().to(cd).contiguous(), b.to(cd)))
        return x_t, layers

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lstm_stack_last(*self.prepare(x))


def _linear(in_f, out_f, generator, device):
    lin = nn.Linear(in_f, out_f, device=device)
    bound = 1.0 / math.sqrt(in_f)  # nn.Linear's default range, from the generator
    with torch.no_grad():
        lin.weight.copy_(_uniform((out_f, in_f), bound, generator, device))
        lin.bias.copy_(_uniform((out_f,), bound, generator, device))
    return lin


class Model(nn.Module):
    """LSTM → h[T−1] → relu(fc) features → class head.

    forward(eeg (B, T, C), features_only=False):
      features_only=True → h[T−1] (B, lstm_size);
      include_top=False  → features (B, output_size);
      include_top=True   → (features, class logits (B, n_classes)).
    """

    def __init__(self, input_size: int, lstm_size: int, lstm_layers: int, output_size: int,
                 include_top: bool = True, n_classes: int = 40,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.include_top = include_top
        self.dtype = dtype
        self.lstm = LSTMStack(input_size, lstm_size, lstm_layers, dtype, device, generator)
        self.fc = _linear(lstm_size, output_size, generator, device)
        if include_top:
            self.head = _linear(output_size, n_classes, generator, device)

    def _dense(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        cd = self.dtype or x.dtype
        return F.linear(x.to(cd), lin.weight.to(cd), lin.bias.to(cd))

    def top(self, h_last: torch.Tensor):
        """Everything after the LSTM: features, and the class logits."""
        feats = torch.relu(self._dense(self.fc, h_last))
        if not self.include_top:
            return feats
        return feats, self._dense(self.head, feats)

    def forward(self, x: torch.Tensor, features_only: bool = False):
        h_last = self.lstm(x)
        if features_only:
            return h_last
        return self.top(h_last)


_JAX_TO_TORCH = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih", "b_hh": "bias_hh"}


def params_from_jax(params) -> dict:
    """A flax param tree of numpy arrays (`lstm/w_ih_l0` (in, 4H),
    `fc/kernel` (in, out), ...) → this Model's state dict of f32 tensors."""
    p = params["params"] if "params" in params else params
    out = {}
    for name, val in p["lstm"].items():
        kind, layer = name.rsplit("_l", 1)
        arr = np.asarray(val, dtype=np.float32)
        out[f"lstm.{_JAX_TO_TORCH[kind]}_l{layer}"] = arr.T if arr.ndim == 2 else arr
    for mod in ("fc", "head"):
        if mod in p:
            out[f"{mod}.weight"] = np.asarray(p[mod]["kernel"], dtype=np.float32).T
            out[f"{mod}.bias"] = np.asarray(p[mod]["bias"], dtype=np.float32)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}
