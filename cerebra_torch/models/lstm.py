"""`Model` — the LSTM encoder of the LSTM→DINOv2 trainer — and `InlineLSTM`
(port of cerebra/models/lstm.py: LSTMStack, Model, InlineLSTM, import of
the `.pth` layout).

Parameters are held under the reference `.pth` names — `lstm.weight_ih_l{k}`
(4H, in), `lstm.weight_hh_l{k}` (4H, H), `lstm.bias_ih_l{k}`,
`lstm.bias_hh_l{k}`, `fc.weight`/`fc.bias`, `head.weight`/`head.bias` — so a
checkpoint is `state_dict()`, the layout that
`cerebra.models.lstm.export_torch_state_dict` writes and
`import_torch_state_dict` reads.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cerebra_torch.models.lstm_stack import lstm_stack, lstm_stack_last


def _uniform(shape, bound, generator, device):
    w = torch.empty(shape, device="cpu")
    nn.init.uniform_(w, -bound, bound, generator=generator)
    return nn.Parameter(w.to(device))


class LSTMStack(nn.Module):
    """Multi-layer LSTM over (B, T, C) returning the top layer's hidden
    states (B, T, H), or only h[T−1] (B, H) with `last_state_only`. Runs
    time-major inside; the bias is b_ih + b_hh; weights and input are cast
    to `dtype` (the stream dtype; None = the input's) while the cell state
    stays f32 inside the kernels. The input gets a gradient when it
    requires one; the backward skips dx when it does not (`lstm_stack`)."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None, *,
                 last_state_only: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dtype = dtype
        self.last_state_only = last_state_only
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
        x_t, layers = self.prepare(x)
        if self.last_state_only:
            return lstm_stack_last(x_t, layers)
        return lstm_stack(x_t, layers).transpose(0, 1)


def _linear(in_f, out_f, generator, device):
    lin = nn.Linear(in_f, out_f, device=device)
    bound = 1.0 / math.sqrt(in_f)  # nn.Linear's default range, from the generator
    with torch.no_grad():
        lin.weight.copy_(_uniform((out_f, in_f), bound, generator, device))
        lin.bias.copy_(_uniform((out_f,), bound, generator, device))
    return lin


def _dense(lin: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax Dense with `dtype`: input and parameters cast to it (None = x's)."""
    cd = dtype or x.dtype
    return F.linear(x.to(cd), lin.weight.to(cd), lin.bias.to(cd))


class Model(nn.Module):
    """LSTM → h[T−1] → relu(fc) features → class head.

    forward(eeg (B, T, C), features_only=False):
      features_only=True → h[T−1] (B, lstm_size);
      include_top=False  → features (B, output_size);
      include_top=True   → (features, class logits (B, n_classes)).

    `output_size=None` builds the stack alone, under `lstm.*`, and forward
    returns h[T−1]: the DINO-LSTM backbone, whose flax params hold only
    `lstm` because the JAX recipe initialises `Model` with
    features_only=True (cerebra/train/recipes.py:331-341)."""

    def __init__(self, input_size: int, lstm_size: int, lstm_layers: int,
                 output_size: Optional[int], include_top: bool = True, n_classes: int = 40,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.include_top = include_top and output_size is not None
        self.dtype = dtype
        self.lstm = LSTMStack(input_size, lstm_size, lstm_layers, dtype, device, generator,
                              last_state_only=True)
        if output_size is not None:
            self.fc = _linear(lstm_size, output_size, generator, device)
        if self.include_top:
            self.head = _linear(output_size, n_classes, generator, device)

    def top(self, h_last: torch.Tensor):
        """Everything after the LSTM: features, and the class logits."""
        feats = torch.relu(_dense(self.fc, h_last, self.dtype))
        if not self.include_top:
            return feats
        return feats, _dense(self.head, feats, self.dtype)

    def forward(self, x: torch.Tensor, features_only: bool = False):
        h_last = self.lstm(x)
        if features_only or not hasattr(self, "fc"):
            return h_last
        return self.top(h_last)


class InlineLSTM(nn.Module):
    """The inline LSTMModel of LSTMDistill.py / LSTMDistillRetreival.py:
    LSTM → h[T−1] → fc → class head, forward(x) → (features, logits).

    An input whose last axis is not `input_size` but whose second-to-last
    is, (B, C, T), is turned to (B, T, C): by a transpose, or with
    `compat_view_bug` by the reference's `.view(B, T, C)`, a row-major
    reinterpretation of the memory that scrambles channels and time."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int, output_size: int,
                 n_classes: int = 40, compat_view_bug: bool = False,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.compat_view_bug = compat_view_bug
        self.dtype = dtype
        self.lstm = LSTMStack(input_size, hidden_size, num_layers, dtype, device, generator,
                              last_state_only=True)
        self.fc = _linear(hidden_size, output_size, generator, device)
        self.head = _linear(output_size, n_classes, generator, device)

    def forward(self, x: torch.Tensor):
        if x.shape[-1] != self.input_size and x.shape[-2] == self.input_size:
            if self.compat_view_bug:
                x = x.reshape(x.shape[0], x.shape[2], x.shape[1])
            else:
                x = x.transpose(-1, -2)
        feats = _dense(self.fc, self.lstm(x), self.dtype)
        return feats, _dense(self.head, feats, self.dtype)


_JAX_TO_TORCH = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih", "b_hh": "bias_hh"}


def params_from_jax(params) -> dict:
    """A flax param tree of numpy arrays → the state dict of the port's
    module of the same structure, as f32 tensors: an LSTM stack's
    `w_ih_l0` (in, 4H) ... under the nn.LSTM names (`weight_ih_l0` (4H, in),
    ...), a Dense kernel (in, out) as `weight` (out, in), a Conv or
    ConvTranspose kernel (K, in, out) as `weight` (out, in, K), biases as
    they are. Submodule names are kept, less flax's leading underscores.
    Covers `Model` and `InlineLSTM` (`lstm/fc/head`) and the autoencoders."""
    p = params["params"] if "params" in params else params
    out = {}

    def walk(prefix, tree):
        for name, val in tree.items():
            if isinstance(val, dict):
                walk(f"{prefix}{name.lstrip('_')}.", val)
                continue
            arr = np.asarray(val, dtype=np.float32)
            if name in ("kernel", "bias"):
                key = "weight" if name == "kernel" else "bias"
                out[prefix + key] = arr.transpose(tuple(reversed(range(arr.ndim))))
            else:
                kind, layer = name.rsplit("_l", 1)
                out[f"{prefix}{_JAX_TO_TORCH[kind]}_l{layer}"] = arr.T

    walk("", p)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in out.items()}


def strip_prefixes(state_dict, prefixes: Sequence[str] = ("module.", "backbone.")) -> dict:
    """{key: tensor} with each listed prefix a key starts with removed, in
    order, once each (cerebra/models/lstm.py::import_torch_state_dict;
    utils/utils.py:71-109, LstmDistillFromDinoV2Eval.py:309-313), as f32
    CPU tensors."""
    out = {}
    for k, v in state_dict.items():
        for pref in prefixes:
            if k.startswith(pref):
                k = k[len(pref):]
        out[k] = (v.detach().to("cpu", torch.float32) if torch.is_tensor(v)
                  else torch.as_tensor(np.asarray(v, dtype=np.float32)))
    return out


def model_from_state_dict(state_dict, input_size: int, dtype: Optional[torch.dtype] = None,
                          device=None) -> Model:
    """A `Model` loaded from a `.pth` state dict in the reference layout
    (port of load_model_params, cerebra/cli/lstm_distill_from_dinov2_eval.py:
    33-74), its shape read from the weights: the LSTM size from
    `lstm.weight_hh_l0`, the depth from the highest layer index, the
    feature width from `fc.weight` and the class count from `head.weight`.
    A state dict without `fc` (a DINO backbone) gives the stack alone
    (`output_size=None`); without `head`, no top. `module.` and `backbone.`
    prefixes are stripped first."""
    sd = strip_prefixes(state_dict)
    lstm_size = int(sd["lstm.weight_hh_l0"].shape[1])
    layers = 1 + max(int(k.rsplit("_l", 1)[1]) for k in sd if k.startswith("lstm.weight_hh_l"))
    output_size = int(sd["fc.weight"].shape[0]) if "fc.weight" in sd else None
    n_classes = int(sd["head.weight"].shape[0]) if "head.weight" in sd else 40
    model = Model(input_size, lstm_size, layers, output_size, include_top="head.weight" in sd,
                  n_classes=n_classes, dtype=dtype, device=device)
    model.load_state_dict(sd, strict=True)
    return model
