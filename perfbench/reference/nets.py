"""The networks, plainly: an LSTM stack (torch.nn.LSTM's cell, gates in
the order i, f, g, o, the two biases added), the LSTM→DINOv2 student
(stack → h[T−1] → ReLU(fc) → class head) and DINOHead (an MLP with
tanh-approximate GELU, L2 normalisation, a weight-normalised prototype
layer). Parameters are a {name: tensor} dict under the checkpoint names;
`q` rounds every product's operands (`precision.py`)."""

import torch
import torch.nn.functional as F

from perfbench.reference.precision import f32, mm


def lstm_last(x: torch.Tensor, p: dict, prefix: str, layers: int, q=f32) -> torch.Tensor:
    """The top layer's h at T−1 (B, H) of the stack over x (B, T, C)."""
    inp = x
    for l in range(layers):
        w_ih, w_hh = p[f"{prefix}weight_ih_l{l}"], p[f"{prefix}weight_hh_l{l}"]
        b = p[f"{prefix}bias_ih_l{l}"] + p[f"{prefix}bias_hh_l{l}"]
        B, T, _ = inp.shape
        H = w_hh.shape[1]
        xp = mm(inp.reshape(B * T, -1), w_ih.t(), q).reshape(B, T, 4 * H) + b
        h = x.new_zeros(B, H)
        c = x.new_zeros(B, H)
        outs = []
        for t in range(T):
            gates = xp[:, t] + mm(h, w_hh.t(), q)
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            if l < layers - 1:
                outs.append(h)
        if l < layers - 1:
            inp = torch.stack(outs, 1)
    return h


def linear(x: torch.Tensor, p: dict, name: str, q=f32) -> torch.Tensor:
    out = mm(x, p[f"{name}.weight"].t(), q)
    bias = p.get(f"{name}.bias")
    return out if bias is None else out + bias


def distill_model(eeg: torch.Tensor, p: dict, layers: int, q=f32):
    """(features, class logits) of the LSTM→DINOv2 student over (B, T, C)."""
    feats = torch.relu(linear(lstm_last(eeg, p, "lstm.", layers, q), p, "fc", q))
    return feats, linear(feats, p, "head", q)


def dino_head(x: torch.Tensor, p: dict, prefix: str, nlayers: int, q=f32) -> torch.Tensor:
    for i in range(nlayers):
        x = linear(x, p, f"{prefix}mlp.{2 * i}", q)
        if i < nlayers - 1:
            x = F.gelu(x, approximate="tanh")
    x = x / (x.norm(dim=-1, keepdim=True) + 1e-12)
    v, g = p[f"{prefix}last_layer.weight_v"], p[f"{prefix}last_layer.weight_g"]
    return mm(x, (g * v / (v.norm(dim=1, keepdim=True) + 1e-12)).t(), q)
