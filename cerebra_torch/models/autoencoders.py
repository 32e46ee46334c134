"""EEG autoencoders (port of cerebra/models/autoencoders.py).

- `feature_matching_loss`: MSE between the encoder output and target latent
  features only.
- `RecurrentAutoencoder`: LSTM encoder → last hidden state (the latent) →
  repeated over seq_len → LSTM decoder; forward → (encoded, decoded). Both
  LSTMs run over the full sequence (K1/K2g under grad, K4 otherwise), and
  the decoder's input gradient feeds the encoder's.
- `EEGAutoencoderFC`: flat FC autoencoder with residual MLP blocks;
  forward → (encoded, decoded).
- `EEGAutoencoderConv`: strided conv1d encoder → latent → transposed-conv
  decoder; forward → the reconstruction.

Submodules carry the flax module names (`encoder`/`decoder`, `Dense_0`,
`ResidualMLPBlock_0`, `Conv_0`, `ConvTranspose_0`, ...), so
`cerebra_torch.models.lstm.params_from_jax` maps a JAX param tree onto each
class's state dict. Each Dense, conv and LSTM computes in `dtype` (None =
the input's), as flax's `dtype`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cerebra_torch.models.lstm import LSTMStack, _dense, _linear, _uniform


def feature_matching_loss(encoded: torch.Tensor, latent_features: torch.Tensor) -> torch.Tensor:
    """utils/EEGAutoencoder.py:16-23 (the reconstruction term is commented out
    there)."""
    return torch.mean((encoded - latent_features) ** 2)


def _dropout(h: torch.Tensor, train: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax Dropout(0.5): at train, keep each value with probability 0.5 and
    scale by 2, the mask drawn from `generator` (flax needs a dropout rng)."""
    if not train:
        return h
    if generator is None:
        raise ValueError("train=True draws dropout masks: pass a torch.Generator")
    keep = torch.empty(h.shape, device=generator.device).bernoulli_(0.5, generator=generator)
    return h * keep.to(h.device, h.dtype) * 2.0


class ResidualMLPBlock(nn.Module):
    """x + Dense(relu(Dense(x)))."""

    def __init__(self, features: int, dtype=None, device=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = _linear(features, features, generator, device)
        self.Dense_1 = _linear(features, features, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(_dense(self.Dense_0, x, self.dtype))
        return x + _dense(self.Dense_1, h, self.dtype)


class EEGAutoencoderFC(nn.Module):
    """(B, channels, time_freq) → flat → 1000 → residual blocks → relu latent,
    and back to a relu (B, channels · time_freq) reconstruction; dropout 0.5
    after each 1000-wide input layer."""

    def __init__(self, channels: int = 128, time_freq: int = 480, latent_dim: int = 384,
                 num_residual_blocks: int = 2, dtype: Optional[torch.dtype] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.n_blocks = num_residual_blocks
        widths = [(channels * time_freq, 1000), (1000, latent_dim), (latent_dim, 1000),
                  (1000, channels * time_freq)]
        for k, (i, o) in enumerate(widths):
            setattr(self, f"Dense_{k}", _linear(i, o, generator, device))
        for k in range(2 * num_residual_blocks):
            setattr(self, f"ResidualMLPBlock_{k}",
                    ResidualMLPBlock(1000, dtype, device, generator))

    def _half(self, h, first_dense: int, first_block: int, train, generator):
        h = torch.relu(_dense(getattr(self, f"Dense_{first_dense}"), h, self.dtype))
        h = _dropout(h, train, generator)
        for k in range(first_block, first_block + self.n_blocks):
            h = getattr(self, f"ResidualMLPBlock_{k}")(h)
        return torch.relu(_dense(getattr(self, f"Dense_{first_dense + 1}"), h, self.dtype))

    def forward(self, x: torch.Tensor, train: bool = True,
                generator: Optional[torch.Generator] = None):
        encoded = self._half(x.reshape(x.shape[0], -1), 0, 0, train, generator)
        decoded = self._half(encoded, 2, self.n_blocks, train, generator)
        return encoded, decoded


def _conv_out(t: int) -> int:
    """Length after a kernel-3, stride-2 conv padded (1, 1)."""
    return (t - 1) // 2 + 1


class EEGAutoencoderConv(nn.Module):
    """Conv1d autoencoder over (B, in_channels, time_freq): strided convs
    in → 64 → 32 → 16, flatten → relu latent → mirror transposed convs,
    cropped to time_freq; forward → (B, in_channels, time_freq).

    flax's ConvTranspose(padding=((1, 2),), strides=(2,)) is not
    torch.nn.ConvTranspose1d: it inserts a zero between input samples, pads
    with (1, 2) and cross-correlates with the kernel unflipped
    (transpose_kernel=False). `ConvTranspose_k` holds that stride-1 conv's
    weight (out, in, 3), and `_conv_transpose` does the same."""

    def __init__(self, in_channels: int = 128, latent_dim: int = 2048, time_freq: int = 480,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.time_freq = time_freq
        self.t_enc = _conv_out(_conv_out(_conv_out(time_freq)))
        chans = [in_channels, 64, 32, 16]
        for k in range(3):
            setattr(self, f"Conv_{k}", self._conv(chans[k], chans[k + 1], generator, device))
            setattr(self, f"ConvTranspose_{k}",
                    self._conv(chans[3 - k], chans[2 - k], generator, device))
        self.Dense_0 = _linear(self.t_enc * 16, latent_dim, generator, device)
        self.Dense_1 = _linear(latent_dim, self.t_enc * 16, generator, device)

    @staticmethod
    def _conv(cin, cout, generator, device) -> nn.Module:
        conv = nn.Module()
        bound = 1.0 / math.sqrt(cin * 3)  # nn.Conv1d's default range
        conv.weight = _uniform((cout, cin, 3), bound, generator, device)
        conv.bias = _uniform((cout,), bound, generator, device)
        return conv

    def _cast(self, h, conv):
        cd = self.dtype or h.dtype
        return h.to(cd), conv.weight.to(cd), conv.bias.to(cd)

    def _conv_transpose(self, h: torch.Tensor, conv: nn.Module) -> torch.Tensor:
        h, w, b = self._cast(h, conv)
        B, C, T = h.shape
        dilated = h.new_zeros(B, C, 2 * T - 1)
        dilated[:, :, ::2] = h
        return F.conv1d(F.pad(dilated, (1, 2)), w, b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        h = x
        for k in range(3):
            h = torch.relu(F.conv1d(*self._cast(h, getattr(self, f"Conv_{k}")), stride=2,
                                    padding=1))
        flat = h.transpose(1, 2).reshape(B, -1)  # flax flattens (B, T, C)
        latent = torch.relu(_dense(self.Dense_0, flat, self.dtype))
        h = torch.relu(_dense(self.Dense_1, latent, self.dtype))
        h = h.reshape(B, self.t_enc, 16).transpose(1, 2)
        for k in range(3):
            h = torch.relu(self._conv_transpose(h, getattr(self, f"ConvTranspose_{k}")))
        return h[:, :, :self.time_freq]


class RecurrentAutoencoder(nn.Module):
    """utils/LSTMAutoEncoders.py: a 1-layer LSTM encoder over (B, seq_len,
    n_features) to its last hidden state `encoded` (B, embedding_dim), which
    is repeated seq_len times into a 1-layer LSTM decoder with
    H = n_features; forward → (encoded, decoded (B, seq_len, n_features)).

    Both LSTMs return the full sequence, as in JAX: the encoder's cotangent
    is (T, B, H), zero but at T−1, and takes the full-g backward (K2g)."""

    def __init__(self, seq_len: int, n_features: int, embedding_dim: int = 384,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.seq_len = seq_len
        self.encoder = LSTMStack(n_features, embedding_dim, 1, dtype, device, generator)
        self.decoder = LSTMStack(embedding_dim, n_features, 1, dtype, device, generator)

    def forward(self, x: torch.Tensor):
        encoded = self.encoder(x)[:, -1]
        decoded = self.decoder(encoded[:, None, :].expand(-1, self.seq_len, -1))
        return encoded, decoded
