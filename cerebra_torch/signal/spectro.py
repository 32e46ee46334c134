"""Mel spectrograms (port of cerebra/signal/spectro.py): a batched STFT and a
mel filterbank in place of the per-channel librosa loop of the Barlow recipe
(EEG-BarlowNetworks/barlow_utils.py:53-60: melspectrogram per EEG channel,
sr=256, n_mels=224).

Defaults follow librosa: n_fft=2048, hop=n_fft//4, a periodic Hann window,
centred frames (reflect padding), power 2, the Slaney mel scale with
Slaney area normalisation. The filterbank is a numpy copy of the JAX
package's, bit for bit; the STFT is `torch.stft` over every (trial,
channel) lane at once, the mel projection one matrix product.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(
    sr: float, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: Optional[float] = None
) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, (n_mels, 1+n_fft/2),
    computed in float64 on the host and returned as float32."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def mel_fft_size(t_len: int, n_fft: int = 2048) -> int:
    """The FFT size of a T-sample signal: n_fft, or the largest power of two
    up to T when T is shorter (T = 460 gives 256)."""
    if t_len < n_fft:
        return int(2 ** np.floor(np.log2(max(t_len, 2))))
    return n_fft


def stft_magnitude(
    x: torch.Tensor, n_fft: int = 2048, hop_length: Optional[int] = None, power: float = 2.0
) -> torch.Tensor:
    """Centred periodic-Hann STFT power over the last axis:
    (..., T) → (..., 1+n_fft/2, frames)."""
    if hop_length is None:
        hop_length = n_fft // 4
    window = torch.from_numpy(np.hanning(n_fft + 1)[:-1]).to(x.device, x.dtype)
    lanes = x.reshape(-1, x.shape[-1])
    spec = torch.stft(lanes, n_fft, hop_length, window=window, center=True,
                      pad_mode="reflect", onesided=True, return_complex=True)
    mag = spec.abs() ** power
    return mag.reshape(*x.shape[:-1], *mag.shape[-2:])


def melspectrogram(
    x: torch.Tensor,
    sr: float = 256.0,
    n_fft: int = 2048,
    hop_length: Optional[int] = None,
    n_mels: int = 224,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    mel_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched mel spectrogram over the last axis: (..., T) → (..., n_mels,
    frames); EEG as (B, C, T) makes every channel one lane. `mel_weights`
    (n_mels, 1+n_fft/2) saves rebuilding the filterbank."""
    n_fft = mel_fft_size(x.shape[-1], n_fft)
    S = stft_magnitude(x, n_fft=n_fft, hop_length=hop_length)
    if mel_weights is None:
        mel_weights = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax))
    return torch.einsum("mf,...ft->...mt", mel_weights.to(x.device, x.dtype), S)
