"""Welch PSD + EEG band powers (utils/MNE_Utils.py:63-95 `checkFrequencies`;
port of cerebra/signal/psd.py), batched over every leading axis.

As in cerebra, every bin but the first and the last is doubled, also at an
odd nperseg, where scipy.signal.welch doubles the last bin too (its last
bin is then not Nyquist): there the last bin reads half scipy's.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

# the reference's band definitions (utils/MNE_Utils.py:69-83)
EEG_BANDS: Dict[str, Tuple[float, float]] = {
    "delta": (0.5, 4.0),
    "theta": (4.0, 7.0),
    "alpha": (8.0, 13.0),
    "beta": (13.0, 30.0),
    "gamma": (30.0, 140.0),
}


def welch_psd(
    x: torch.Tensor, fs: float, nperseg: int = 256, noverlap: Optional[int] = None
) -> Tuple[np.ndarray, torch.Tensor]:
    """Welch power spectral density over the last axis: x (..., T) →
    (freqs (F,), psd (..., F)). Periodic Hann window, mean-detrended
    segments, density scaling."""
    T = x.shape[-1]
    if nperseg > T:  # scipy.signal.welch shrinks nperseg to the signal length
        nperseg = T
        noverlap = None
    if noverlap is None:
        noverlap = nperseg // 2
    segs = x.unfold(-1, nperseg, nperseg - noverlap)  # (..., n_segs, nperseg)
    segs = segs - segs.mean(dim=-1, keepdim=True)
    # periodic Hann (scipy get_window('hann', n, fftbins=True)); ones at n = 1
    win_np = np.ones(1) if nperseg == 1 else np.hanning(nperseg + 1)[:-1]
    window = torch.as_tensor(win_np, dtype=x.dtype, device=x.device)
    spec = torch.fft.rfft(segs * window, dim=-1)
    scale = 1.0 / (fs * torch.sum(window ** 2))
    psd = spec.abs() ** 2 * scale
    psd[..., 1:-1] *= 2.0
    freqs = np.fft.rfftfreq(nperseg, 1.0 / fs)
    return freqs, psd.mean(dim=-2)


def band_powers(
    x: torch.Tensor, fs: float, nperseg: int = 256,
    bands: Dict[str, Tuple[float, float]] = EEG_BANDS,
) -> Dict[str, torch.Tensor]:
    """Mean PSD per canonical EEG band (utils/MNE_Utils.py:69-95):
    x (..., T) → {band: (...,)}."""
    freqs, psd = welch_psd(x, fs, nperseg)
    out = {}
    for name, (lo, hi) in bands.items():
        idx = np.nonzero((freqs >= lo) & (freqs <= hi))[0]
        if len(idx) == 0:
            out[name] = psd.new_zeros(psd.shape[:-1])
        else:
            out[name] = psd[..., torch.as_tensor(idx, device=psd.device)].mean(dim=-1)
    return out
