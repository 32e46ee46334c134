"""The zero-phase band-pass as a banded (T, T) FIR matrix, designed again
from its parameters: a Butterworth band-pass as second-order sections,
|H|² at 4096 rfft bins, its impulse response cut to `num_taps` symmetric
taps, and the taps laid out as W[t_in, t_out] with zero-padded edges."""

import numpy as np
import torch


def zero_phase_taps(low: float, high: float, fs: float, order: int, num_taps: int,
                    n_fft: int = 4096) -> np.ndarray:
    from scipy import signal

    sos = signal.butter(order, [low / (fs / 2.0), high / (fs / 2.0)], btype="bandpass",
                        output="sos")
    w = 2.0 * np.pi * np.arange(n_fft // 2 + 1) / n_fft
    z = np.exp(-1j * w)
    h = np.ones_like(z)
    for b0, b1, b2, _, a1, a2 in sos:
        h = h * (b0 + b1 * z + b2 * z ** 2) / (1.0 + a1 * z + a2 * z ** 2)
    ir = np.fft.irfft((h * np.conj(h)).real, n=n_fft)
    half = num_taps // 2
    return np.concatenate([ir[-half:], ir[:half + 1]])


def fir_matrix(cfg: dict, device) -> torch.Tensor:
    """W (T, T) float32 for the configuration's band, order, taps and T."""
    taps = zero_phase_taps(cfg["band"][0], cfg["band"][1], cfg["fs"], cfg["filter_order"],
                           cfg["num_taps"])
    T, half = cfg["raw_samples"], len(taps) // 2
    W = np.zeros((T, T))
    for k, tap in enumerate(taps):
        off = k - half
        idx = np.arange(max(0, -off), min(T, T - off))
        W[idx + off, idx] = tap
    return torch.from_numpy(W).to(device=device, dtype=torch.float32)
