"""Zero-phase band-pass as one banded matrix product (port of the parts of
cerebra/signal/filters.py that the training step uses).

Design is on the host (scipy, float64, once): `design_bandpass` gives
second-order sections, `zero_phase_fir` the truncated symmetric FIR of
filtfilt's |H|², and `zero_phase_matrix` that FIR as a banded (T, T) matrix
W[t_in, t_out] with zero-padded 'same' edges, so filtering is y = x @ W.
`filtfilt_matmul` is a plain product (the JAX package left it to XLA), done
with torch.matmul: operands in the matrix dtype, f32 accumulation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FilterSpec:
    """Designed IIR filter as second-order sections.

    sos: (n_sections, 6) rows [b0 b1 b2 a0 a1 a2] with a0 == 1.
    zi:  (n_sections, 2) steady-state per-section initial conditions.
    """

    sos: np.ndarray
    zi: np.ndarray

    @property
    def n_sections(self) -> int:
        return int(self.sos.shape[0])


def _make_spec(sos: np.ndarray) -> FilterSpec:
    from scipy import signal as sps

    sos = np.asarray(sos, dtype=np.float64)
    return FilterSpec(sos=sos, zi=sps.sosfilt_zi(sos))


def design_bandpass(
    lowcut: float,
    highcut: float,
    fs: float,
    order: int = 4,
    kind: str = "butter",
    rp: float = 1.0,
    rs: float = 20.0,
) -> FilterSpec:
    """Band-pass design bank (utils/EEGFilters.py:26-39; kinds: butter,
    cheby1, cheby2, ellip; reference orders 3/4/5 with rp=1, rs=20)."""
    from scipy import signal as sps

    wn = [lowcut / (fs / 2.0), highcut / (fs / 2.0)]
    if kind == "butter":
        sos = sps.butter(order, wn, btype="bandpass", output="sos")
    elif kind == "cheby1":
        sos = sps.cheby1(order, rp, wn, btype="bandpass", output="sos")
    elif kind == "cheby2":
        sos = sps.cheby2(order, rs, wn, btype="bandpass", output="sos")
    elif kind == "ellip":
        sos = sps.ellip(order, rp, rs, wn, btype="bandpass", output="sos")
    else:
        raise ValueError(f"unknown filter kind: {kind}")
    return _make_spec(sos)


def _zero_phase_response_np(spec: FilterSpec, n_fft: int) -> np.ndarray:
    w = 2.0 * np.pi * np.arange(n_fft // 2 + 1) / n_fft
    ejw = np.exp(-1j * w)
    h = np.ones_like(ejw)
    for s in range(spec.n_sections):
        b0, b1, b2, _, a1, a2 = spec.sos[s]
        h = h * (b0 + b1 * ejw + b2 * ejw**2) / (1.0 + a1 * ejw + a2 * ejw**2)
    return (h * np.conj(h)).real


def zero_phase_fir(spec: FilterSpec, num_taps: int = 257, n_fft: int = 4096) -> np.ndarray:
    """Truncated symmetric FIR equivalent of the zero-phase filter |H|²
    (host-side, float64)."""
    if num_taps % 2 != 1:
        raise ValueError("zero-phase FIR needs an odd tap count")
    ir = np.fft.irfft(_zero_phase_response_np(spec, n_fft), n=n_fft)
    half = num_taps // 2
    return np.concatenate([ir[-half:], ir[: half + 1]]).astype(np.float64)


def zero_phase_matrix(
    spec_or_taps, signal_length: int, num_taps: int = 257,
    dtype: torch.dtype = torch.bfloat16, device=None,
) -> torch.Tensor:
    """The zero-phase FIR as a banded (T, T) matrix W[t_in, t_out]."""
    taps = (
        zero_phase_fir(spec_or_taps, num_taps)
        if isinstance(spec_or_taps, FilterSpec)
        else np.asarray(spec_or_taps)
    )
    T = signal_length
    half = len(taps) // 2
    W = np.zeros((T, T), dtype=np.float64)
    for k, tap in enumerate(taps):
        off = k - half
        idx = np.arange(max(0, -off), min(T, T - off))
        W[idx + off, idx] = tap
    return torch.from_numpy(W).to(device=device, dtype=dtype)


def filtfilt_matmul(
    filter_matrix: torch.Tensor, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    """Apply a `zero_phase_matrix` along the last axis (any leading axes).

    Operands are rounded to the matrix dtype and accumulated in f32; the f32
    sum is rounded once to `out_dtype` (default: kept in f32). With a bf16
    matrix and bf16 output the product runs on the tensor cores directly."""
    xm = x.to(filter_matrix.dtype)
    if out_dtype is not None and out_dtype == filter_matrix.dtype:
        return xm @ filter_matrix
    y = xm.float() @ filter_matrix.float()
    return y if out_dtype is None else y.to(out_dtype)
