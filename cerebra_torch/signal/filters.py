"""IIR and zero-phase filtering (port of cerebra/signal/filters.py).

Design is on the host (scipy, float64, once): `design_bandpass` and
`design_notch` give second-order sections (SOS), `zero_phase_fir` the
truncated symmetric FIR of filtfilt's |H|², and `zero_phase_matrix` that FIR
as a banded (T, T) matrix W[t_in, t_out] with zero-padded 'same' edges.

Application, along the last axis of any (..., T) tensor:
- `filtfilt` / `lfilter`: the exact cascade of biquads (scipy sosfiltfilt /
  sosfilt parity: odd extension, default padlen, zi scaled by the edge
  sample). The cascade is `sos_scan`, one pass over time: on a CUDA tensor
  the hand-written kernel `csrc/sos_scan.cu` (one thread a lane, both
  directions, f32 and f64), on a CPU tensor its plain loop over T.
- `filtfilt_fft`: rfft → |H|² → irfft of the odd-extended signal.
- `filtfilt_fir`: the truncated FIR as one depthwise convolution.
- `filtfilt_matmul`: y = x @ W, the training step's band-pass, done with
  torch.matmul: operands in the matrix dtype, f32 accumulation.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cerebra_torch.kernels import LAUNCHES, check_rc, load_lib, on_cuda, stream_of

LAUNCHES.update(sos_scan=0)


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

    @property
    def default_padlen(self) -> int:
        # scipy.signal.sosfiltfilt's default: 3 * ntaps, ntaps less the
        # trailing second-order coefficients that every section has at zero
        ntaps = 2 * self.n_sections + 1
        ntaps -= min(int((self.sos[:, 2] == 0).sum()), int((self.sos[:, 5] == 0).sum()))
        return 3 * ntaps


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


def design_notch(freq: float, fs: float, quality: float = 30.0) -> FilterSpec:
    """Power-line notch (ConvertToPth.py:109-111 applies a 60 Hz notch)."""
    from scipy import signal as sps

    b, a = sps.iirnotch(freq, quality, fs)
    return _make_spec(sps.tf2sos(b, a))


# ------------------------------------------------------------ the SOS scan
def _rounded(a: np.ndarray, dtype: torch.dtype) -> list:
    """Rows of `a` as Python floats rounded to `dtype` (the coefficients the
    scan computes with, as the JAX scan casts them to x's dtype)."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return np.asarray(a, dtype=np_dtype).astype(np.float64).tolist()


def _sos_scan_ref(sos: np.ndarray, x: torch.Tensor, zi: Optional[np.ndarray] = None,
                  zi_scale: Optional[torch.Tensor] = None, reverse: bool = False) -> torch.Tensor:
    """The plain version of `sos_scan`: a Python loop over T, each step the
    per-section update of cerebra/signal/filters.py:116-126 over every lane."""
    coef = _rounded(sos, x.dtype)
    T = x.shape[-1]
    lanes = x.shape[:-1]
    if zi is None:
        state = [[x.new_zeros(lanes), x.new_zeros(lanes)] for _ in coef]
    else:
        scale = zi_scale.expand(lanes)
        state = [[z0 * scale, z1 * scale] for z0, z1 in _rounded(zi, x.dtype)]
    xs = x.unbind(-1)
    out = [None] * T
    for t in (reversed(range(T)) if reverse else range(T)):
        s_in = xs[t]
        for (b0, b1, b2, _, a1, a2), z in zip(coef, state):
            yn = b0 * s_in + z[0]
            z[0] = b1 * s_in - a1 * yn + z[1]
            z[1] = b2 * s_in - a2 * yn
            s_in = yn
        out[t] = s_in
    return torch.stack(out, dim=-1)


def _typed(lib: ctypes.CDLL) -> None:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dp = ctypes.POINTER(ctypes.c_double)
    lib.cerebra_sos_scan.argtypes = [i, i, vp, vp, vp, dp, dp, i, ll, ll, vp]
    lib.cerebra_sos_scan.restype = i


def _sos_scan_cuda(sos: np.ndarray, x: torch.Tensor, zi: Optional[np.ndarray],
                   zi_scale: Optional[torch.Tensor], reverse: bool) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"sos_scan runs float32 and float64, not {x.dtype}")
    sos = np.ascontiguousarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6 or not 1 <= sos.shape[0] <= 8:
        raise ValueError(f"sos_scan takes 1 to 8 sections of 6 coefficients, got {sos.shape}")
    x = x.contiguous()
    T = x.shape[-1]
    lanes = x.numel() // T if T else 0
    y = torch.empty_like(x)
    if lanes == 0 or T == 0:
        return y
    scale, zi_arr = None, None
    if zi is not None:
        zi_arr = np.ascontiguousarray(zi, dtype=np.float64)
        scale = zi_scale.to(x.dtype).expand(x.shape[:-1]).contiguous()
    lib = load_lib("sos_scan", _typed)
    dp = ctypes.POINTER(ctypes.c_double)
    rc = lib.cerebra_sos_scan(
        int(x.dtype == torch.float64), int(reverse), x.data_ptr(), y.data_ptr(),
        None if scale is None else scale.data_ptr(), sos.ctypes.data_as(dp),
        None if zi_arr is None else zi_arr.ctypes.data_as(dp), sos.shape[0], lanes, T,
        stream_of(x))
    check_rc(lib, rc, "sos_scan")
    LAUNCHES["sos_scan"] += 1
    return y


def sos_scan(sos: np.ndarray, x: torch.Tensor, zi: Optional[np.ndarray] = None,
             zi_scale: Optional[torch.Tensor] = None, reverse: bool = False) -> torch.Tensor:
    """The cascade of biquads `sos` (S, 6), direct form II transposed, over
    the last axis of x (..., T), from t = 0 or (`reverse`) from t = T−1; the
    leading axes are lanes. Each lane starts from zi (S, 2) times its
    zi_scale (broadcast to x[..., 0]), or from zero without zi. Coefficients
    are rounded to x's dtype. The kernel `csrc/sos_scan.cu` on a CUDA tensor
    (float32 or float64), the plain loop on a CPU tensor."""
    if (zi is None) != (zi_scale is None):
        raise ValueError("sos_scan takes zi and zi_scale together, or neither")
    if on_cuda(x, zi_scale):
        return _sos_scan_cuda(sos, x, zi, zi_scale, reverse)
    return _sos_scan_ref(sos, x, zi, zi_scale, reverse)


def lfilter(spec: FilterSpec, x: torch.Tensor,
            zi_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal IIR filter along the last axis (scipy.signal.sosfilt parity).
    zi_scale, if given, multiplies the steady-state zi per lane (broadcast
    to x[..., 0]): the filtfilt edge condition."""
    return sos_scan(spec.sos, x, None if zi_scale is None else spec.zi, zi_scale)


def _odd_ext(x: torch.Tensor, padlen: int) -> torch.Tensor:
    """x with `padlen` samples of odd extension at each end (none at 0)."""
    left = 2.0 * x[..., :1] - x[..., 1:padlen + 1].flip(-1)
    right = 2.0 * x[..., -1:] - x[..., -padlen - 1:-1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def filtfilt(spec: FilterSpec, x: torch.Tensor, padlen: Optional[int] = None) -> torch.Tensor:
    """Zero-phase filtering along the last axis; scipy.signal.sosfiltfilt
    parity (padtype='odd'): the forward pass over the odd extension, then
    the backward pass from its end, each from zi scaled by its first
    sample. Two `sos_scan` launches on a CUDA tensor."""
    if padlen is None:
        padlen = spec.default_padlen
    T = x.shape[-1]
    if padlen >= T:
        raise ValueError(f"padlen {padlen} must be < signal length {T}")
    ext = _odd_ext(x, padlen)
    y = sos_scan(spec.sos, ext, spec.zi, ext[..., 0])
    y = sos_scan(spec.sos, y, spec.zi, y[..., -1], reverse=True)
    return y[..., padlen:padlen + T]


def _zero_phase_response_np(spec: FilterSpec, n_fft: int) -> np.ndarray:
    w = 2.0 * np.pi * np.arange(n_fft // 2 + 1) / n_fft
    ejw = np.exp(-1j * w)
    h = np.ones_like(ejw)
    for s in range(spec.n_sections):
        b0, b1, b2, _, a1, a2 = spec.sos[s]
        h = h * (b0 + b1 * ejw + b2 * ejw**2) / (1.0 + a1 * ejw + a2 * ejw**2)
    return (h * np.conj(h)).real


def zero_phase_response(spec: FilterSpec, n_fft: int, dtype: torch.dtype = torch.float32,
                        device=None) -> torch.Tensor:
    """|H(e^{jw})|² at the rfft bins of n_fft: the transfer function
    filtfilt applies (built on the host in float64, then cast)."""
    return torch.from_numpy(_zero_phase_response_np(spec, n_fft)).to(device=device, dtype=dtype)


def filtfilt_fft(spec: FilterSpec, x: torch.Tensor, h2: Optional[torch.Tensor] = None,
                 padlen: Optional[int] = None) -> torch.Tensor:
    """Zero-phase filter by FFT: irfft(rfft(odd_ext(x)) · |H|²), cropped.
    The odd extension (by default half the signal at each end) keeps the
    circular wrap-around out of the interior, where this tracks `filtfilt`.
    `h2` is `zero_phase_response(spec, T + 2 * padlen)`, built when None."""
    T = x.shape[-1]
    if padlen is None:
        padlen = T // 2
    ext = _odd_ext(x, padlen)
    n = T + 2 * padlen
    if h2 is None:
        h2 = zero_phase_response(spec, n, dtype=x.dtype, device=x.device)
    y = torch.fft.irfft(torch.fft.rfft(ext, dim=-1) * h2, n=n, dim=-1).to(x.dtype)
    return y[..., padlen:padlen + T]


def zero_phase_fir(spec: FilterSpec, num_taps: int = 257, n_fft: int = 4096) -> np.ndarray:
    """Truncated symmetric FIR equivalent of the zero-phase filter |H|²
    (host-side, float64)."""
    if num_taps % 2 != 1:
        raise ValueError("zero-phase FIR needs an odd tap count")
    ir = np.fft.irfft(_zero_phase_response_np(spec, n_fft), n=n_fft)
    half = num_taps // 2
    return np.concatenate([ir[-half:], ir[: half + 1]]).astype(np.float64)


def filtfilt_fir(spec_or_taps, x: torch.Tensor, num_taps: int = 257) -> torch.Tensor:
    """Zero-phase filter as one depthwise convolution over the last axis
    with the truncated FIR's taps ('same', zero-padded edges)."""
    taps = (
        zero_phase_fir(spec_or_taps, num_taps)
        if isinstance(spec_or_taps, FilterSpec)
        else np.asarray(spec_or_taps)
    )
    # conv1d correlates: the flipped taps convolve
    k = torch.from_numpy(taps[::-1].copy()).to(device=x.device, dtype=x.dtype).reshape(1, 1, -1)
    T = x.shape[-1]
    y = F.conv1d(x.reshape(-1, 1, T), k, padding="same")
    return y.reshape(x.shape)


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


def bandpass_notch_pipeline(
    x: torch.Tensor,
    fs: float,
    band: Tuple[float, float] = (14.0, 71.0),
    notch: Optional[float] = 60.0,
    order: int = 4,
    use_fft: bool = True,
) -> torch.Tensor:
    """The ConvertToPth ingest filter chain (ConvertToPth.py:106-111):
    band-pass then power-line notch, zero-phase, whole recording at once."""
    apply = filtfilt_fft if use_fft else filtfilt
    y = apply(design_bandpass(band[0], band[1], fs, order=order), x)
    if notch is not None:
        y = apply(design_notch(notch, fs), y)
    return y
