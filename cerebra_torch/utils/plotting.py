"""Figures as PNG files in numpy and zlib (port of cerebra/utils/plotting.py
and of the analysis CLIs' matplotlib calls).

The card's machine has no matplotlib or PIL, so the port draws its own: a
heatmap through a colormap (`inferno`, `gray`, `tab10`), a polyline trace of
one or more series, a 3-D scatter seen at an azimuth and elevation, and
`write_png` (8-bit RGB, one IDAT chunk). The pixels
do not match matplotlib's (no axes, labels or legend); the arrays behind
them are what the JAX package plots.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence

import numpy as np

# matplotlib's inferno sampled at 17 even stops (linear in between: within
# 7/255 of its 256-entry table), tab10's ten colours, gray's two ends.
_STOPS = {
    "inferno": ("000004", "0b0724", "210c4a", "3d0965", "57106e", "71196e", "8a226a", "a32c61",
                "bc3754", "d24644", "e45a31", "f1731d", "f98e09", "fcac11", "f9cb35", "f2ea69",
                "fcffa4"),
    "gray": ("000000", "ffffff"),
}
TAB20C = ("3182bd", "6baed6", "9ecae1", "c6dbef", "e6550d", "fd8d3c", "fdae6b", "fdd0a2",
          "31a354", "74c476", "a1d99b", "c7e9c0", "756bb1", "9e9ac8", "bcbddc", "dadaeb",
          "636363", "969696", "bdbdbd", "d9d9d9")
TAB10 = ("1f77b4", "ff7f0e", "2ca02c", "d62728", "9467bd", "8c564b", "e377c2", "7f7f7f",
         "bcbd22", "17becf")


def _rgb(hex_colours: Sequence[str]) -> np.ndarray:
    return np.array([[int(h[i:i + 2], 16) for i in (0, 2, 4)] for h in hex_colours], np.float64)


def colormap(values: np.ndarray, name: str = "inferno") -> np.ndarray:
    """(H, W) values → (H, W, 3) uint8. `inferno` and `gray` scale the
    values' range to [0, 1] (a constant map takes the low end); `tab10`
    takes integer labels, modulo 10, as matplotlib's listed map does for
    labels 0-9."""
    values = np.asarray(values, dtype=np.float64)
    if name == "tab10":
        return _rgb(TAB10)[values.astype(np.int64) % 10].astype(np.uint8)
    if name not in _STOPS:
        raise ValueError(f"colormap {name!r}: inferno, gray or tab10")
    lo, hi = values.min(), values.max()
    x = (values - lo) / (hi - lo) if hi > lo else np.zeros_like(values)
    stops = _rgb(_STOPS[name])
    pos = x * (len(stops) - 1)
    i = np.clip(np.floor(pos).astype(np.int64), 0, len(stops) - 2)
    f = (pos - i)[..., None]
    return np.round(stops[i] * (1 - f) + stops[i + 1] * f).astype(np.uint8)


def trace_image(series: Sequence[np.ndarray], height: int = 300, width: int = 1000) -> np.ndarray:
    """Polyline traces of 1-D series on a white (height, width, 3) canvas,
    all on one y scale, each series stretched over the width (linear between
    samples), in tab10's colours; each column is filled from its row to the
    next column's."""
    img = np.full((height, width, 3), 255, np.uint8)
    colours = _rgb(TAB10).astype(np.uint8)
    ys = [np.asarray(s, dtype=np.float64) for s in series]
    lo = min(y.min() for y in ys)
    hi = max(y.max() for y in ys)
    scale = (height - 1) / (hi - lo) if hi > lo else 0.0
    cols = np.arange(width)
    for n, y in enumerate(ys):
        yx = np.interp(cols, np.linspace(0, width - 1, len(y)), y)
        rows = np.round((hi - yx) * scale).astype(np.int64)
        nxt = np.append(rows[1:], rows[-1])
        for x in cols:
            img[min(rows[x], nxt[x]):max(rows[x], nxt[x]) + 1, x] = colours[n % len(colours)]
    return img


def tab20c_colours(n: int) -> np.ndarray:
    """(n, 3) uint8: matplotlib's `get_cmap("tab20c", n)` — tab20c's 20
    colours sampled at n even stops — for labels 0..n-1."""
    stops = np.linspace(0.0, 1.0, n) * len(TAB20C)
    idx = np.minimum(stops.astype(np.int64), len(TAB20C) - 1)
    return _rgb(TAB20C)[idx].astype(np.uint8)


def scatter3d_image(points: np.ndarray, colours: np.ndarray) -> np.ndarray:
    """Points (N, 3) seen orthographically from GetTsneForRawEEG.py's view
    (view_init(azim=50, elev=40), matplotlib's convention), each axis scaled
    to [-1, 1] first as a 3-D axes box does, drawn far to near as discs of
    3 pixels in their (N, 3) uint8 colours at alpha 0.8 on white →
    (900, 1200, 3) uint8. No axes, labels or legend."""
    height, width, radius, alpha = 900, 1200, 3, 0.8
    p = np.asarray(points, dtype=np.float64)
    lo, hi = p.min(axis=0), p.max(axis=0)
    p = 2.0 * (p - lo) / np.where(hi > lo, hi - lo, 1.0) - 1.0
    az, el = np.radians(50.0), np.radians(40.0)
    u = -np.sin(az) * p[:, 0] + np.cos(az) * p[:, 1]
    v = (-np.sin(el) * np.cos(az) * p[:, 0] - np.sin(el) * np.sin(az) * p[:, 1]
         + np.cos(el) * p[:, 2])
    depth = np.cos(el) * np.cos(az) * p[:, 0] + np.cos(el) * np.sin(az) * p[:, 1] \
        + np.sin(el) * p[:, 2]
    scale = 0.45 * min(height, width) / np.sqrt(3.0)  # the box's diagonal fits
    cx = np.round(width / 2 + scale * u).astype(np.int64)
    cy = np.round(height / 2 - scale * v).astype(np.int64)
    img = np.full((height, width, 3), 255.0)
    dy, dx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disc = dy ** 2 + dx ** 2 <= radius ** 2
    dy, dx = dy[disc], dx[disc]
    colours = np.asarray(colours, dtype=np.float64)
    for i in np.argsort(depth):  # far to near: nearer discs paint over
        ys, xs = cy[i] + dy, cx[i] + dx
        ok = (ys >= 0) & (ys < height) & (xs >= 0) & (xs < width)
        img[ys[ok], xs[ok]] = (1.0 - alpha) * img[ys[ok], xs[ok]] + alpha * colours[i]
    return np.round(img).astype(np.uint8)


def write_png(path: str, rgb: np.ndarray) -> str:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG → path."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"rgb must be (H, W, 3), got {rgb.shape}")
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], 1)  # filter 0

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))
    return path


def plot_sample_eeg_channels(
    eeg_data: np.ndarray,
    channels_to_plot: Sequence[int],
    save_figure: bool = False,
    save_figure_name: Optional[str] = None,
) -> np.ndarray:
    """eeg_data: (B, T, C): the traces of eeg_data[0][:, chn] for each
    channel, one tab10 colour each (utils/Utilities.py:451-475) → the
    (300, 1000, 3) image, written as a PNG when asked."""
    eeg0 = np.asarray(eeg_data[0])
    img = trace_image([eeg0[:, int(chn)] for chn in channels_to_plot])
    if save_figure and save_figure_name:
        write_png(save_figure_name, img)
    return img
