"""Pure-numpy BioSemi BDF reader and writer (copy of cerebra/data/bdf.py) —
replaces mne.io.read_raw_bdf for ingest.

BDF is EDF with 24-bit samples (https://www.biosemi.com/faq/file_format.htm):
- 256-byte main header (id byte 0xFF + "BIOSEMI", patient/recording ids,
  start date/time, header length, n_records, record duration, n_channels);
- 256 bytes per channel of per-channel fields (label, transducer, unit,
  physical/digital min/max, prefiltering, samples-per-record);
- data: records × channels × samples_per_record little-endian signed 24-bit.

Values map to physical units by the spec's affine transform:
physical = (dig − dig_min) · (phys_max−phys_min)/(dig_max−dig_min) + phys_min.
The Status channel's raw 24-bit word carries the trigger in its low 16 bits.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class BDFData:
    signals: np.ndarray  # (C, T) float32, physical units
    channel_names: List[str]
    sample_rate: float
    status: np.ndarray  # (T,) int32 raw status words (0 if no Status channel)


def _field(buf: bytes, start: int, length: int) -> str:
    return buf[start : start + length].decode("ascii", errors="replace").strip()


def read_raw_bdf(path: str) -> BDFData:
    with open(path, "rb") as f:
        header = f.read(256)
        if header[0] != 0xFF or _field(header, 1, 7) != "BIOSEMI":
            raise ValueError(f"not a BDF file: {path!r}")
        n_records = int(_field(header, 236, 8))
        record_dur = float(_field(header, 244, 8))
        n_channels = int(_field(header, 252, 4))

        ch_hdr = f.read(256 * n_channels)

        def ch_fields(offset: int, width: int):
            base = offset * n_channels
            return [_field(ch_hdr, base + i * width, width) for i in range(n_channels)]

        labels = ch_fields(0, 16)
        phys_min = np.array([float(v) for v in ch_fields(16 + 80 + 8, 8)])
        phys_max = np.array([float(v) for v in ch_fields(16 + 80 + 8 + 8, 8)])
        dig_min = np.array([float(v) for v in ch_fields(16 + 80 + 8 + 16, 8)])
        dig_max = np.array([float(v) for v in ch_fields(16 + 80 + 8 + 24, 8)])
        n_samp = np.array(
            [int(v) for v in ch_fields(16 + 80 + 8 + 32 + 80, 8)]
        )
        if len(set(n_samp.tolist())) != 1:
            raise ValueError("variable per-channel sampling rates not supported")
        spr = int(n_samp[0])
        sample_rate = spr / record_dur

        raw = np.frombuffer(f.read(), dtype=np.uint8)

    bytes_per_record = 3 * spr * n_channels
    if n_records <= 0:  # unknown record count (-1): infer from file size
        n_records = len(raw) // bytes_per_record
    raw = raw[: n_records * bytes_per_record].reshape(n_records, n_channels, spr, 3)
    # little-endian signed 24-bit → int32
    vals = (
        raw[..., 0].astype(np.int32)
        | (raw[..., 1].astype(np.int32) << 8)
        | (raw[..., 2].astype(np.int32) << 16)
    )
    vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
    data = np.transpose(vals, (1, 0, 2)).reshape(n_channels, n_records * spr)

    # EDF/BDF spec: physical = (dig - dig_min) * gain + phys_min with
    # gain = (phys_max - phys_min) / (dig_max - dig_min). The affine offset
    # matters for any asymmetric phys/dig range, and dig_min > dig_max (the
    # EDF sign-flip convention) yields a legitimately NEGATIVE gain — do not
    # clamp the denominator. Degenerate dig ranges fall back to gain 1/no
    # offset (mne's cal fallback).
    denom = dig_max - dig_min
    safe = np.where(denom != 0, denom, 1.0)
    gain = np.where(denom != 0, (phys_max - phys_min) / safe, 1.0)
    offset = np.where(denom != 0, phys_min - dig_min * gain, 0.0)
    signals = (data * gain[:, None] + offset[:, None]).astype(np.float32)

    status = np.zeros(data.shape[1], dtype=np.int32)
    for i, lab in enumerate(labels):
        if lab.lower().startswith("status"):
            status = data[i] & 0xFFFF  # trigger word in low 16 bits
            break
    return BDFData(
        signals=signals, channel_names=labels, sample_rate=sample_rate, status=status
    )


def write_raw_bdf(
    path: str,
    signals: np.ndarray,  # (C, T) physical units
    channel_names: List[str],
    sample_rate: float,
    status: np.ndarray | None = None,
    phys_range: float = 262144.0,
) -> None:
    """Minimal BDF writer (test fixtures / round-trip validation)."""
    C, T = signals.shape
    names = list(channel_names)
    data = [signals]
    if status is not None:
        names.append("Status")
        data.append(status.reshape(1, -1).astype(np.float32))
        C += 1
    full = np.concatenate(data, axis=0)
    spr = int(sample_rate)
    n_records = int(np.ceil(T / spr))
    pad = n_records * spr - T
    if pad:
        full = np.pad(full, ((0, 0), (0, pad)))

    dig_rng = 1 << 23
    # exact inverse of the reader's affine map for the declared ranges
    # phys [-P, P], dig [-D, D-1]: gain = 2P/(2D-1), offset = -P + D*gain
    gain = (2.0 * phys_range) / (2 * dig_rng - 1)
    offset = -phys_range + dig_rng * gain

    def pad_field(s: str, width: int) -> bytes:
        return s[:width].ljust(width).encode("ascii")

    hdr = bytearray()
    hdr += bytes([0xFF]) + pad_field("BIOSEMI", 7)
    hdr += pad_field("local patient", 80) + pad_field("local recording", 80)
    hdr += pad_field("01.01.20", 8) + pad_field("00.00.00", 8)
    hdr += pad_field(str(256 * (1 + C)), 8)
    hdr += pad_field("24BIT", 44)
    hdr += pad_field(str(n_records), 8) + pad_field("1", 8) + pad_field(str(C), 4)

    def all_ch(fmt_fn, width):
        return b"".join(pad_field(fmt_fn(i), width) for i in range(C))

    hdr += all_ch(lambda i: names[i], 16)
    hdr += all_ch(lambda i: "transducer", 80)
    hdr += all_ch(lambda i: "uV", 8)
    hdr += all_ch(lambda i: str(-phys_range), 8)
    hdr += all_ch(lambda i: str(phys_range), 8)
    hdr += all_ch(lambda i: str(-dig_rng), 8)
    hdr += all_ch(lambda i: str(dig_rng - 1), 8)
    hdr += all_ch(lambda i: "none", 80)
    hdr += all_ch(lambda i: str(spr), 8)
    hdr += all_ch(lambda i: "", 32)

    dig = np.clip(np.round((full - offset) / gain), -dig_rng, dig_rng - 1).astype(
        np.int32
    )
    if status is not None:
        dig[-1] = np.clip(
            np.pad(status.astype(np.int64), (0, pad)), 0, (1 << 23) - 1
        ).astype(np.int32)
    dig_u = (dig & 0xFFFFFF).astype(np.uint32)
    records = dig_u.reshape(C, n_records, spr).transpose(1, 0, 2)
    b0 = (records & 0xFF).astype(np.uint8)
    b1 = ((records >> 8) & 0xFF).astype(np.uint8)
    b2 = ((records >> 16) & 0xFF).astype(np.uint8)
    packed = np.stack([b0, b1, b2], axis=-1)
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(packed.tobytes())
