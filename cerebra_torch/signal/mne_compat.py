"""MNE helper parity (utils/MNE_Utils.py:5-60; port of
cerebra/signal/mne_compat.py): RawArray creation, band filtering, montage
assignment.

MNE is an optional host-side dependency, imported only when called: with it
these helpers return real `mne.io.Raw` objects as the reference does;
without it the data-shaping parts return a `RawBundle` with the same array
and info, filtered on `device` by the port's exact zero-phase band-pass,
and montage assignment reports unavailable. The Welch band powers of
MNE_Utils (`checkFrequencies`, :63-95) are in cerebra_torch.signal.psd.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch


def _mne():
    try:
        import mne

        return mne
    except ImportError:
        return None


@dataclasses.dataclass
class RawBundle:
    """Numpy stand-in for mne.io.Raw: continuous (C, N·T) data + info."""

    data: np.ndarray  # (C, total_samples)
    channel_names: List[str]
    channel_types: List[str]
    sampling_freq: float

    def get_data(self) -> np.ndarray:
        return self.data


def create_info(channel_names: Sequence[str], channel_types: Sequence[str],
                sampling_freq: float = 1000.0):
    """`createInfoForDataset` (utils/MNE_Utils.py:9-10)."""
    mne = _mne()
    if mne is not None:
        return mne.create_info(ch_names=list(channel_names),
                               ch_types=list(channel_types), sfreq=sampling_freq)
    return {"ch_names": list(channel_names), "ch_types": list(channel_types),
            "sfreq": sampling_freq}


def create_raw_data(eeg_features: np.ndarray, channel_names: Sequence[str],
                    channel_types: Sequence[str], sampling_freq: float = 1000.0):
    """`create_RAW_data` (utils/MNE_Utils.py:12-29): per-trial (T, C) epochs
    stacked into one continuous channels × time recording → mne.io.Raw (mne
    installed) or a RawBundle with the same data."""
    eeg_features = np.asarray(eeg_features)
    n = eeg_features.shape[0]
    mne = _mne()
    if mne is not None:
        info = create_info(channel_names, channel_types, sampling_freq)
        raws = [mne.io.RawArray(eeg_features[i].T, info, verbose="ERROR") for i in range(n)]
        return mne.io.concatenate_raws(raws)
    continuous = np.concatenate([eeg_features[i].T for i in range(n)], axis=1)  # (C, n·T)
    return RawBundle(continuous, list(channel_names), list(channel_types), sampling_freq)


def filter_frequency_bands(raw, l_freq: float, h_freq: float,
                           sampling_freq: float = 1000.0, device="cuda"):
    """`filter_frequency_bands` (utils/MNE_Utils.py:33-60): band-pass the
    recording and try every built-in montage until one fits.

    Without mne (or for a RawBundle) the recording is band-passed on
    `device` with the exact 4th-order Butterworth filtfilt, twice, as the
    reference filters twice (filter_data at MNE_Utils.py:44, then .filter()
    on the copy at :49), and comes back as a RawBundle (no montage)."""
    mne = _mne()
    if mne is not None and not isinstance(raw, RawBundle):
        from mne.filter import filter_data

        filtered = filter_data(raw.get_data(), sampling_freq, l_freq=l_freq,
                               h_freq=h_freq, verbose="ERROR")
        out = mne.io.RawArray(filtered, raw.info, verbose="ERROR")
        filt_raw = out.copy().filter(l_freq=l_freq, h_freq=h_freq, verbose="ERROR")
        for name in mne.channels.get_builtin_montages():
            try:
                filt_raw.set_montage(mne.channels.make_standard_montage(kind=name))
                break
            except Exception:  # a montage that does not fit the channels: try the next
                continue
        return filt_raw

    from cerebra_torch.signal.filters import design_bandpass, filtfilt

    spec = design_bandpass(l_freq, h_freq, fs=sampling_freq, order=4)
    filtered = torch.as_tensor(np.asarray(raw.get_data(), np.float32), device=device)
    for _ in range(2):
        filtered = filtfilt(spec, filtered)
    return RawBundle(filtered.cpu().numpy(), list(raw.channel_names),
                     list(raw.channel_types), raw.sampling_freq)


def montage_available() -> bool:
    return _mne() is not None
