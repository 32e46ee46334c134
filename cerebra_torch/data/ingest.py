"""BDF → .pth ingest (reference ConvertToPth.py:47-201; port of
cerebra/data/ingest.py), MNE-free.

1. read the BDF: the native C++ reader where it builds, else the numpy one;
2. re-reference to the mean of channels 96/97 0-based (ConvertToPth.py:75);
3. resample ×downsample_ratio (4096 → 2048 Hz, :79-81) with
   scipy.signal.resample_poly on the host;
4. events from the full-rate Status channel (rising edges to STATUS_EVENT =
   65280) mapped to the resampled rate, the first one dropped (:87-96);
5. optional zero-phase band-pass 14–71 Hz and 60 Hz notch (:106-111) on
   `device`, the whole recording at once: `filtfilt_fft`, or the exact
   `filtfilt` (the `sos_scan` kernel on a CUDA device) when
   use_device_filters is False;
6. drop EXG*/Status channels (:114-119);
7. slice Sampling/4 = 512-sample epochs from each event (:124-133);
8. global per-channel mean/std (:140-141);
9. labels from image.pkl + the stimulus sequence file (:148-166);
10. write the reference .pth dict (:170-201) with save_corpus_pth.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cerebra_torch.data import native_bdf
from cerebra_torch.data.bdf import read_raw_bdf
from cerebra_torch.data.schema import RawCorpus, save_corpus_pth

_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
IMAGE_CLASS_MAPPINGS = os.path.join(_ASSETS, "image.pkl")
IMAGE_BLOCK_SEQUENCE = os.path.join(_ASSETS, "image-block.txt")
IMAGE_RAPID_SEQUENCE = os.path.join(_ASSETS, "image-rapid-event.txt")

STATUS_EVENT = 65280  # ConvertToPth.py:38
DEFAULT_BAD_CHANNELS = (
    "EXG1", "EXG2", "EXG3", "EXG4", "EXG5", "EXG6", "EXG7", "EXG8", "Status",
)


def find_status_events(status: np.ndarray, code: int = STATUS_EVENT) -> np.ndarray:
    """Sample indices where the status word rises to `code` (the MNE
    find_events equivalent after the reference's axis surgery)."""
    hits = status == code
    rising = hits & ~np.concatenate([[False], hits[:-1]])
    return np.nonzero(rising)[0]


def load_stimulus_labels(
    sequence_file: str, mappings_file: str = IMAGE_CLASS_MAPPINGS
) -> Tuple[List[str], List[int], List[str]]:
    """(image_names, class_ids, wnids) from the presentation sequence +
    name→class pickle (ConvertToPth.py:148-166)."""
    with open(mappings_file, "rb") as f:
        image_class_mappings = pickle.load(f)
    wnid_to_class: dict = {}
    for key, val in image_class_mappings.items():
        wnid_to_class.setdefault(key.split("_")[0], val)
    names, classes = [], []
    with open(sequence_file) as f:
        for line in f:
            name = line.strip().split(".")[0]
            if not name:
                continue
            names.append(name)
            classes.append(int(image_class_mappings[name]))
    return names, classes, list(wnid_to_class.keys())


def convert_bdf_to_pth(
    bdf_path: str,
    out_path: str,
    subject: int,
    sequence_file: str = IMAGE_RAPID_SEQUENCE,
    mappings_file: str = IMAGE_CLASS_MAPPINGS,
    reference_channels: Sequence[int] = (96, 97),
    downsample_ratio: float = 0.5,
    down_ratio_for_timesamples: int = 4,
    apply_bandpass: bool = True,
    band: Tuple[float, float] = (14.0, 71.0),
    apply_notch: bool = False,
    notch_freq: float = 60.0,
    bad_channels: Sequence[str] = DEFAULT_BAD_CHANNELS,
    expected_samples: Optional[int] = None,
    use_device_filters: bool = True,
    device="cuda",
    stage_seconds: Optional[Dict[str, float]] = None,
) -> RawCorpus:
    """Full ingest; writes `out_path` and returns the RawCorpus. The filters
    run on `device`; `stage_seconds`, when given, receives the wall seconds
    of each stage (read, resample, filter, epochs, write)."""
    from scipy.signal import resample_poly

    from cerebra_torch.signal.filters import (
        bandpass_notch_pipeline,
        design_notch,
        filtfilt,
        filtfilt_fft,
    )

    clock = {"t": time.perf_counter()}

    def stage(name: str) -> None:
        now = time.perf_counter()
        if stage_seconds is not None:
            stage_seconds[name] = now - clock["t"]
        clock["t"] = now

    # the native reader is bit-identical to the numpy one; a decode error
    # raises rather than falling back
    bdf = native_bdf.read_raw_bdf(bdf_path) if native_bdf.available() else read_raw_bdf(bdf_path)
    sig = bdf.signals
    names = bdf.channel_names
    stage("read")

    # 2) re-reference (average of the two reference electrodes)
    if max(reference_channels) >= sig.shape[0]:
        raise ValueError(
            f"reference channels {tuple(reference_channels)} out of range for a "
            f"{sig.shape[0]}-channel recording — pass indices valid for this rig "
            f"(the 96,97 default is the 128-channel BioSemi layout)"
        )
    ref = sig[list(reference_channels)].mean(axis=0, keepdims=True)
    eeg_rows = [i for i, n in enumerate(names) if not n.lower().startswith("status")]
    sig = sig.copy()
    sig[eeg_rows] -= ref

    # 3) resample; the rate is what resample_poly's up/down really give
    up, down = (1, int(round(1 / downsample_ratio))) if downsample_ratio < 1 else (
        int(round(downsample_ratio)), 1,
    )
    sampling = bdf.sample_rate * up / down
    sig = resample_poly(sig, up, down, axis=-1).astype(np.float32)
    epoch_len = int(sampling) // down_ratio_for_timesamples  # 2048/4 → 512

    # 4) events on the raw full-rate status word, mapped to resampled
    # indices; the reference drops the first (the session-start trigger)
    events = (find_status_events(bdf.status) * up) // down
    events = events[events < sig.shape[1]]
    if len(events) > 0:
        events = events[1:]
    stage("resample")

    # 5) filters on the device, the whole recording in one call
    if apply_bandpass or apply_notch:
        x = torch.from_numpy(sig).to(device)
        if apply_bandpass:
            x = bandpass_notch_pipeline(
                x, sampling, band=band, notch=notch_freq if apply_notch else None,
                order=4, use_fft=use_device_filters,
            )
        else:  # notch only
            apply_fn = filtfilt_fft if use_device_filters else filtfilt
            x = apply_fn(design_notch(notch_freq, fs=sampling), x)
        sig = x.cpu().numpy().astype(np.float32, copy=False)
    stage("filter")

    # 6) drop EXG/Status channels
    bad = set(bad_channels)
    keep = [i for i, n in enumerate(names) if n not in bad]
    sig = sig[keep]

    # 7) epoch slicing
    names_list, classes, wnids = load_stimulus_labels(sequence_file, mappings_file)
    n_expected = expected_samples if expected_samples is not None else len(names_list)
    C = sig.shape[0]
    eeg = np.zeros((n_expected, C, epoch_len), dtype=np.float32)
    added = 0
    for i, ev in enumerate(events[:n_expected]):
        seg = sig[:, ev:ev + epoch_len]
        eeg[i, :, :seg.shape[1]] = seg
        added += 1
    if added != n_expected:
        raise ValueError(f"expected {n_expected} stimulus events, found {added}")

    # 8) global per-channel stats (over all epochs × time, ConvertToPth:140)
    flat = eeg.transpose(0, 2, 1).reshape(-1, C)
    means = flat.mean(axis=0).astype(np.float32)
    stds = flat.std(axis=0).astype(np.float32)
    stage("epochs")

    raw = RawCorpus(
        eeg=eeg,
        labels=np.asarray(classes[:n_expected], dtype=np.int32),
        image_idx=np.arange(n_expected, dtype=np.int32),
        subjects=np.full(n_expected, subject, dtype=np.int32),
        wnids=wnids,
        image_names=names_list[:n_expected],
        means=means,
        stddevs=stds,
    )
    save_corpus_pth(out_path, raw)
    stage("write")
    return raw
