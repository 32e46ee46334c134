"""Synthetic EEG: labelled corpora, the data backend that needs no files
(copy of cerebra/data/synthetic.py::make_synthetic_corpus, pure numpy, so a
seed gives the same arrays bit for bit as the JAX package), and the
reference's null-hypothesis noise (`synthetic_eeg_noise`, drawn from a
torch.Generator where JAX draws from a key: the same seed gives other
numbers)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cerebra_torch.data.corpus import EEGCorpus
from cerebra_torch.data.schema import LabelCatalog, RawCorpus


def synthetic_eeg_noise(
    num_trials: int,
    num_channels: int = 128,
    num_samples: int = 500,
    sampling_rate: float = 1000.0,
    frequency: float = 40.0,
    amplitude: float = 0.5,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Gaussian noise + 40 Hz sinusoid, (num_trials, C, T) float32: the
    generator of utils/PerilsEEGDataset.py:140-147 (per-channel N(0, 1) noise
    plus a shared `amplitude*sin(2π f t)` oscillation), on the generator's
    device."""
    noise = torch.randn(num_trials, num_channels, num_samples, generator=generator,
                        device=generator.device if generator is not None else "cpu")
    t = torch.arange(num_samples, device=noise.device) / sampling_rate
    return noise + amplitude * torch.sin(2.0 * np.pi * frequency * t)


def make_synthetic_corpus(
    seed: int = 0,
    n_per_class: int = 6,
    n_classes: int = 8,
    n_channels: int = 96,
    n_samples: int = 512,
    n_subjects: int = 1,
    feature_dim: Optional[int] = None,
    class_signal_scale: float = 1.0,
) -> EEGCorpus:
    """A labeled synthetic corpus with a recoverable class structure.

    Each class gets a distinct sinusoid frequency/phase signature added to the
    noise so retrieval/learning has signal to find; when `feature_dim` is
    set, a per-class mean + noise feature bank stands in for DINOv2 teacher
    features.
    """
    rng = np.random.default_rng(seed)
    n = n_per_class * n_classes
    labels = np.repeat(np.arange(n_classes), n_per_class).astype(np.int32)
    t = np.arange(n_samples) / 1000.0
    freqs = rng.uniform(5.0, 45.0, size=n_classes)
    phases = rng.uniform(0.0, 2 * np.pi, size=(n_classes, n_channels))
    eeg = rng.normal(0.0, 1.0, size=(n, n_channels, n_samples)).astype(np.float32)
    # each class's signature once, added to its trials: the same f32 sums as
    # the JAX package's loop over trials
    sig = np.sin(2 * np.pi * freqs[:, None, None] * t[None, None, :] + phases[:, :, None])
    eeg += class_signal_scale * sig.astype(np.float32)[labels]

    wnids = [f"n{10000000 + c:08d}" for c in range(n_classes)]
    image_names = [f"{wnids[labels[i]]}_{i:05d}" for i in range(n)]
    raw = RawCorpus(
        eeg=eeg,
        labels=labels,
        image_idx=np.arange(n, dtype=np.int32),
        subjects=rng.integers(1, n_subjects + 1, size=n).astype(np.int32),
        wnids=wnids,
        image_names=image_names,
        means=eeg.mean(axis=(0, 2)).astype(np.float32),
        stddevs=eeg.std(axis=(0, 2)).astype(np.float32),
    )
    corpus = EEGCorpus.from_raw(raw, LabelCatalog.synthetic(wnids))
    if feature_dim is not None:
        class_means = rng.normal(0.0, 1.0, size=(n_classes, feature_dim))
        feats = class_means[labels] + 0.1 * rng.normal(0.0, 1.0, size=(n, feature_dim))
        corpus = corpus.with_image_features(feats.astype(np.float32))
    return corpus
