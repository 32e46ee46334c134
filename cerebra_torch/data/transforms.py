"""Corpus-level model transforms (port of cerebra/data/transforms.py): pure
versions of the reference's in-place dataset mutations (SURVEY.md §2.2).

Each reference `transformEEGData*` method mutated `subsetData[i]["eeg"]` in a
Python loop; here each is a batched forward of the port's own model on its
device, `batch_size` rows at a time under torch.no_grad(), returning a NEW
corpus or a feature bank (numpy, on the host):

| reference (utils/PerilsEEGDataset.py)   | here                      | kernels on a GPU |
|------------------------------------------|---------------------------|------------------|
| transformEEGDataLSTM / ...ByList (:308) | lstm_features             | K3 |
| transformEEGData (ResNet→EEG, :344)     | image_regressor_to_eeg    | — |
| transformEEGDataAE (:377)               | autoencoder_reconstruct   | K4 (recurrent) |
| transformEEGDataDino (:410)             | dino_features             | K5/K7 |
| transformToEEGNoisyData (:149)          | noise_replace             | — |

The models hold their weights: they take no `params` argument, and run in
whatever train/eval mode the caller set; a model whose forward takes
`train` (the FC autoencoder's dropout) is called with train=False.
Randomness comes from an explicit torch.Generator (or DINO's starts).
"""

from __future__ import annotations

import inspect
from typing import Callable, Optional

import numpy as np
import torch

from cerebra_torch.data.corpus import EEGCorpus


def _device(model) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def _batched(fn: Callable, x: np.ndarray, batch_size: int, device) -> np.ndarray:
    outs = []
    for start in range(0, x.shape[0], batch_size):
        xb = torch.as_tensor(np.asarray(x[start:start + batch_size]), device=device)
        outs.append(fn(xb).float().cpu().numpy())
    return np.concatenate(outs, axis=0)


def lstm_features(corpus: EEGCorpus, model, batch_size: int = 256,
                  features_only: bool = False) -> np.ndarray:
    """(N, F) LSTM feature bank (transformEEGDataLSTMByList, corpus-indexed
    labels — the reference's batch-local label bug §7.5 fixed)."""
    def run(x):
        out = model(x, features_only=features_only)
        return out[0] if isinstance(out, tuple) else out

    return _batched(run, corpus.eeg, batch_size, _device(model))


def autoencoder_reconstruct(corpus: EEGCorpus, model, batch_size: int = 256) -> EEGCorpus:
    """Replace the corpus EEG with its autoencoder reconstruction
    (transformEEGDataAE): the FC, Conv or recurrent autoencoder."""
    kwargs = {"train": False} if "train" in inspect.signature(model.forward).parameters else {}

    def run(x):
        out = model(x, **kwargs)
        dec = out[1] if isinstance(out, tuple) else out
        return dec.reshape(x.shape)

    return corpus.with_eeg(_batched(run, corpus.eeg, batch_size, _device(model)))


def image_regressor_to_eeg(corpus: EEGCorpus, image_features: np.ndarray, regressor,
                           batch_size: int = 256) -> EEGCorpus:
    """Image features → regressed pseudo-EEG replacing the corpus EEG
    (transformEEGData with CustomModel/ResnetFeatureRegressor)."""
    out = _batched(regressor, np.asarray(image_features, np.float32), batch_size,
                   _device(regressor))
    return corpus.with_eeg(out.reshape(corpus.n, corpus.n_samples, corpus.n_channels))


def dino_features(corpus: EEGCorpus, dino_model, starts: Optional[np.ndarray] = None,
                  generator: Optional[torch.Generator] = None,
                  batch_size: int = 64) -> np.ndarray:
    """(N, F) DINO features of tiled EEG-images (transformEEGDataDino
    pass_eeg=True, keep_features_flat=True). `starts` (N,) are the images'
    column-window starts, drawn from `generator` batch by batch when None."""
    feats = []
    for start in range(0, corpus.n, batch_size):
        eeg = torch.as_tensor(corpus.eeg[start:start + batch_size])
        s = None if starts is None else torch.as_tensor(starts[start:start + batch_size])
        feats.append(dino_model.features_from_eeg(eeg, s, generator).float().cpu().numpy())
    return np.concatenate(feats, axis=0)


def noise_replace(corpus: EEGCorpus, generator: Optional[torch.Generator] = None) -> EEGCorpus:
    """Null-hypothesis corpus: EEG replaced by synthetic noise
    (transformToEEGNoisyData)."""
    from cerebra_torch.data.synthetic import synthetic_eeg_noise

    noise = synthetic_eeg_noise(corpus.n, corpus.n_channels, corpus.n_samples,
                                generator=generator)  # (N, C, T)
    return corpus.with_eeg(noise.transpose(1, 2).numpy())
