"""Denoising (utils/Utilities.py:411-448; port of cerebra/signal/denoise.py).

- `remove_noise`: 4th-order Butterworth 1–50 Hz zero-phase band-pass over
  (..., T, C): the exact `filtfilt`, two `sos_scan` launches on a CUDA
  tensor, in place of the reference's per-(sample, channel) scipy loop.
- `remove_noise_with_ica`: the reference fits sklearn FastICA(n,
  whiten="unit-variance") to each trial and maps the sources back. That
  fit_transform → inverse_transform chain is the orthogonal projection of
  the centred trial onto its top n principal directions, plus the mean:
  the ICA rotation cancels (components_ᵀ pinv(components_)ᵀ is the
  projection onto their row space, the whitening's PCA subspace). Here it
  is that projection, by one batched SVD on the tensor's device: the same
  function, deterministic, without scikit-learn.
"""

from __future__ import annotations

import torch

from cerebra_torch.signal.filters import design_bandpass, filtfilt


def remove_noise(eeg_data: torch.Tensor, sampling_rate: float) -> torch.Tensor:
    """utils/Utilities.py:411-428: Butterworth(4) 1–50 Hz filtfilt over
    (..., T, C), every (trial, channel) lane at once."""
    spec = design_bandpass(1.0, 50.0, fs=sampling_rate, order=4)
    x = torch.as_tensor(eeg_data).transpose(-1, -2)  # (..., C, T)
    return filtfilt(spec, x).transpose(-1, -2)


def remove_noise_with_ica(eeg_data: torch.Tensor, n_components: int = 20) -> torch.Tensor:
    """utils/Utilities.py:430-448: each trial of (N, T, C) rebuilt from its
    n-component ICA, i.e. (X − mean)·V_nᵀV_n + mean with V_n the top n right
    singular vectors of the centred trial → (N, T, C)."""
    x = torch.as_tensor(eeg_data)
    mean = x.mean(dim=-2, keepdim=True)
    xc = x - mean
    vh = torch.linalg.svd(xc, full_matrices=False).Vh[..., :n_components, :]  # (N, n, C)
    return (xc @ vh.transpose(-1, -2)) @ vh + mean
