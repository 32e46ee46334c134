"""Gaussian-noise control images (port of cerebra/data/gauss_noise.py;
utils/GaussNoise.py:4-50): fit a multivariate-Gaussian prior over images and
sample noise images from it, the null-hypothesis image backend. Host numpy,
the same code as the JAX package's, so the same generator gives the same
images."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class GaussNoiseGenerator:
    """Low-rank sampler: for 224×224×3 images the full 150528² covariance of
    the reference (utils/GaussNoise.py:47-49) cannot be held; the top-k
    eigenpairs of the empirical covariance are kept (exact when
    n_images ≤ k) and x = μ + V √λ z is sampled."""

    def __init__(self, rank: int = 64):
        self.rank = rank
        self.mean: Optional[np.ndarray] = None
        self.basis: Optional[np.ndarray] = None  # (D, rank) V·√λ

    def fit(self, images: np.ndarray) -> "GaussNoiseGenerator":
        """images: (N, H, W, C) floats, flattened per image."""
        n = images.shape[0]
        flat = images.reshape(n, -1).astype(np.float64)
        self.mean = flat.mean(axis=0)
        centered = flat - self.mean
        # dual trick: eig of the (N, N) Gram instead of the (D, D) covariance
        gram = centered @ centered.T / max(n - 1, 1)
        d, u = np.linalg.eigh(gram)
        idx = np.argsort(d)[::-1][: min(self.rank, n)]
        d, u = np.maximum(d[idx], 0.0), u[:, idx]
        v = centered.T @ u  # (D, k), unnormalised
        norms = np.linalg.norm(v, axis=0)
        v = v / np.maximum(norms, 1e-12)
        self.basis = v * np.sqrt(d)
        return self

    def sample(self, rng: np.random.Generator,
               shape: Tuple[int, int, int] = (224, 224, 3)) -> np.ndarray:
        """One noise image from `rng`, min-max normalised to [0, 255] uint8
        like cv2.normalize(..., NORM_MINMAX) (utils/GaussNoise.py:20)."""
        z = rng.standard_normal(self.basis.shape[1])
        x = (self.mean + self.basis @ z).reshape(shape)
        lo, hi = x.min(), x.max()
        x = (x - lo) / max(hi - lo, 1e-12) * 255.0
        return x.astype(np.uint8)
