"""brain_map: channel × time clustering (port of cerebra/cli/brain_map.py;
the reference's BrainMapExperiment.ipynb): class-conditional power per
(channel, time bin), PCA with whitening, KMeans, rendered as a channel ×
time cluster map. The power features are computed on `--device`; the PCA
(numpy f64, as the JAX package) and the port's own KMeans
(eval/metrics.py::kmeans, in place of scikit-learn's) on the host."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from cerebra_torch.cli.common import load_corpus, reference_argparser, resolve_device
from cerebra_torch.eval.metrics import PCA, kmeans
from cerebra_torch.utils.plotting import colormap, write_png


def power_features(eeg: torch.Tensor, labels: np.ndarray, n_bins: int) -> np.ndarray:
    """(N, T, C) EEG → (C·n_bins, n_present_classes) f32: each class's mean
    power per channel, averaged over each of n_bins near-equal time bins
    (`np.array_split`)."""
    T = eeg.shape[1]
    bins = np.array_split(np.arange(T), n_bins)
    cols = []
    for cls in np.unique(labels):
        block = eeg[torch.from_numpy(np.flatnonzero(labels == cls)).to(eeg.device)]
        power = (block * block).mean(0)  # (T, C)
        cols.append(torch.stack([power[int(b[0]):int(b[-1]) + 1].mean(0) for b in bins], 1))
    return torch.stack(cols, -1).reshape(-1, len(cols)).cpu().numpy()  # (C, n_bins, n) flat


def main(argv=None):
    parser = reference_argparser("Channel×time PCA/KMeans brain map")
    parser.add_argument("--n_time_bins", type=int, default=20)
    parser.add_argument("--n_clusters", type=int, default=5)
    parser.add_argument("--pca_dim", type=int, default=8)
    FLAGS, _ = parser.parse_known_args(argv)
    device = resolve_device(FLAGS)
    os.makedirs(FLAGS.log_dir, exist_ok=True)

    corpus = load_corpus(FLAGS)
    N, T, C = corpus.eeg.shape
    n_bins = min(FLAGS.n_time_bins, T)  # no empty (NaN) bins
    flat = power_features(torch.from_numpy(np.ascontiguousarray(corpus.eeg)).to(device),
                          corpus.labels, n_bins)
    dim = min(FLAGS.pca_dim, flat.shape[1])
    reduced = PCA(dim=dim, whit=0.5).fit(flat).apply(flat) if dim < flat.shape[1] else flat
    labels, _, _ = kmeans(reduced, FLAGS.n_clusters,
                          generator=torch.Generator().manual_seed(FLAGS.seed))
    grid = labels.reshape(C, n_bins)

    # one row of cells a channel, 8 px a cell
    out_png = write_png(os.path.join(FLAGS.log_dir, "brain_map.png"),
                        colormap(np.kron(grid, np.ones((8, 8), np.int64)), "tab10"))
    with open(os.path.join(FLAGS.log_dir, "brain_map.json"), "w") as f:
        json.dump({"clusters": grid.tolist()}, f)
    print(f"wrote {out_png}")
    return grid


if __name__ == "__main__":
    main()
