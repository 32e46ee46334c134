"""Label-wise host helpers — the Utilities-class data-preparation surface
(copy of cerebra/data/labelwise.py, numpy on the host).

Reference behaviors replaced (utils/Utilities.py):

- `load_data_label_wise` (:225-247): class-keyed dict of image paths, raw
  EEG, and (optionally) model-predicted EEG, built one sample at a time with
  a per-sample GPU forward. Here the prediction is ONE batched call over the
  whole corpus (TPU-friendly), then regrouped.
- `prepareEEGData` (:249-265): label-wise dict → flat (features, labels)
  with optional numpy conversion and flattening.
- `PrepapreDataforVis` (:267-297): label-wise dict + flat eeg/labels + the
  last image_features, for the t-SNE/BrainMap notebooks.
- `CalcMean` (:299-329) / `CalcEEGMean` (:332-408): per-class image-channel
  and EEG-channel mean/std via psum/psum_sq accumulation (population
  variance). Vectorized reductions here — same numbers, no Python loop over
  samples.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from cerebra_torch.data.corpus import EEGCorpus, image_path


def load_data_label_wise(
    corpus: EEGCorpus,
    images_root: str = "",
    predict_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> Dict[int, Dict[str, list]]:
    """Class-keyed {"images", "eeg", "pred_eeg"} lists
    (utils/Utilities.py:225-247).

    `predict_fn` replaces the reference's per-sample
    `CustModel(model(image))` chain: it maps the corpus's (N, F)
    image-feature bank to (N, D) predictions in one batched call; entries
    are None without it (process_data_with_model=False)."""
    preds = None
    if predict_fn is not None:
        if corpus.image_features is None:
            raise ValueError("predict_fn requires corpus.image_features")
        preds = np.asarray(predict_fn(np.asarray(corpus.image_features)))
    out: Dict[int, Dict[str, list]] = {}
    for i in range(corpus.n):
        c = int(corpus.labels[i])
        slot = out.setdefault(c, {"images": [], "eeg": [], "pred_eeg": []})
        slot["images"].append(image_path(corpus, i, images_root) if images_root else
                              corpus.image_names[int(corpus.image_idx[i])])
        slot["eeg"].append(corpus.eeg[i])
        slot["pred_eeg"].append(None if preds is None else preds[i])
    return out


def prepare_eeg_data(
    label_wise_data: Dict[int, Dict[str, list]],
    convert_to_numpy: bool = True,
    flatten_eeg: bool = True,
    is_model_preprocessed: bool = False,
) -> Tuple[np.ndarray, List[int]]:
    """Label-wise dict → flat (features, labels)
    (prepareEEGData, utils/Utilities.py:249-265)."""
    feats, labels = [], []
    for label, data in label_wise_data.items():
        key = "pred_eeg" if is_model_preprocessed else "eeg"
        for eeg in data[key]:
            feats.append(eeg)
            labels.append(label)
    if convert_to_numpy:
        feats = np.array(feats, dtype=float)
    if flatten_eeg:
        feats = feats.reshape(feats.shape[0], -1)
    return feats, labels


def prepare_data_for_vis(
    corpus: EEGCorpus,
    convert_to_numpy: bool = True,
    images: Optional[np.ndarray] = None,
) -> Tuple[Dict[int, Dict[str, list]], np.ndarray, List[int], Optional[np.ndarray]]:
    """(label_wise_data, eeg_features, eeg_labels, last_image_features) for
    the visualization notebooks (PrepapreDataforVis,
    utils/Utilities.py:267-297). The fourth slot reproduces the reference's
    quirk of returning whatever `img_f` the LAST iterated sample carried.

    ``images``: optional per-sample pixel bank (N leading). The reference
    appends the sample's `image` slot (:276) — the loaded image tensor on
    pixel-backed datasets; pass the bank to reproduce that. Without it the
    "images" lists fall back to the image NAMES (what our corpus carries —
    the reference's behavior on name-backed samples)."""
    label_wise: Dict[int, Dict[str, list]] = {}
    for i in range(corpus.n):
        c = int(corpus.labels[i])
        slot = label_wise.setdefault(c, {"images": [], "eeg": []})
        slot["images"].append(
            images[i] if images is not None
            else corpus.image_names[int(corpus.image_idx[i])]
        )
        slot["eeg"].append(np.asarray(corpus.eeg[i]))
    feats, labels = [], []
    for label, data in label_wise.items():
        for eeg in data["eeg"]:
            feats.append(eeg)
            labels.append(label)
    if convert_to_numpy:
        feats = np.array(feats, dtype=float)
    img_f = None
    if corpus.image_features is not None and corpus.n:
        img_f = np.asarray(corpus.image_features[corpus.n - 1])
    return label_wise, feats, labels, img_f


def _mean_std_per_class(
    values: np.ndarray,
    labels: np.ndarray,
    reduce_axes: Tuple[int, ...],
    extra_count: int = 1,
) -> Dict[int, Dict[str, np.ndarray]]:
    """psum/psum_sq population statistics per class, vectorized (the
    accumulation loops of utils/Utilities.py:310-327 and :360-406).
    `extra_count` multiplies the divisor WITHOUT being summed over —
    reproducing CalcEEGMean's count formula (see calc_eeg_mean)."""
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for c in sorted(int(x) for x in np.unique(labels)):
        block = values[labels == c].astype(np.float64)
        psum = block.sum(axis=(0,) + tuple(a + 1 for a in reduce_axes))
        psum_sq = (block ** 2).sum(axis=(0,) + tuple(a + 1 for a in reduce_axes))
        count = (
            block.shape[0]
            * int(np.prod([block.shape[a + 1] for a in reduce_axes]))
            * extra_count
        )
        mean = psum / count
        var = psum_sq / count - mean ** 2
        out[c] = {
            "psum": psum, "psum_sq": psum_sq,
            "mean": mean.astype(np.float32),
            "std": np.sqrt(np.maximum(var, 0.0)).astype(np.float32),
        }
    return out


def calc_mean(
    images: np.ndarray, labels: np.ndarray
) -> Dict[int, Dict[str, np.ndarray]]:
    """Per-class per-channel image mean/std (CalcMean,
    utils/Utilities.py:299-329). `images`: (N, 3, H, W) channel-first, as the
    reference's tensors."""
    return _mean_std_per_class(np.asarray(images), np.asarray(labels), reduce_axes=(1, 2))


def calc_eeg_mean(
    corpus: EEGCorpus, images: Optional[np.ndarray] = None
) -> Dict[int, Dict[str, Dict[str, np.ndarray]]]:
    """Per-class {"eeg": mean/std over (trials, time) per channel,
    "image": mean/std per image channel} (CalcEEGMean,
    utils/Utilities.py:332-408), label-sorted like the reference.

    QUIRK reproduced for parity (pinned by the oracle test): the reference's
    eeg_count multiplies in eeg_channels even though each channel's psum
    only sums over (trials, time) (utils/Utilities.py:398-404), so its EEG
    "mean" is 1/C-scaled and the "std" inherits the inconsistent scaling.
    Corrected per-class statistics live in
    cerebra_torch.data.corpus.label_wise_stats."""
    eeg_stats = _mean_std_per_class(
        corpus.eeg, corpus.labels, reduce_axes=(0,), extra_count=corpus.n_channels
    )
    img_stats = (
        _mean_std_per_class(np.asarray(images), corpus.labels, reduce_axes=(1, 2))
        if images is not None
        else {}
    )
    return {
        c: {"eeg": eeg_stats[c], **({"image": img_stats[c]} if c in img_stats else {})}
        for c in sorted(eeg_stats)
    }
