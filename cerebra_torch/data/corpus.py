"""EEGCorpus — a whole recording corpus as dense numpy arrays (copy of
cerebra/data/corpus.py, the parts the trainer uses).

Instead of per-sample Python `__getitem__` work, the corpus is one
(N, T, C) float32 block plus label tables, and the reference's
mutate-in-place "transform" methods become pure feature stores (`with_eeg` /
`with_image_features`).

Semantics preserved:
- sample convention (T, C) after transposing the channel-first disk layout
  (utils/PerilsEEGDataset.py:548 `eeg.t()`);
- time windows `[time_low:time_high)` (utils/PerilsEEGDataset.py:568);
- Perils scalar mean/std computed as the average over records of each
  record's scalar mean/std (utils/PerilsEEGDataset.py:90-103);
- Spampinato split files + per-subject filtering, subject=0 meaning "all
  except excluded" (utils/EEGDataset.py:52-53, 99-128).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from cerebra_torch.data.schema import LabelCatalog, RawCorpus, load_corpus_pth, load_split_indices


@dataclasses.dataclass
class EEGCorpus:
    """Dense EEG corpus. `eeg` is time-major: (N, T, C)."""

    eeg: np.ndarray  # (N, T, C) float32
    labels: np.ndarray  # (N,) int32
    image_idx: np.ndarray  # (N,) int32
    subjects: np.ndarray  # (N,) int32
    catalog: LabelCatalog
    image_names: List[str]
    # Perils-style scalar statistics (utils/PerilsEEGDataset.py:90-103).
    mean: Optional[float] = None
    std: Optional[float] = None
    # Per-channel statistics from the .pth file (ConvertToPth.py:140-141).
    channel_means: Optional[np.ndarray] = None  # (C,)
    channel_stds: Optional[np.ndarray] = None  # (C,)
    # Pure replacement for the reference's extract_features mutation
    # (utils/PerilsEEGDataset.py:168-226): a (N, F) feature bank.
    image_features: Optional[np.ndarray] = None

    # ---------------------------------------------------------------- shape
    @property
    def n(self) -> int:
        return int(self.eeg.shape[0])

    @property
    def n_samples(self) -> int:
        return int(self.eeg.shape[1])

    @property
    def n_channels(self) -> int:
        return int(self.eeg.shape[2])

    def __len__(self) -> int:
        return self.n

    # ------------------------------------------------------------- builders
    @staticmethod
    def from_raw(raw: RawCorpus, catalog: Optional[LabelCatalog] = None) -> "EEGCorpus":
        eeg_tc = np.ascontiguousarray(np.transpose(raw.eeg, (0, 2, 1)))  # (N, T, C)
        per_rec_mean = raw.eeg.reshape(raw.n, -1).mean(axis=1)
        per_rec_std = raw.eeg.reshape(raw.n, -1).std(axis=1, ddof=1)
        return EEGCorpus(
            eeg=eeg_tc,
            labels=raw.labels.astype(np.int32),
            image_idx=raw.image_idx.astype(np.int32),
            subjects=raw.subjects.astype(np.int32),
            catalog=catalog or LabelCatalog.synthetic(raw.wnids),
            image_names=list(raw.image_names),
            mean=float(per_rec_mean.mean()),
            std=float(per_rec_std.mean()),
            channel_means=raw.means,
            channel_stds=raw.stddevs,
        )

    @staticmethod
    def from_pth(
        path: str,
        labels_txt: Optional[str] = None,
        split_path: Optional[str] = None,
        subset: str = "train",
        subject: int = 0,
        exclude_subjects: Sequence[int] = (),
    ) -> "EEGCorpus":
        """Load a corpus.

        Perils behavior (split_path=None): all records, on-the-fly scalar
        stats (utils/PerilsEEGDataset.py:53-54, 90-103). Spampinato behavior:
        split file + subject filtering (utils/EEGDataset.py:52-53, 99-128) —
        subject>0 keeps that subject, subject==0 keeps everything except
        `exclude_subjects`.
        """
        raw = load_corpus_pth(path)
        catalog = (
            LabelCatalog.from_labels_txt(labels_txt, raw.wnids)
            if labels_txt
            else LabelCatalog.synthetic(raw.wnids)
        )
        corpus = EEGCorpus.from_raw(raw, catalog)
        keep = np.ones(corpus.n, dtype=bool)
        if split_path is not None:
            idx = load_split_indices(split_path, 0, subset)
            mask = np.zeros(corpus.n, dtype=bool)
            mask[idx[idx < corpus.n]] = True
            keep &= mask
        if subject > 0:
            keep &= corpus.subjects == subject
        elif exclude_subjects:
            keep &= ~np.isin(corpus.subjects, np.asarray(exclude_subjects))
        if not keep.all():
            corpus = corpus.take(np.nonzero(keep)[0])
        return corpus

    # ----------------------------------------------------- pure "transforms"
    def take(self, indices: np.ndarray) -> "EEGCorpus":
        return dataclasses.replace(
            self,
            eeg=self.eeg[indices],
            labels=self.labels[indices],
            image_idx=self.image_idx[indices],
            subjects=self.subjects[indices],
            image_features=None if self.image_features is None else self.image_features[indices],
        )

    def with_eeg(self, eeg: np.ndarray) -> "EEGCorpus":
        """Pure counterpart of the reference's `subsetData[i]["eeg"] = ...`
        mutations (e.g. utils/PerilsEEGDataset.py:368, 405, 449)."""
        return dataclasses.replace(self, eeg=np.asarray(eeg))

    def with_image_features(self, feats: np.ndarray) -> "EEGCorpus":
        feats = np.asarray(feats)
        assert feats.shape[0] == self.n, (feats.shape, self.n)
        return dataclasses.replace(self, image_features=feats)

    def window(self, time_low: int, time_high: int) -> "EEGCorpus":
        """Time slice `[time_low:time_high)` (utils/PerilsEEGDataset.py:568)."""
        return self.with_eeg(self.eeg[:, time_low:time_high, :])


def image_path(corpus: EEGCorpus, idx: int, images_root: str) -> str:
    """Stimulus JPEG path for a trial (getImagePath/getOriginalImage,
    utils/PerilsEEGDataset.py:157-166): {root}/{wnid}/{name}.JPEG."""
    name = corpus.image_names[int(corpus.image_idx[idx])]
    return f"{images_root}/{name.split('_')[0]}/{name}.JPEG"


def label_wise_stats(corpus: EEGCorpus) -> Dict[int, Dict[str, np.ndarray]]:
    """Per-class EEG mean/std over all trials of the class — the
    label_wise_data_means tables of utils/Utilities.py:225-408, as
    vectorized reductions."""
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for c in np.unique(corpus.labels):
        block = corpus.eeg[corpus.labels == c]
        out[int(c)] = {
            "mean": block.mean(axis=0),
            "std": block.std(axis=0),
            "count": np.asarray(block.shape[0]),
        }
    return out
