"""The `.pth` corpus contract and label catalogs.

The reference emits a torch-pickled dict (ConvertToPth.py:170-201) consumed by
every loader (utils/EEGDataset.py:52-128, utils/PerilsEEGDataset.py:56-103):

    { "dataset": [ {"eeg": FloatTensor[C, T],   # channel-first on disk
                    "image": int,               # index into "images"
                    "label": int,               # class index into "labels"
                    "subject": int}, ... ],
      "labels":  [str],                         # ImageNet wnids, e.g. n03709823
      "images":  [str],                         # e.g. n03709823_25676
      "means":   [Tensor[1, C]],
      "stddevs": [Tensor[1, C]] }

We preserve this format bit-for-bit for interop (torch is used only as the
pickle IO codec on the host; nothing in the compute path touches it), but
load it into dense numpy arrays: one (N, C, T) block instead of N dict hops.

Label catalogs mirror the `labels.txt` table parsing of the reference
(utils/PerilsEEGDataset.py:76-89): each line is
`<wnid> <imagenetClassId> ... <imagenetClassName>`; the per-class dict is
{"ClassId": index-of-wnid-in-corpus-labels, "ClassName", "imagenetClassId"}.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class LabelCatalog:
    """Class-label tables (reference utils/PerilsEEGDataset.py:71-89).

    Attributes:
      wnids: corpus class list — the .pth "labels" entry (index == ClassId).
      class_names: human names per ClassId (reference `class_id_to_str`).
      imagenet_class_ids: ImageNet class-id strings per ClassId.
    """

    wnids: tuple
    class_names: tuple
    imagenet_class_ids: tuple

    @property
    def n_classes(self) -> int:
        return len(self.wnids)

    # Reference name: dataset.class_id_to_str (utils/PerilsEEGDataset.py:72)
    @property
    def class_id_to_str(self) -> Dict[int, str]:
        return {i: n for i, n in enumerate(self.class_names)}

    # Reference name: dataset.class_str_to_id (utils/PerilsEEGDataset.py:73)
    @property
    def class_str_to_id(self) -> Dict[str, int]:
        return {n: i for i, n in enumerate(self.class_names)}

    def label_dict(self, class_id: int) -> Dict[str, object]:
        """The "inference mode" label form (utils/PerilsEEGDataset.py:525-538)."""
        return {
            "ClassId": int(class_id),
            "ClassName": self.class_names[class_id],
            "imagenetClassId": self.imagenet_class_ids[class_id],
        }

    @staticmethod
    def from_labels_txt(path: str, wnids: Sequence[str]) -> "LabelCatalog":
        """Parse `{images_root}/labels.txt` (utils/PerilsEEGDataset.py:76-89).

        Lines look like `n03709823 847 ... padlock`; only wnids present in the
        corpus label list are kept, keyed by their index in `wnids`.
        """
        names = {}
        inet_ids = {}
        with open(path) as f:
            for line in f:
                parts = line.strip().split(" ")
                if len(parts) < 2:
                    continue
                wnid, inet_id, name = parts[0], parts[1], parts[-1]
                if wnid in wnids:
                    names[wnid] = name
                    inet_ids[wnid] = inet_id
        class_names = tuple(names.get(w, w) for w in wnids)
        imagenet_ids = tuple(inet_ids.get(w, "-1") for w in wnids)
        return LabelCatalog(tuple(wnids), class_names, imagenet_ids)

    @staticmethod
    def synthetic(wnids: Sequence[str]) -> "LabelCatalog":
        """A catalog whose names/ids are derived from the wnids (for tests)."""
        return LabelCatalog(
            tuple(wnids),
            tuple(f"class_{w}" for w in wnids),
            tuple(str(i) for i in range(len(wnids))),
        )


@dataclasses.dataclass
class RawCorpus:
    """A `.pth` corpus as dense arrays.

    eeg is stored channel-first on disk ([C, T], ConvertToPth.py:170-185); we
    keep that layout here and transpose to the (T, C) sample convention
    (utils/PerilsEEGDataset.py:548) when building an `EEGCorpus`.
    """

    eeg: np.ndarray  # (N, C, T) float32
    labels: np.ndarray  # (N,) int32 — class index per recording
    image_idx: np.ndarray  # (N,) int32 — index into image_names
    subjects: np.ndarray  # (N,) int32
    wnids: List[str]  # class list ("labels" in the .pth)
    image_names: List[str]  # stimulus names ("images" in the .pth)
    means: Optional[np.ndarray] = None  # (C,) float32
    stddevs: Optional[np.ndarray] = None  # (C,) float32

    @property
    def n(self) -> int:
        return int(self.eeg.shape[0])

    @property
    def n_channels(self) -> int:
        return int(self.eeg.shape[1])

    @property
    def n_samples(self) -> int:
        return int(self.eeg.shape[2])


def save_corpus_pth(path: str, corpus: RawCorpus) -> None:
    """Write the reference .pth dict format (ConvertToPth.py:170-201)."""
    import torch

    dataset = [
        {
            "eeg": torch.from_numpy(np.ascontiguousarray(corpus.eeg[i])).float(),
            "image": int(corpus.image_idx[i]),
            "label": int(corpus.labels[i]),
            "subject": int(corpus.subjects[i]),
        }
        for i in range(corpus.n)
    ]
    payload = {
        "dataset": dataset,
        "labels": list(corpus.wnids),
        "images": list(corpus.image_names),
    }
    if corpus.means is not None:
        payload["means"] = [torch.from_numpy(corpus.means.reshape(1, -1)).float()]
    if corpus.stddevs is not None:
        payload["stddevs"] = [torch.from_numpy(corpus.stddevs.reshape(1, -1)).float()]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(payload, path)


def load_corpus_pth(path: str) -> RawCorpus:
    """Load a reference-format .pth corpus into dense arrays.

    Mirrors the loader loops of utils/PerilsEEGDataset.py:92-103 /
    utils/EEGDataset.py:52-128 but materializes one (N, C, T) block.
    Recordings of unequal length are right-cropped to the shortest (the
    reference assumes uniform length).
    """
    import torch

    loaded = torch.load(path, map_location="cpu", weights_only=False)
    records = loaded["dataset"]
    n = len(records)
    if n == 0:
        raise ValueError(f"empty corpus: {path}")
    t_min = min(int(r["eeg"].shape[-1]) for r in records)
    c = int(records[0]["eeg"].shape[0])
    eeg = np.empty((n, c, t_min), dtype=np.float32)
    labels = np.empty((n,), dtype=np.int32)
    image_idx = np.empty((n,), dtype=np.int32)
    subjects = np.zeros((n,), dtype=np.int32)
    for i, r in enumerate(records):
        eeg[i] = np.asarray(r["eeg"], dtype=np.float32)[:, :t_min]
        labels[i] = int(r["label"])
        image_idx[i] = int(r["image"])
        subjects[i] = int(r.get("subject", 0))
    means = stddevs = None
    if "means" in loaded and len(loaded["means"]):
        means = np.asarray(loaded["means"][0], dtype=np.float32).reshape(-1)
    if "stddevs" in loaded and len(loaded["stddevs"]):
        stddevs = np.asarray(loaded["stddevs"][0], dtype=np.float32).reshape(-1)
    return RawCorpus(
        eeg=eeg,
        labels=labels,
        image_idx=image_idx,
        subjects=subjects,
        wnids=[str(w) for w in loaded["labels"]],
        image_names=[str(s) for s in loaded["images"]],
        means=means,
        stddevs=stddevs,
    )


def load_split_indices(path: str, split_num: int = 0, subset: str = "train") -> np.ndarray:
    """Read a reference split file: splits["splits"][split_num][subset]
    (utils/EEGDataset.py:52-53)."""
    import torch

    splits = torch.load(path, map_location="cpu", weights_only=False)
    return np.asarray(splits["splits"][split_num][subset], dtype=np.int64)
