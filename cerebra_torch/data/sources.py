"""Image-dataset sources (port of cerebra/data/sources.py; the
EEGBaseDataset family, utils/EEGBaseDataset.py:19-141): Caltech101 (folder
scan, label encoding, a stratified 80/20 split,
utils/Caltech101Dataset.py:56-74), ImageNet, Domainnet, the torchvision
datasets (utils/TorchDatasets.py:20-120) and a synthetic backend.

A source is a thin host-side index (paths or an in-memory array, labels and
a label catalog); `extract_features` runs a teacher over it once and returns
the (N, F) feature bank that the trainers read. Nothing here downloads:
torchvision datasets need a pre-populated root. PIL is imported only where a
path-backed image is read or an image is resized without a `preprocess`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cerebra_torch.data.schema import LabelCatalog


@dataclasses.dataclass
class ImageSource:
    """Host-side image index with the reference's label-table protocol."""

    paths: Optional[List[str]]  # None when images come from an array
    labels: np.ndarray  # (N,) int32
    catalog: LabelCatalog
    images: Optional[np.ndarray] = None  # (N, H, W, 3) uint8 alternative

    @property
    def n(self) -> int:
        return len(self.labels)

    def __len__(self) -> int:
        return self.n

    def load_image(self, i: int) -> np.ndarray:
        """(H, W, 3) uint8."""
        if self.images is not None:
            return self.images[i]
        from PIL import Image

        return np.asarray(Image.open(self.paths[i]).convert("RGB"))

    def stratified_split(self, test_size: float = 0.2,
                         seed: int = 43) -> Tuple[np.ndarray, np.ndarray]:
        """Seeded sklearn StratifiedShuffleSplit, the reference's
        (utils/Caltech101Dataset.py:56-74): the same indices in sklearn's own
        order at the same seed. Without sklearn, a per-class proportional
        split (sorted indices; other indices at the same seed)."""
        try:
            from sklearn.model_selection import StratifiedShuffleSplit
        except ImportError:
            return self._proportional_split(test_size, seed)
        sss = StratifiedShuffleSplit(n_splits=1, test_size=test_size, random_state=seed)
        train_idx, test_idx = next(sss.split(np.zeros(self.n), self.labels))
        return train_idx.astype(np.int64), test_idx.astype(np.int64)

    def _proportional_split(self, test_size: float,
                            seed: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(seed)
        train_idx, test_idx = [], []
        for c in np.unique(self.labels):
            idx = np.nonzero(self.labels == c)[0]
            perm = rng.permutation(idx)
            n_test = max(int(round(len(idx) * test_size)), 1)
            test_idx.extend(perm[:n_test])
            train_idx.extend(perm[n_test:])
        return np.sort(train_idx).astype(np.int64), np.sort(test_idx).astype(np.int64)


def image_folder_source(root: str, extensions: Sequence[str] = (".jpg", ".jpeg", ".png"),
                        n_classes: int = 0) -> ImageSource:
    """Folder-per-class scan (the Caltech101/ImageNet/Domainnet layout)."""
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    if n_classes:
        classes = classes[:n_classes]
    paths, labels = [], []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(root, cname)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(tuple(extensions)):
                paths.append(os.path.join(cdir, fname))
                labels.append(ci)
    return ImageSource(
        paths=paths,
        labels=np.asarray(labels, dtype=np.int32),
        catalog=LabelCatalog(tuple(classes), tuple(classes),
                             tuple(str(i) for i in range(len(classes)))),
    )


def torchvision_source(name: str, root: str, train: bool = True) -> ImageSource:
    """CIFAR10/CIFAR100/Flowers102/OxfordIIITPet from a pre-downloaded
    torchvision root (utils/CIFAR10Dataset.py:19, utils/TorchDatasets.py:
    20-120), with download=False; raises if the root lacks the dataset."""
    from torchvision import datasets as tvd

    constructors = {
        "cifar10": lambda: tvd.CIFAR10(root, train=train, download=False),
        "cifar100": lambda: tvd.CIFAR100(root, train=train, download=False),
        "flowers102": lambda: tvd.Flowers102(root, split="train" if train else "test",
                                             download=False),
        "oxford_pets": lambda: tvd.OxfordIIITPet(root, split="trainval" if train else "test",
                                                 download=False),
    }
    if name not in constructors:
        raise ValueError(f"unknown torchvision dataset: {name}")
    try:
        ds = constructors[name]()
    except Exception as e:
        raise FileNotFoundError(
            f"{name} not found under {root}; nothing is downloaded — "
            f"provide a pre-populated torchvision root") from e
    if hasattr(ds, "data") and hasattr(ds, "targets"):  # CIFAR
        images = np.asarray(ds.data, dtype=np.uint8)
        labels = np.asarray(ds.targets, dtype=np.int32)
        names = tuple(getattr(ds, "classes", [str(i) for i in range(labels.max() + 1)]))
        return ImageSource(paths=None, labels=labels, images=images,
                           catalog=LabelCatalog(names, names,
                                                tuple(str(i) for i in range(len(names)))))
    if hasattr(ds, "_labels"):  # Flowers102 / OxfordIIITPet
        labels = np.asarray(ds._labels, dtype=np.int32)
    else:
        labels = np.asarray([ds[i][1] for i in range(len(ds))], dtype=np.int32)
    names = tuple(str(i) for i in range(int(labels.max()) + 1))
    # Flowers102 keeps its file paths in `_image_files`, OxfordIIITPet in `_images`
    path_list = getattr(ds, "_image_files", None) or getattr(ds, "_images", None)
    paths = [str(p) for p in path_list] if path_list else None
    source = ImageSource(paths=paths, labels=labels, catalog=LabelCatalog(names, names, names))
    if paths is None:
        source.images = np.stack([np.asarray(ds[i][0].convert("RGB")) for i in range(len(ds))])
    return source


def extract_features(
    source: ImageSource,
    model_fn: Callable[[torch.Tensor], torch.Tensor],  # (B, H, W, 3) f32 NHWC → (B, F)
    preprocess: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    batch_size: int = 64,
    image_size: int = 224,
) -> np.ndarray:
    """One batched teacher pass over the source → the (N, F) feature bank
    (the reference's `extract_features` dataset mutation,
    utils/PerilsEEGDataset.py:168-226, run once). Each batch reaches
    `model_fn` as a CPU f32 tensor; `model_fn` moves it to its device.
    Without `preprocess`, images are resized to image_size² by PIL and
    scaled to [0, 1]."""
    feats = []
    for start in range(0, source.n, batch_size):
        batch = []
        for i in range(start, min(start + batch_size, source.n)):
            img = source.load_image(i)
            if preprocess is not None:
                img = preprocess(img)
            else:
                from PIL import Image

                img = np.asarray(Image.fromarray(img).resize((image_size, image_size))
                                 ).astype(np.float32) / 255.0
            batch.append(img)
        out = model_fn(torch.from_numpy(np.stack(batch).astype(np.float32)))
        feats.append(out.detach().float().cpu().numpy())
    return np.concatenate(feats, axis=0)


# Named constructors of the reference's per-dataset classes (SURVEY.md §2.2):
# every folder-per-class scan shares one implementation.
def caltech101_source(root: str, n_classes: int = 0) -> ImageSource:
    """utils/Caltech101Dataset.py:16-300 (the 101_ObjectCategories layout)."""
    return image_folder_source(root, n_classes=n_classes)


def imagenet_source(root: str, n_classes: int = 0) -> ImageSource:
    """utils/ImageNetDataset.py:16 (wnid folders, an n_classes cap)."""
    return image_folder_source(root, n_classes=n_classes)


def domainnet_source(root: str, domain: str = "", n_classes: int = 0) -> ImageSource:
    """utils/DomainnetDataset.py:16 (a domain subfolder of class folders)."""
    return image_folder_source(os.path.join(root, domain) if domain else root,
                               n_classes=n_classes)


def synthetic_image_source(n_classes: int = 8, per_class: int = 12, image_size: int = 224,
                           seed: int = 0) -> ImageSource:
    """In-memory synthetic images: per-class Gaussian noise around a
    class-specific mean colour (the GaussNoise control-image idea,
    utils/GaussNoise.py:4-50, as a dataset), so every image-consuming CLI
    runs with --synthetic. The same numpy draws as the JAX package's."""
    rng = np.random.default_rng(seed)
    n = n_classes * per_class
    labels = np.repeat(np.arange(n_classes), per_class).astype(np.int32)
    means = rng.uniform(64, 192, size=(n_classes, 1, 1, 3))
    imgs = rng.normal(means[labels], 32.0, size=(n, image_size, image_size, 3))
    names = tuple(f"synthclass{i}" for i in range(n_classes))
    return ImageSource(
        paths=None,
        labels=labels,
        catalog=LabelCatalog(names, names, tuple(str(i) for i in range(n_classes))),
        images=np.clip(imgs, 0, 255).astype(np.uint8),
    )
