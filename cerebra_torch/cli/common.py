"""Shared CLI plumbing: the reference flag set, the device, corpus /
teacher-feature loading (port of cerebra/cli/common.py), and the body the
two KD/cosine trainers share."""

from __future__ import annotations

import argparse
import os
from typing import Tuple

import numpy as np
import torch

from cerebra_torch.data import EEGCorpus, make_synthetic_corpus, random_split_indices
from cerebra_torch.train.recipes import FeatureDistillConfig, feature_distill_train
from cerebra_torch.utils.config import bool_flag, is_main_process, parse_hyperparams


def reference_argparser(description: str) -> argparse.ArgumentParser:
    """The shared flags of the reference entry points
    (LstmDistillFromDinoV2Train.py:150-226), the JAX package's additions,
    and `--device`."""
    p = argparse.ArgumentParser(description)
    p.add_argument("--learning_rate", type=float, default=0.001)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--log_dir", type=str, default="./logs/cerebra/")
    p.add_argument("--gallery_subject", type=int, default=1, choices=range(7))
    p.add_argument("--query_subject", type=int, default=1, choices=range(7))
    p.add_argument(
        "--eeg_dataset", type=str,
        default="./data/eeg/theperils/spampinato-1-IMAGE_RAPID_RAW_with_mean_std.pth",
    )
    p.add_argument("--images_root", type=str, default="./data/images/imageNet_images")
    p.add_argument("--eeg_dataset_split", type=str, default="")
    p.add_argument("--mode", type=str, default="train")
    p.add_argument("--custom_model_weights", type=str, default="")
    p.add_argument("--search_gallery", type=str, default="train")
    p.add_argument("--query_gallery", type=str, default="test")
    p.add_argument("--topK", type=int, default=5)
    p.add_argument("--hyperprams", type=str, default="{}")
    p.add_argument("--seed", type=int, default=43)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--dist_url", type=str, default="env://")
    p.add_argument("--local_rank", type=int, default=0)
    p.add_argument("--time_low", type=int, default=20)
    p.add_argument("--time_high", type=int, default=480)
    p.add_argument("--synthetic", action="store_true",
                   help="run on the synthetic-EEG fake backend (no data files)")
    p.add_argument("--synthetic_classes", type=int, default=8)
    p.add_argument("--synthetic_per_class", type=int, default=12)
    p.add_argument("--synthetic_channels", type=int, default=96,
                   help="96 = Perils rig, 128 = Spampinato rig")
    p.add_argument("--synthetic_samples", type=int, default=512,
                   help="512 = Perils, 500 = Spampinato")
    p.add_argument("--features_cache", type=str, default="",
                   help="precomputed teacher features (.npy/.npz/.pth) aligned to the corpus")
    p.add_argument("--feature_dim", type=int, default=384)
    p.add_argument("--use_bf16", type=bool_flag, default=True)
    p.add_argument("--devices", type=int, default=0,
                   help="data-parallel device count; this port runs on one device "
                        "(0 or 1), multi-GPU is not ported yet")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on: cuda (default) or cpu")
    return p


def resolve_device(FLAGS) -> torch.device:
    """The run's device; raises when CUDA is asked for and absent (no
    silent fall-back to the CPU)."""
    if FLAGS.devices > 1:
        raise NotImplementedError("--devices > 1: multi-GPU training is not ported yet")
    device = torch.device(FLAGS.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {FLAGS.device} asked for, but torch sees no CUDA device")
    return device


def load_corpus(FLAGS, subset=None, subject=None) -> EEGCorpus:
    """Corpus per flags: synthetic backend or a reference-format .pth,
    windowed to [time_low, time_high) like every entry script."""
    if FLAGS.synthetic:
        corpus = make_synthetic_corpus(
            seed=FLAGS.seed,
            n_per_class=FLAGS.synthetic_per_class,
            n_classes=FLAGS.synthetic_classes,
            n_channels=FLAGS.synthetic_channels,
            n_samples=FLAGS.synthetic_samples,
            feature_dim=FLAGS.feature_dim,
            class_signal_scale=1.5,
        )
    else:
        labels_txt = os.path.join(FLAGS.images_root, "labels.txt")
        split_path = FLAGS.eeg_dataset_split or None
        if subject is None:
            subject = FLAGS.gallery_subject if split_path else 0
        corpus = EEGCorpus.from_pth(
            FLAGS.eeg_dataset,
            labels_txt=labels_txt if os.path.exists(labels_txt) else None,
            split_path=split_path,
            subset=subset if subset is not None else FLAGS.search_gallery,
            subject=subject,
        )
    return corpus.window(FLAGS.time_low, FLAGS.time_high)


def load_teacher_features(FLAGS, corpus: EEGCorpus) -> np.ndarray:
    """Teacher feature bank for the corpus: the `--features_cache` file, or
    the corpus's own bank (synthetic)."""
    if FLAGS.features_cache:
        path = FLAGS.features_cache
        if path.endswith(".npy"):
            feats = np.load(path)
        elif path.endswith(".npz"):
            feats = np.load(path)["features"]
        else:
            obj = torch.load(path, map_location="cpu", weights_only=False)
            feats = np.asarray(obj["features"] if isinstance(obj, dict) else obj)
        if len(feats) != corpus.n:
            raise SystemExit(f"--features_cache has {len(feats)} rows for {corpus.n} trials")
        return feats.astype(np.float32)
    if corpus.image_features is not None:
        return corpus.image_features
    raise SystemExit(
        "No teacher features: pass --features_cache (precomputed DINOv2 features "
        "for the corpus) or --synthetic."
    )


def split_train_val(FLAGS, corpus: EEGCorpus) -> Tuple[np.ndarray, np.ndarray]:
    """The 80/20 seed-43 random_split of every DinoV2 recipe
    (LstmDistillFromDinoV2Train.py:289-290), bit-exact with torch."""
    train_idx, val_idx = random_split_indices(corpus.n, [0.8, 0.2], seed=FLAGS.seed)
    return train_idx, val_idx


def parsed_hyperparams(FLAGS) -> dict:
    return parse_hyperparams(FLAGS.hyperprams)


def run_feature_distill(FLAGS, cfg_kwargs: dict, weights_name: str):
    """The shared body of the KD/cosine trainers: corpus, teacher features,
    the 80/20 split, the recipe, and the best-loss weights written as
    `weights_name` in `--log_dir` (rank 0) → (model, history)."""
    device = resolve_device(FLAGS)
    os.makedirs(FLAGS.log_dir, exist_ok=True)
    corpus = load_corpus(FLAGS)
    feats = load_teacher_features(FLAGS, corpus)
    train_idx, val_idx = split_train_val(FLAGS, corpus)
    cfg = FeatureDistillConfig(
        num_epochs=FLAGS.num_epochs, batch_size=FLAGS.batch_size,
        learning_rate=FLAGS.learning_rate, lstm_size=corpus.n_channels, lstm_layers=4,
        top_k=FLAGS.topK, seed=FLAGS.seed,
        dtype=torch.bfloat16 if FLAGS.use_bf16 else None, **cfg_kwargs,
    )
    model, hist = feature_distill_train(
        corpus.eeg[train_idx], feats[train_idx], corpus.labels[train_idx],
        corpus.eeg[val_idx], feats[val_idx], corpus.labels[val_idx],
        device=device, config=cfg, n_classes=corpus.catalog.n_classes,
    )
    best_params = hist["best_params"][0]
    if best_params is not None and is_main_process():
        torch.save(best_params, os.path.join(FLAGS.log_dir, weights_name))
    return model, hist
