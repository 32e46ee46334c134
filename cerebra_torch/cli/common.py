"""Shared CLI plumbing: the reference flag set, the device, the distributed
world and its mesh, corpus / teacher-feature loading (port of
cerebra/cli/common.py), and the body the two KD/cosine trainers share.

A port process drives one device. `--devices N > 1` outside a launched
world runs the same CLI as N ranks through `cli/launch.py` (the
reference's mp.spawn, EEG-BarlowNetworks/train.py:71-78); inside one,
`init_distributed` brings the process group up from the env:// variables
and `start_world` lays the world out as a 1-D "data" mesh."""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

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
    p.add_argument("--devices", type=int, default=0, help=DEVICES_HELP)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on: cuda (default) or cpu")
    return p


DEVICES_HELP = ("data-parallel rank count (the DDP/DistributedSampler world of "
                "LstmDistillation.py:406,445): 0 = every local device (each CUDA device, "
                "or one CPU rank), clamped to a divisor of the global batch; N = N ranks, "
                "started through cerebra_torch.cli.launch when this process is not one "
                "already; inside a launched world 0 or the world size")


def launched() -> bool:
    """True in a rank of a launched world (`launch` or torchrun set WORLD_SIZE)."""
    return "WORLD_SIZE" in os.environ


def world_size() -> int:
    """WORLD_SIZE of a launched world (1 outside one)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def resolve_device(FLAGS) -> torch.device:
    """The run's device; raises when CUDA is asked for and absent (no
    silent fall-back to the CPU)."""
    device = torch.device(FLAGS.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {FLAGS.device} asked for, but torch sees no CUDA device")
    return device


def cli_devices(FLAGS, global_batch: Optional[int] = None) -> int:
    """The data-parallel width the flags ask for, by the JAX CLI's rules
    (cerebra/cli/common.py:64-94): 0 = every local device, clamped to the
    largest count that divides `global_batch`; an explicit N is honoured or
    refused; inside a launched world 0 or WORLD_SIZE."""
    n, world = int(FLAGS.devices or 0), world_size()
    if launched():
        if n not in (0, world):
            raise SystemExit(f"--devices {n} inside a launched world of {world} ranks: "
                             f"give 0 or {world}")
        return world
    cuda = torch.device(FLAGS.device).type == "cuda"
    avail = torch.cuda.device_count() if cuda else 1
    if n == 0:
        n = avail
        while global_batch and n > 1 and global_batch % n:
            n -= 1
    elif cuda and n > avail:
        raise SystemExit(f"--devices {n} requested but only {avail} CUDA devices visible")
    return n


def run_as_ranks(n: int, module: str, argv=None) -> None:
    """Run `python -m module argv` as ranks 0..n-1 of a world on this host
    (`launch.run`); a failing rank's exit code raises SystemExit."""
    from cerebra_torch.cli import launch

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH", "")) if p)
    args = list(sys.argv[1:] if argv is None else argv)
    rc = launch.run(n, [sys.executable, "-m", module, *args], env={"PYTHONPATH": path})
    if rc:
        raise SystemExit(rc)


def init_distributed(device: torch.device, backend: Optional[str] = None) -> torch.device:
    """Bring the process group up from the env:// variables in a launched
    world (WORLD_SIZE set, by `launch` or torchrun; a world of one included,
    whose mesh is then None) (port of cerebra/cli/common.py:105-132; the
    reference's init_distributed_mode, utils/utils.py:467-503) → this
    rank's device: a CUDA rank takes cuda:(LOCAL_RANK % device_count). The
    backend follows the device (nccl for cuda, gloo for cpu) unless the
    caller names one. A group already up is kept; a failure to init
    raises. Outside a launched world nothing is brought up."""
    if not launched():
        return device
    world = world_size()
    rank = int(os.environ["RANK"])
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                                init_method="env://", rank=rank, world_size=world)
    return device


def start_world(FLAGS, module: str, argv=None, global_batch: Optional[int] = None):
    """The distributed prologue of a training CLI (`module`) → (device,
    mesh), or None when this process, no rank itself, ran the CLI as the
    `--devices` ranks and has nothing left to do. The mesh is the launched
    world as a 1-D "data" mesh (port of cerebra/cli/common.py:64-94: the
    reference's DDP + DistributedSampler world, whose data axis the recipes
    shard every batch over), or None for a world of one, which takes the
    one-device path."""
    device = resolve_device(FLAGS)
    n = cli_devices(FLAGS, global_batch)  # a --devices the world cannot take stops here
    if n > 1 and not launched():
        run_as_ranks(n, module, argv)
        return None
    device = init_distributed(device)
    if n <= 1:
        return device, None
    from cerebra_torch.parallel.mesh import make_mesh

    mesh = make_mesh(("data",), (n,))
    print(f"mesh: {n} ranks on the data axis ({dist.get_backend()})")
    return device, mesh


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


def run_feature_distill(FLAGS, cfg_kwargs: dict, weights_name: str, module: str, argv=None):
    """The shared body of the KD/cosine trainers (`module` the CLI's, run as
    `--devices` ranks when asked): corpus, teacher features, the 80/20
    split, the recipe, and the best-loss weights written as `weights_name`
    in `--log_dir` (rank 0) → (model, history), or None in the process that
    started the ranks."""
    world = start_world(FLAGS, module, argv, FLAGS.batch_size)
    if world is None:
        return None
    device, mesh = world
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
        device=device, config=cfg, n_classes=corpus.catalog.n_classes, mesh=mesh,
    )
    best_params = hist["best_params"][0]
    if best_params is not None and is_main_process():
        torch.save(best_params, os.path.join(FLAGS.log_dir, weights_name))
    return model, hist
