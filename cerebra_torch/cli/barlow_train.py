"""Cross-modal Barlow Twins pretraining (port of cerebra/cli/barlow_train.py;
EEG-BarlowNetworks/train.py).

An image tower and an EEG mel-spectrogram tower, one shared projector, the
cross-correlation loss (λ = 0.0051), LARS with split weight/bias learning
rates under warmup + cosine, `stats.txt` as JSONL (train.py:153-161). The
trained model's state dict is written to `<log_dir>/checkpoint.pt` (in place
of the JAX CLI's orbax directory); `load_checkpoint` reads it back.

Without stimulus images pass --synthetic: the EEG is synthetic and the image
branch receives Gaussian-noise images from the same numpy draw as the JAX
CLI's (the reference's own control backend, utils/GaussNoise.py). Runs on
`--device` (cuda by default; raises without one); `--devices N` over N
ranks, the global `--batch_size` split over them (rank 0 writes).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from cerebra_torch.cli.common import load_corpus, reference_argparser, start_world
from cerebra_torch.models.barlow import BarlowTwins
from cerebra_torch.train.barlow_recipe import BarlowConfig, barlow_train
from cerebra_torch.utils.config import bool_flag, is_main_process

CHECKPOINT = "checkpoint.pt"


def load_checkpoint(path: str, projector=(8192, 8192, 8192), eeg_in_channels: int = 96,
                    device: torch.device = torch.device("cpu")) -> BarlowTwins:
    """A BarlowTwins with the weights and running statistics of a
    `checkpoint.pt` this CLI wrote, in eval mode."""
    model = BarlowTwins(tuple(projector), eeg_in_channels=eeg_in_channels)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return model.to(device).eval()


def main(argv=None):
    parser = reference_argparser("Cross-modal Barlow Twins")
    parser.add_argument("--lambd", type=float, default=0.0051)
    parser.add_argument("--projector", type=str, default="8192-8192-8192")
    parser.add_argument("--learning_rate_weights", type=float, default=0.2)
    parser.add_argument("--learning_rate_biases", type=float, default=0.0048)
    parser.add_argument("--weight_decay", type=float, default=1e-6)
    parser.add_argument("--n_mels", type=int, default=224)
    parser.add_argument("--image_size", type=int, default=224)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument(
        "--remat", type=bool_flag, default=False,
        help="nested stage + block checkpointing in both ResNet towers: less activation "
             "memory for a larger batch, at the cost of recomputing the forward",
    )
    parser.add_argument(
        "--pretrained_backbone", type=str, default="",
        help="local torchvision resnet50 .pth to init both towers "
             "(extension; reference towers are random-init, net.py:15-19)",
    )
    FLAGS, _ = parser.parse_known_args(argv)
    print(FLAGS)
    world = start_world(FLAGS, "cerebra_torch.cli.barlow_train", argv, FLAGS.batch_size)
    if world is None:
        return None
    device, mesh = world
    os.makedirs(FLAGS.log_dir, exist_ok=True)

    corpus = load_corpus(FLAGS)
    # the image branch: Gaussian-noise control images (no stimulus images)
    rng = np.random.default_rng(FLAGS.seed)
    images = rng.normal(
        0.45, 0.22, size=(corpus.n, FLAGS.image_size, FLAGS.image_size, 3)
    ).astype(np.float32)

    cfg = BarlowConfig(
        epochs=FLAGS.epochs,
        batch_size=FLAGS.batch_size,
        learning_rate_weights=FLAGS.learning_rate_weights,
        learning_rate_biases=FLAGS.learning_rate_biases,
        weight_decay=FLAGS.weight_decay,
        lambd=FLAGS.lambd,
        projector=tuple(int(s) for s in FLAGS.projector.split("-")),
        n_mels=FLAGS.n_mels,
        image_size=FLAGS.image_size,
        seed=FLAGS.seed,
        pretrained_backbone=FLAGS.pretrained_backbone,
        remat=FLAGS.remat,
    )
    stats_path = os.path.join(FLAGS.log_dir, "stats.txt")

    def log_fn(msg):
        print(msg)
        if is_main_process():  # rank-0 JSONL (train.py:153-161)
            with open(stats_path, "a") as f:
                f.write(json.dumps({"msg": msg}) + "\n")

    model, hist = barlow_train(images, corpus.eeg, config=cfg, log_fn=log_fn, device=device,
                               mesh=mesh)
    if is_main_process():
        torch.save(model.state_dict(), os.path.join(FLAGS.log_dir, CHECKPOINT))
    return model, hist


if __name__ == "__main__":
    main()
