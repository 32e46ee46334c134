"""LstmDistillFromDinoV2Train — the LSTM regresses Perils EEG onto DINOv2
features (port of cerebra/cli/lstm_distill_from_dinov2_train.py).

Flow: corpus + teacher-feature bank → retrieval baseline of the raw teacher
features → 80/20 seed-43 split → Model(C, C, 2, F, top) +
FeatureDistributionLoss v1 + RMSprop(lr 1e-3) → validation every 5 epochs
with retrieval and best-checkpoint export (`lstm_dinov2_best_loss.pth`,
the reference `.pth` layout).

    python -m cerebra_torch.cli.lstm_distill_from_dinov2_train --synthetic \
        [--device cuda|cpu] [--use_bf16 true|false] ...

`--profile_dir DIR` writes a `torch.profiler` trace of the training loop
into DIR (`train/resume.py::profile_trace`), as the JAX CLI writes its
`jax.profiler` trace there. `--devices N` trains over N ranks (the global
batch `--batch_size` split over them); only rank 0 writes files.
"""

from __future__ import annotations

import json
import os

import torch

from cerebra_torch.cli.common import (
    load_corpus,
    load_teacher_features,
    parsed_hyperparams,
    reference_argparser,
    split_train_val,
    start_world,
)
from cerebra_torch.eval.retrieval import retrieval_recall_precision
from cerebra_torch.train.recipes import FeatureDistillConfig, feature_distill_train
from cerebra_torch.train.resume import profile_trace
from cerebra_torch.utils.config import is_main_process


def main(argv=None):
    parser = reference_argparser("LSTM→DINOv2 feature distillation (PyTorch/CUDA)")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="write a torch.profiler trace of the training loop here "
                        "(Chrome trace JSON; TensorBoard's PyTorch plugin or Perfetto)")
    FLAGS, _ = parser.parse_known_args(argv)
    print(FLAGS)
    world = start_world(FLAGS, "cerebra_torch.cli.lstm_distill_from_dinov2_train", argv,
                        FLAGS.batch_size)
    if world is None:
        return None
    device, mesh = world
    os.makedirs(FLAGS.log_dir, exist_ok=True)

    hp = parsed_hyperparams(FLAGS)
    corpus = load_corpus(FLAGS)
    feats = load_teacher_features(FLAGS, corpus)
    print(f"corpus: {corpus.n} trials, eeg {corpus.eeg.shape[1:]} → features {feats.shape[-1]}d")

    train_idx, val_idx = split_train_val(FLAGS, corpus)

    # pre-training baseline: retrieval on the raw teacher features
    # (LstmDistillFromDinoV2Train.py:318-320)
    r0, p0, _, _ = retrieval_recall_precision(
        torch.from_numpy(feats[train_idx]).to(device), torch.from_numpy(feats[val_idx]).to(device),
        corpus.labels[train_idx], corpus.labels[val_idx], k=FLAGS.topK,
    )
    print(f"Evaluating DINOv2: Recall {r0:.2f} Precision {p0:.2f}")

    cfg = FeatureDistillConfig(
        num_epochs=FLAGS.num_epochs,
        batch_size=FLAGS.batch_size,
        learning_rate=FLAGS.learning_rate,
        lstm_size=corpus.n_channels,
        lstm_layers=2,
        alpha=float(hp.get("alpha", 0.5)),
        top_k=FLAGS.topK,
        seed=FLAGS.seed,
        dtype=torch.bfloat16 if FLAGS.use_bf16 else None,
    )
    with profile_trace(FLAGS.profile_dir, enabled=bool(FLAGS.profile_dir)):
        model, hist = feature_distill_train(
            corpus.eeg[train_idx], feats[train_idx], corpus.labels[train_idx],
            corpus.eeg[val_idx], feats[val_idx], corpus.labels[val_idx],
            device=device, config=cfg, n_classes=corpus.catalog.n_classes, mesh=mesh,
        )

    best_params = hist["best_params"][0]
    if best_params is not None and is_main_process():
        torch.save(best_params, os.path.join(FLAGS.log_dir, "lstm_dinov2_best_loss.pth"))
    if is_main_process():
        with open(os.path.join(FLAGS.log_dir, "log.txt"), "a") as f:
            for e, (loss, wps) in enumerate(zip(hist["train_loss"], hist["windows_per_s"])):
                f.write(json.dumps({"epoch": e, "train_loss": loss, "windows_per_s": wps}) + "\n")
    print("done; best val loss", hist["best"][0])
    return model, hist


if __name__ == "__main__":
    main()
