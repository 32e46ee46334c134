"""Conformer ExP training on BCI-IV 2a (port of cerebra/cli/conformer_train.py;
the reference's trainer in utils/Conformer.py, :222-417 ExP, :420-470 main):
per subject, training with S&R augmentation and per-epoch test accuracy,
then `log_subject{n}.txt`, `conformer_subject{n}.pt` (the model's state
dict, in place of the JAX CLI's orbax directory) and `sub_result.txt`.

`--synthetic` replaces the BCI-IV .mat files with the class-coded synthetic
backend; `--subjects` runs the reference's 9-subject sweep (main, :425-470).
Runs on `--device` (cuda by default; raises without one); `--devices N`
over N ranks, the step batch (real + S&R) split over them (rank 0 writes).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from cerebra_torch.cli.common import DEVICES_HELP, start_world
from cerebra_torch.train.conformer_recipe import (
    ExPConfig,
    conformer_exp_train,
    load_bciiv_mat,
    make_synthetic_bciiv,
)
from cerebra_torch.utils.config import bool_flag, is_main_process


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("EEG Conformer ExP trainer")
    p.add_argument("--root", type=str, default="/Data/strict_TE/",
                   help="directory with A0{n}T.mat / A0{n}E.mat (ExP.root)")
    p.add_argument("--subjects", type=int, nargs="+", default=[1])
    p.add_argument("--batch_size", type=int, default=72)
    p.add_argument("--n_epochs", type=int, default=2000)
    p.add_argument("--lr", type=float, default=0.0002)
    p.add_argument("--b1", type=float, default=0.5)
    p.add_argument("--b2", type=float, default=0.999)
    p.add_argument("--emb_size", type=int, default=40)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--out_features", type=int, default=384)
    p.add_argument("--n_segments", type=int, default=8)
    p.add_argument("--eval_every", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_dir", type=str, default="./results/")
    p.add_argument("--use_bf16", type=bool_flag, default=True)
    p.add_argument("--devices", type=int, default=0, help=DEVICES_HELP)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on: cuda (default) or cpu")
    # synthetic backend
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_per_class", type=int, default=36)
    p.add_argument("--synthetic_channels", type=int, default=22)
    p.add_argument("--synthetic_samples", type=int, default=1000)
    return p


def main(argv=None):
    FLAGS, _ = build_parser().parse_known_args(argv)
    print(FLAGS)
    cfg = ExPConfig(
        batch_size=FLAGS.batch_size, n_epochs=FLAGS.n_epochs, lr=FLAGS.lr,
        b1=FLAGS.b1, b2=FLAGS.b2, emb_size=FLAGS.emb_size, depth=FLAGS.depth,
        out_features=FLAGS.out_features, n_segments=FLAGS.n_segments,
        eval_every=FLAGS.eval_every, seed=FLAGS.seed,
        dtype=torch.bfloat16 if FLAGS.use_bf16 else None,
    )
    world = start_world(FLAGS, "cerebra_torch.cli.conformer_train", argv, cfg.step_batch)
    if world is None:
        return None
    device, mesh = world
    os.makedirs(FLAGS.log_dir, exist_ok=True)
    results = []
    for subject in FLAGS.subjects:
        if FLAGS.synthetic:
            data, labels = make_synthetic_bciiv(
                seed=FLAGS.seed + subject, n_per_class=FLAGS.synthetic_per_class,
                n_channels=FLAGS.synthetic_channels, n_samples=FLAGS.synthetic_samples,
            )
            n_train = int(len(data) * 0.75)
            train_data, train_labels = data[:n_train], labels[:n_train]
            test_data, test_labels = data[n_train:], labels[n_train:]
        else:
            train_data, train_labels, test_data, test_labels = load_bciiv_mat(
                FLAGS.root, subject
            )
        print(f"Subject {subject}: train {train_data.shape} test {test_data.shape}")
        model, hist = conformer_exp_train(
            train_data, train_labels, test_data, test_labels, config=cfg, device=device,
            mesh=mesh,
            log_write_path=(os.path.join(FLAGS.log_dir, f"log_subject{subject}.txt")
                            if is_main_process() else None),
        )
        results.append((subject, hist["best_acc"][0], hist["aver_acc"][0]))
        if is_main_process():
            torch.save(model.state_dict(),
                       os.path.join(FLAGS.log_dir, f"conformer_subject{subject}.pt"))

    if is_main_process():
        with open(os.path.join(FLAGS.log_dir, "sub_result.txt"), "w") as f:
            for subject, best, aver in results:
                f.write(f"Subject {subject} : Seed is: {FLAGS.seed}\n")
                f.write(f"Subject {subject} : The best accuracy is: {best}\n")
                f.write(f"Subject {subject} : The average accuracy is: {aver}\n")
            f.write(f"**The average Best accuracy is: {np.mean([r[1] for r in results])}\n")
            f.write(f"The average Aver accuracy is: {np.mean([r[2] for r in results])}\n")
    return results


if __name__ == "__main__":
    main()
