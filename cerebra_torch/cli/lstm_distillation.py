"""LstmDistillation — DINO self-distillation with LSTM student and teacher
on raw EEG (port of cerebra/cli/lstm_distillation.py; reference
LstmDistillation.py, SURVEY.md §3.2).

The window [0, 495), the 80/20 seed-43 split, Model(96, 128, 4) without fc
+ DINOHead(128 → out_dim), temporal multi-crop 2 × 300 + 4 × 200, the EMA
teacher 0.996 → 1, AdamW with the cosine lr (linear-scaling rule) and WD
0.04 → 0.4, per-parameter clip 3.0, last layer frozen for 1 epoch; every
epoch `checkpoint.pth` in the reference layout (and `checkpoint{epoch:04}.pth`
every `--saveckp_freq` epochs) and the JSONL `log.txt`. `--auto_resume`
restarts from the newest step file in `<log_dir>/resume` (torch.save files,
`train/resume.py::AutoResume`); `--resume_pth` from a reference-layout
checkpoint, its AdamW moments included.

    python -m cerebra_torch.cli.lstm_distillation --synthetic [--device cuda|cpu] ...

`--devices N` trains over N ranks, `--batch_size_per_gpu` rows each; the
checkpoints are written by rank 0.
"""

from __future__ import annotations

import json
import os

import torch

from cerebra_torch.cli.common import load_corpus, reference_argparser, start_world
from cerebra_torch.data import random_split_indices
from cerebra_torch.train.checkpoints import export_dino_pth
from cerebra_torch.train.recipes import DinoSelfDistillConfig, dino_selfdistill_train
from cerebra_torch.train.resume import AutoResume
from cerebra_torch.utils.config import bool_flag, is_main_process


def add_dino_flags(parser):
    """The DINO flag block (LstmDistillation.py:195-346 defaults)."""
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--batch_size_per_gpu", type=int, default=8)
    parser.add_argument("--out_dim", type=int, default=384)
    parser.add_argument("--lr", type=float, default=0.0005)
    parser.add_argument("--min_lr", type=float, default=1e-6)
    parser.add_argument("--warmup_epochs", type=int, default=10)
    parser.add_argument("--weight_decay", type=float, default=0.04)
    parser.add_argument("--weight_decay_end", type=float, default=0.4)
    parser.add_argument("--momentum_teacher", type=float, default=0.996)
    parser.add_argument("--teacher_temp", type=float, default=0.04)
    parser.add_argument("--warmup_teacher_temp", type=float, default=0.04)
    parser.add_argument("--warmup_teacher_temp_epochs", type=int, default=0)
    parser.add_argument("--clip_grad", type=float, default=3.0)
    parser.add_argument("--freeze_last_layer", type=int, default=1)
    parser.add_argument("--local_crops_number", type=int, default=4)
    parser.add_argument("--norm_last_layer", type=bool_flag, default=True)
    parser.add_argument("--use_bn_in_head", type=bool_flag, default=False)
    parser.add_argument("--use_fp16", type=bool_flag, default=True,
                        help="accepted for parity with the reference; --use_bf16 sets the "
                             "precision")
    parser.add_argument("--optimizer", type=str, default="adamw",
                        help="accepted for parity with the reference; the recipe is AdamW")
    parser.add_argument("--saveckp_freq", type=int, default=20)
    parser.add_argument("--compat_reference_pairing", type=bool_flag, default=False)
    parser.add_argument("--auto_resume", type=bool_flag, default=True,
                        help="resume from the newest step file in <log_dir>/resume "
                             "(preemption-safe; replaces the SLURM requeue handlers)")
    parser.add_argument("--resume_pth", type=str, default="",
                        help="restart from a reference-layout checkpoint.pth "
                             "(student/teacher/center/epoch + torch-AdamW optimizer "
                             "moments, utils/utils.py:152-184)")
    return parser


def main(argv=None):
    parser = add_dino_flags(reference_argparser("DINO EEG self-distillation (PyTorch/CUDA)"))
    FLAGS, _ = parser.parse_known_args(argv)
    FLAGS.time_low, FLAGS.time_high = 0, 495  # LstmDistillation.py:383-385
    print(FLAGS)
    world = start_world(FLAGS, "cerebra_torch.cli.lstm_distillation", argv)
    if world is None:
        return None
    device, mesh = world
    os.makedirs(FLAGS.log_dir, exist_ok=True)

    corpus = load_corpus(FLAGS)
    train_idx, _ = random_split_indices(corpus.n, [0.8, 0.2], seed=43)
    train_eeg = corpus.eeg[train_idx]
    print(f"Data loaded: there are {len(train_eeg)} EEG trials.")

    cfg = DinoSelfDistillConfig(
        epochs=FLAGS.epochs, batch_size_per_device=FLAGS.batch_size_per_gpu,
        out_dim=FLAGS.out_dim, embed_dim=128, lstm_layers=4, lr=FLAGS.lr, min_lr=FLAGS.min_lr,
        warmup_epochs=FLAGS.warmup_epochs, weight_decay=FLAGS.weight_decay,
        weight_decay_end=FLAGS.weight_decay_end, momentum_teacher=FLAGS.momentum_teacher,
        teacher_temp=FLAGS.teacher_temp, warmup_teacher_temp=FLAGS.warmup_teacher_temp,
        warmup_teacher_temp_epochs=FLAGS.warmup_teacher_temp_epochs,
        clip_grad=FLAGS.clip_grad, freeze_last_layer=FLAGS.freeze_last_layer,
        n_local=FLAGS.local_crops_number, norm_last_layer=FLAGS.norm_last_layer,
        use_bn_in_head=FLAGS.use_bn_in_head,
        compat_reference_pairing=FLAGS.compat_reference_pairing, seed=FLAGS.seed,
        dtype=torch.bfloat16 if FLAGS.use_bf16 else None,
    )

    def checkpoint_cb(epoch, state):
        # the file write is rank 0 only (save_on_master, utils/utils.py:447-449)
        if not is_main_process():
            return
        kw = dict(args=vars(FLAGS), optimizer=state.optimizer, lr=FLAGS.lr,
                  weight_decay=FLAGS.weight_decay, norm_last_layer=FLAGS.norm_last_layer)
        export_dino_pth(os.path.join(FLAGS.log_dir, "checkpoint.pth"), state.student,
                        state.teacher, state.center, epoch, **kw)
        if FLAGS.saveckp_freq and epoch % FLAGS.saveckp_freq == 0:
            export_dino_pth(os.path.join(FLAGS.log_dir, f"checkpoint{epoch:04}.pth"),
                            state.student, state.teacher, state.center, epoch, **kw)

    resume = AutoResume(os.path.join(FLAGS.log_dir, "resume")) if FLAGS.auto_resume else None
    state, hist = dino_selfdistill_train(
        train_eeg, device, config=cfg, checkpoint_cb=checkpoint_cb, resume=resume,
        resume_pth=FLAGS.resume_pth or None, mesh=mesh,
    )
    start_epoch = FLAGS.epochs - len(hist["loss"])  # > 0 after a resume
    if is_main_process():
        with open(os.path.join(FLAGS.log_dir, "log.txt"), "a") as f:
            for e, loss in enumerate(hist["loss"], start=start_epoch):
                f.write(json.dumps({"train_loss": loss, "epoch": e}) + "\n")
    return state, hist


if __name__ == "__main__":
    main()
