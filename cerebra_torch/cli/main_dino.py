"""dino/main_dino.py — DINO v1 ViT training with EEG-as-image views (port of
cerebra/cli/main_dino.py; the recipe is cerebra_torch.train.dino_vit). The
flags follow the JAX CLI's, plus `--device`.

    python -m cerebra_torch.cli.main_dino --synthetic [--device cuda|cpu] ...

`--use_fused_mlp` / `--use_fused_attn` default to auto: on for CUDA
tensors (the hand-written kernels), off on the CPU; `true` on the CPU takes
the kernels' plain versions. `--fused_attn_pad` and `--fused_mlp_tile_m` are
accepted and change no result. `--devices N` trains over N ranks,
`--batch_size_per_gpu` rows each; rank 0 writes log.txt.
"""

from __future__ import annotations

import json
import os

import torch

from cerebra_torch.cli.common import load_corpus, reference_argparser, start_world
from cerebra_torch.train.dino_vit import DinoVitConfig, dino_vit_train
from cerebra_torch.utils.config import bool_flag, is_main_process


def _auto_flag(s: str):
    return None if s.lower() == "auto" else bool_flag(s)


def main(argv=None):
    parser = reference_argparser("DINO EEG-as-image ViT training (PyTorch/CUDA)")
    parser.add_argument("--arch", type=str, default="vit_small",
                        choices=["vit_tiny", "vit_small", "vit_base"])
    parser.add_argument("--patch_size", type=int, default=8)
    parser.add_argument("--out_dim", type=int, default=65536)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--batch_size_per_gpu", type=int, default=8)
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
    parser.add_argument("--global_size", type=int, default=224)
    parser.add_argument("--local_size", type=int, default=96)
    parser.add_argument("--norm_last_layer", type=bool_flag, default=True)
    parser.add_argument("--use_bn_in_head", type=bool_flag, default=False)
    parser.add_argument("--use_flash", type=bool_flag, default=False,
                        help="the flash attention (K15, K5/K6's attention cores) in the "
                             "unfused attention for sequences of 512 tokens or more")
    parser.add_argument("--remat", type=bool_flag, default=False,
                        help="torch.utils.checkpoint around each ViT block")
    parser.add_argument("--use_fused_mlp", type=_auto_flag, default=None,
                        help="fused MLP half-block kernel in every ViT block; auto (default) "
                             "= on for CUDA tensors")
    parser.add_argument("--use_fused_attn", type=_auto_flag, default=None,
                        help="fused attention half-block kernel in every ViT block; auto "
                             "(default) = on for CUDA tensors")
    parser.add_argument("--drop_path_rate", type=float, default=0.1,
                        help="student stochastic depth (dino/main_dino.py:105)")
    parser.add_argument("--fused_attn_pad", type=int, default=16,
                        help="accepted for parity with the JAX CLI; changes no result")
    parser.add_argument("--fused_mlp_tile_m", type=int, default=256,
                        help="accepted for parity with the JAX CLI; changes no result")
    parser.add_argument("--fused_min_seq", type=int, default=0,
                        help="engage the fused kernels only for view groups with at least "
                             "this many tokens (0 = always)")
    FLAGS, _ = parser.parse_known_args(argv)
    print(FLAGS)
    world = start_world(FLAGS, "cerebra_torch.cli.main_dino", argv)
    if world is None:
        return None
    device, mesh = world
    os.makedirs(FLAGS.log_dir, exist_ok=True)

    corpus = load_corpus(FLAGS)
    cfg = DinoVitConfig(
        arch=FLAGS.arch, patch_size=FLAGS.patch_size, out_dim=FLAGS.out_dim,
        epochs=FLAGS.epochs, batch_size_per_device=FLAGS.batch_size_per_gpu,
        lr=FLAGS.lr, min_lr=FLAGS.min_lr, warmup_epochs=FLAGS.warmup_epochs,
        weight_decay=FLAGS.weight_decay, weight_decay_end=FLAGS.weight_decay_end,
        momentum_teacher=FLAGS.momentum_teacher, teacher_temp=FLAGS.teacher_temp,
        warmup_teacher_temp=FLAGS.warmup_teacher_temp,
        warmup_teacher_temp_epochs=FLAGS.warmup_teacher_temp_epochs,
        clip_grad=FLAGS.clip_grad, freeze_last_layer=FLAGS.freeze_last_layer,
        local_crops_number=FLAGS.local_crops_number,
        global_size=FLAGS.global_size, local_size=FLAGS.local_size,
        norm_last_layer=FLAGS.norm_last_layer, use_bn_in_head=FLAGS.use_bn_in_head,
        seed=FLAGS.seed, dtype=torch.bfloat16 if FLAGS.use_bf16 else None,
        use_flash=FLAGS.use_flash, remat=FLAGS.remat,
        use_fused_mlp=FLAGS.use_fused_mlp, use_fused_attn=FLAGS.use_fused_attn,
        drop_path_rate=FLAGS.drop_path_rate,
        fused_attn_pad=FLAGS.fused_attn_pad, fused_mlp_tile_m=FLAGS.fused_mlp_tile_m,
        fused_min_seq=FLAGS.fused_min_seq,
    )
    # stimulus images are not bundled: the local crops are EEG-image crops
    state, hist = dino_vit_train(corpus.eeg, images=None, config=cfg, device=device, mesh=mesh)
    if is_main_process():
        with open(os.path.join(FLAGS.log_dir, "log.txt"), "a") as f:
            for e, loss in enumerate(hist["loss"]):
                f.write(json.dumps({"train_loss": loss, "epoch": e}) + "\n")
    return state, hist


if __name__ == "__main__":
    main()
