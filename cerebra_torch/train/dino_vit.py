"""DINO v1 training with EEG-as-image views (port of
cerebra/train/dino_vit.py; dino/main_dino.py).

The reference's DataAugmentationDINO (:484-550) replaces both global crops
with EEG rendered as a 224×224×3 image (tile-repeat and a random time
window, utils/EEGDataset.py:248-303). The local crops are augmented
stimulus-image crops (signal/image_aug.py) when images are given, else
EEG-image crops, a variant the reference ships commented in (:535-549).
Student and teacher are DINO ViTs: EMA teacher, centering, temperature
warmup, cosine schedules, AdamW, bf16 compute over an f32 token stream.

The epoch loop is a Python loop over steps (the JAX package scans it); the
epoch order comes from `epoch_batches(n, B, seed, epoch)`, as in JAX. The
whole corpus lives on the device and batches are index gathers there.

With a `mesh` (cerebra/train/dino_vit.py:154-166, 239-295) the global batch
is batch_size_per_device × the data size (a "model" axis shards the head's
prototypes, not the batch): each data rank takes its rows from its block of
the corpus (`local_epoch_indices`), every rank draws the views' windows and
crops for the whole global batch from the same generator and keeps its
rows, the student trains under DDP over the data group, and the drop-path
masks come from a stream of each data rank's own.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from cerebra_torch.data.sampling import epoch_batches
from cerebra_torch.losses import teacher_temp_schedule
from cerebra_torch.models.heads import DINOHead
from cerebra_torch.models.multicrop import MultiCropWrapper
from cerebra_torch.models.vit import VisionTransformer, vit_base, vit_small, vit_tiny
from cerebra_torch.parallel.dataflow import local_epoch_indices, rank_seed, shard_corpus
from cerebra_torch.parallel.tp import gathered_dino_state
from cerebra_torch.signal.image_aug import dino_local_crop, draw_crop
from cerebra_torch.signal.windows import tile_eeg_views, window_starts
from cerebra_torch.train.resume import check_finite_loss
from cerebra_torch.train.schedules import cosine_scheduler
from cerebra_torch.train.steps import (
    DinoTrainState,
    distribute_dino_state,
    make_dino_step,
    make_scheduled_optimizer,
)


@dataclasses.dataclass
class DinoVitConfig:
    """Defaults from dino/main_dino.py:50-129, as the JAX package's."""

    arch: str = "vit_small"
    patch_size: int = 8
    out_dim: int = 65536
    epochs: int = 100
    batch_size_per_device: int = 8
    lr: float = 0.0005
    min_lr: float = 1e-6
    warmup_epochs: int = 10
    weight_decay: float = 0.04
    weight_decay_end: float = 0.4
    momentum_teacher: float = 0.996
    teacher_temp: float = 0.04
    warmup_teacher_temp: float = 0.04
    warmup_teacher_temp_epochs: int = 0
    clip_grad: float = 3.0
    freeze_last_layer: int = 1
    local_crops_number: int = 4
    global_size: int = 224
    local_size: int = 96
    norm_last_layer: bool = True
    use_bn_in_head: bool = False
    seed: int = 0
    dtype: Optional[torch.dtype] = None
    # the flash attention (K15, vit_attn.flash_mha_qkv) in the unfused Attention
    # for sequences of 512 tokens or more (the JAX package's library flash kernel)
    use_flash: bool = False
    # torch.utils.checkpoint around each ViT block
    remat: bool = False
    # fused half-block kernels in every ViT block (models/vit_mlp.py,
    # models/vit_attn.py); None = auto: on for CUDA tensors
    use_fused_mlp: Optional[bool] = None
    use_fused_attn: Optional[bool] = None
    # accepted for flag parity with the JAX package; the CUDA kernels choose
    # their own tiles and need no padding, so they change no result
    fused_attn_pad: int = 16
    fused_mlp_tile_m: int = 256
    # fused kernels only for view groups with at least this many tokens
    fused_min_seq: int = 0
    # student stochastic depth (dino/main_dino.py:105; the teacher has none)
    drop_path_rate: float = 0.1


def build_vit(cfg: DinoVitConfig, drop_path_rate: float = 0.0,
              generator: Optional[torch.Generator] = None) -> VisionTransformer:
    ctor = {"vit_tiny": vit_tiny, "vit_small": vit_small, "vit_base": vit_base}[cfg.arch]
    return ctor(
        patch_size=cfg.patch_size, img_size=cfg.global_size, dtype=cfg.dtype,
        use_flash=cfg.use_flash, remat=cfg.remat, use_fused_mlp=cfg.use_fused_mlp,
        use_fused_attn=cfg.use_fused_attn, drop_path_rate=drop_path_rate,
        fused_attn_pad=cfg.fused_attn_pad, fused_mlp_tile_m=cfg.fused_mlp_tile_m,
        fused_min_seq=cfg.fused_min_seq, generator=generator,
    )


def make_eeg_image_view_fn(n_global: int, n_local: int, global_size: int, local_size: int,
                           has_images: bool = False, rows=None):
    """(generator, batch) → [globals (n_global, B, S, S, 3), locals
    (n_local, B, s, s, 3)], NHWC. `batch` is eeg (B, T, C), or with
    `has_images` the pair (eeg, images (B, H, W, 3) in [0, 1]). Globals are
    tiled EEG images, each view and sample with its own random time window
    (dino/main_dino.py:526-531), fed raw like the reference (their scale
    differs from the normalised image crops, as in the reference recipe).
    Locals are augmented stimulus-image crops (`dino_local_crop`) with
    images, else EEG-image crops. The windows and crop draws come from
    `generator` on the host; the crops run batched on the images' device.
    `rows` = (index, count): the batch is block `index` of a global batch of
    `count` such blocks, the draws are the global batch's and the views
    take the block's."""
    index, count = rows or (0, 1)

    def mine(draw):  # (V, count·B) → this block's (V, B)
        B = draw.shape[1] // count
        return draw[:, index * B:(index + 1) * B]

    def view_fn(generator, batch):
        eeg, images = batch if has_images else (batch, None)
        B, T, C = eeg.shape
        starts = mine(window_starts((n_global, B * count), C, T, global_size, generator))
        views = [tile_eeg_views(eeg, starts, global_size)]
        if has_images:
            draws = draw_crop(generator, (n_local, B * count), *images.shape[1:3],
                              scale=(0.05, 0.4), blur_p=0.5)
            draws = dataclasses.replace(draws, **{
                f.name: mine(getattr(draws, f.name)) for f in dataclasses.fields(draws)
                if getattr(draws, f.name) is not None})
            views.append(dino_local_crop(images, draws, local_size))
        else:
            starts = mine(window_starts((n_local, B * count), C, T, local_size, generator))
            views.append(tile_eeg_views(eeg, starts, local_size))
        return views

    return view_fn


def make_dino_vit(cfg: DinoVitConfig, n: int, device: torch.device, has_images: bool = False,
                  mesh=None):
    """The recipe's pieces for a corpus of n trials → (state, step,
    generator, niter_per_ep): student and teacher initialised from
    `cfg.seed`, the schedules, the optimizer and the step with the
    EEG-image views (stimulus-image locals with `has_images`); with a
    `mesh` the step takes this rank's rows of the global batch."""
    n_data = mesh.size("data") if mesh else 1
    global_batch = cfg.batch_size_per_device * n_data
    niter_per_ep = max(n // global_batch, 1)

    torch.manual_seed(cfg.seed)  # drop-path masks come from the default generators
    gen = torch.Generator().manual_seed(cfg.seed)
    backbone = build_vit(cfg, cfg.drop_path_rate, generator=gen)
    head = DINOHead(backbone.embed_dim, cfg.out_dim, use_bn=cfg.use_bn_in_head,
                    norm_last_layer=cfg.norm_last_layer, dtype=cfg.dtype, generator=gen)
    student = MultiCropWrapper(backbone, head).to(device).train()
    # teacher: the same parameters, no drop path (dino/main_dino.py:190)
    teacher = MultiCropWrapper(
        build_vit(cfg), DINOHead(backbone.embed_dim, cfg.out_dim,
                                 norm_last_layer=cfg.norm_last_layer, dtype=cfg.dtype),
    ).to(device).eval()
    teacher.load_state_dict(student.state_dict())
    for p in teacher.parameters():
        p.requires_grad_(False)
    if mesh is not None:  # each data rank its own masks for its own rows
        torch.manual_seed(rank_seed(cfg.seed, mesh.index("data")))

    lr_schedule = cosine_scheduler(
        cfg.lr * global_batch / 256.0, cfg.min_lr, cfg.epochs, niter_per_ep,
        warmup_epochs=min(cfg.warmup_epochs, cfg.epochs),
    )
    wd_schedule = cosine_scheduler(cfg.weight_decay, cfg.weight_decay_end, cfg.epochs,
                                   niter_per_ep)
    momentum_schedule = cosine_scheduler(cfg.momentum_teacher, 1.0, cfg.epochs, niter_per_ep)
    temps = teacher_temp_schedule(cfg.warmup_teacher_temp, cfg.teacher_temp,
                                  cfg.warmup_teacher_temp_epochs, cfg.epochs)
    state = DinoTrainState(
        step=0, student=student, teacher=teacher,
        optimizer=make_scheduled_optimizer("adamw", student, lr_schedule, wd_schedule,
                                           clip_grad=cfg.clip_grad),
        center=torch.zeros(1, cfg.out_dim, device=device),
    )
    step = make_dino_step(
        lr_schedule, wd_schedule, momentum_schedule, temps, niter_per_ep,
        view_fn=make_eeg_image_view_fn(2, cfg.local_crops_number, cfg.global_size,
                                       cfg.local_size, has_images,
                                       (mesh.index("data"), n_data) if mesh else None),
        freeze_last_layer=cfg.freeze_last_layer,
        data_group=mesh.group("data") if mesh else None,
    )
    return state, step, gen, niter_per_ep


def dino_vit_train(
    eeg: np.ndarray,  # (N, T, C)
    images: Optional[np.ndarray] = None,
    config: DinoVitConfig = DinoVitConfig(),
    device: torch.device = torch.device("cpu"),
    log_fn: Callable[[str], None] = print,
    checkpoint_cb: Optional[Callable[[int, DinoTrainState], None]] = None,
    mesh=None,
) -> Tuple[DinoTrainState, Dict[str, List]]:
    """DINO training over `eeg`, with local crops from `images` (N, H, W, 3)
    in [0, 1] (the stimulus of each trial) when given, on one device or over
    a `mesh` (module docstring; `checkpoint_cb` sees the gathered state on
    every rank). Returns (state, history) with per-epoch loss, seconds and
    windows/s."""
    cfg = config
    n = len(eeg)
    state, step, gen, niter_per_ep = make_dino_vit(cfg, n, device, images is not None, mesh)
    global_batch = cfg.batch_size_per_device * (mesh.size("data") if mesh else 1)

    eeg = np.asarray(eeg, dtype=np.float32)
    images = None if images is None else np.asarray(images, dtype=np.float32)
    if mesh is not None:
        distribute_dino_state(mesh, state, cfg.out_dim)
        eeg, n_local = shard_corpus(mesh, eeg)
        images = None if images is None else shard_corpus(mesh, images)[0]
    eeg_d = torch.as_tensor(eeg).to(device)
    imgs_d = None if images is None else torch.as_tensor(images).to(device)

    def epoch_indices(epoch):
        if mesh is None:
            return epoch_batches(n, global_batch, seed=cfg.seed, epoch=epoch)[0][:niter_per_ep]
        return local_epoch_indices(n_local, mesh.size("data"), cfg.batch_size_per_device,
                                   niter_per_ep, cfg.seed, epoch)[:, mesh.index("data")]

    history: Dict[str, List] = {"loss": [], "epoch_time_s": [], "windows_per_s": []}
    for epoch in range(cfg.epochs):
        t0 = time.perf_counter()
        losses = []
        for idx in epoch_indices(epoch):
            idx = torch.as_tensor(idx, device=device)
            batch = eeg_d[idx] if imgs_d is None else (eeg_d[idx], imgs_d[idx])
            state, metrics = step(state, batch, gen)
            losses.append(metrics["loss"])
        loss = float(torch.stack(losses).float().mean())  # one sync per epoch
        check_finite_loss(loss, epoch)
        dt = time.perf_counter() - t0
        history["loss"].append(loss)
        history["epoch_time_s"].append(dt)
        history["windows_per_s"].append(niter_per_ep * global_batch / dt)
        log_fn(f"EPOCH {epoch} dino_vit_loss: {loss:.4f} "
               f"({history['windows_per_s'][-1]:.1f} windows/s)")
        if checkpoint_cb is not None:
            with gathered_dino_state(state):
                checkpoint_cb(epoch, state)
    return state, history
