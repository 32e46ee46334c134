"""The LSTM training recipes (port of cerebra/train/recipes.py).

- `feature_distill_train`: LstmDistillFromDinoV2Train.py:351-440 and its
  variants: the LSTM regresses EEG windows onto cached teacher (DINOv2)
  features under the loss and optimizer the config names; every
  `validation_frequency` epochs it scores top-k retrieval and the
  validation loss and keeps the best-loss weights.
- `dino_selfdistill_train`: LstmDistillation.py:526-651: DINO student and
  EMA teacher LSTMs over temporal multi-crop views, centered and sharpened
  cross-entropy, cosine lr/wd/momentum schedules, AdamW.

Whole corpora live on the device; batches are index gathers there. The
epoch loop is a Python loop over steps (the JAX package scans it).

With a `mesh` (`parallel/mesh.py`) each data rank holds its block of the
wrap-padded corpus and draws its rows of every global batch from
`local_epoch_indices` (the JAX meshed branch's stream); the model is
broadcast from rank 0 and wrapped in DDP over the data group; every loss is
the global batch's (a differentiable all-reduce), so every rank logs the
same loss stream and DDP's mean of the ranks' gradients is the global
gradient. In the DINO recipe a "model" axis shards the head's prototypes
(`parallel/tp.py`); checkpoints gather them on every rank first.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from cerebra_torch.data.sampling import epoch_batches
from cerebra_torch.eval.retrieval import retrieval_recall_precision
from cerebra_torch.losses import (
    cosine_similarity_loss,
    feature_distribution_loss_v1,
    feature_distribution_loss_v2,
    feature_distribution_loss_v3,
    hinton_kd_loss,
    teacher_temp_schedule,
)
from cerebra_torch.models.heads import DINOHead
from cerebra_torch.models.lstm import Model
from cerebra_torch.models.multicrop import MultiCropWrapper
from cerebra_torch.parallel.collectives import pmean
from cerebra_torch.parallel.dataflow import local_epoch_indices, put_replicated, shard_corpus
from cerebra_torch.parallel.mesh import data_parallel
from cerebra_torch.parallel.tp import gathered_dino_state
from cerebra_torch.train.checkpoints import import_dino_pth
from cerebra_torch.train.optim import make_optimizer
from cerebra_torch.train.resume import PreemptionGuard, check_finite_loss
from cerebra_torch.train.schedules import cosine_scheduler
from cerebra_torch.train.steps import (
    DinoTrainState,
    distribute_dino_state,
    feature_distill_step,
    make_dino_step,
    make_scheduled_optimizer,
)


@dataclasses.dataclass
class FeatureDistillConfig:
    """Defaults = LstmDistillFromDinoV2Train.py flags/HyperParams
    (:16-25, :329: RMSprop lr 1e-3, batch 16, warmup T 1.5→0.22 over 50).

    `loss` selects the recipe variant:
      feature_dist_v1 — LstmDistillFromDinoV2Train (CE + softened CE)
      hinton_kd       — LstmDistillFromDinoV2TrainSpampinato (KLDiv·αT² + CE)
      cosine          — LSTMDistill (1 − mean cos)
      feature_dist_v2 — mean/std matching MSE (LstmDistillation variant)
      feature_dist_v3 — soft-target KL·T² (Eval variant)
    """

    num_epochs: int = 100
    batch_size: int = 16
    learning_rate: float = 1e-3
    optimizer: str = "rmsprop"
    lstm_size: int = 96
    lstm_layers: int = 2
    loss: str = "feature_dist_v1"
    alpha: float = 0.5
    beta: float = 0.5
    kd_temperature: float = 2.0
    warmup_teacher_temp: float = 1.5
    teacher_temp: float = 0.22
    warmup_teacher_temp_epochs: int = 50
    validation_frequency: int = 5
    top_k: int = 5
    seed: int = 43
    dtype: Optional[torch.dtype] = None


def distill_loss(cfg: FeatureDistillConfig, temps: np.ndarray, group=None) -> Callable:
    """The recipe's loss, loss_fn(feats, cls_pred, teacher_feats, labels,
    epoch), by `cfg.loss` (the switch of cerebra/train/recipes.py:127-142);
    `temps` the f32 teacher-temperature schedule by epoch. The losses past
    v1 take the features in f32 (the JAX package mixes a bf16 stream into
    them; f32 runs are the same). With a data `group` the loss is the
    global batch's: v2 takes its statistics over the group, the others
    (batch means) are the group's mean of the ranks' losses."""
    if cfg.loss not in ("feature_dist_v1", "hinton_kd", "cosine", "feature_dist_v2",
                        "feature_dist_v3"):
        raise ValueError(f"unknown loss: {cfg.loss}")

    def loss_fn(feats, cls_pred, teacher_feats, labels, epoch):
        if cfg.loss == "feature_dist_v1":
            return feature_distribution_loss_v1(
                feats, teacher_feats, labels, cls_pred, temperature=float(temps[epoch]),
                alpha=cfg.alpha, beta=cfg.beta,
            )
        feats = feats.float()
        if cfg.loss == "hinton_kd":
            # the Spampinato recipe (LstmDistillFromDinoV2TrainSpampinato.py:424):
            # KD over the regressed features as logits
            return hinton_kd_loss(feats, labels, teacher_feats, cfg.kd_temperature, cfg.alpha)
        if cfg.loss == "cosine":
            return cosine_similarity_loss(feats, teacher_feats)
        if cfg.loss == "feature_dist_v2":
            return feature_distribution_loss_v2(feats, teacher_feats, group)
        return feature_distribution_loss_v3(feats, teacher_feats, float(temps[epoch]))

    if group is None or cfg.loss == "feature_dist_v2":
        return loss_fn
    return lambda *args: pmean(loss_fn(*args), group)


def feature_distill_train(
    train_eeg: np.ndarray,  # (Nt, T, C)
    train_feats: np.ndarray,  # (Nt, F) cached teacher features
    train_labels: np.ndarray,  # (Nt,)
    val_eeg: np.ndarray,
    val_feats: np.ndarray,
    val_labels: np.ndarray,
    device: torch.device,
    config: FeatureDistillConfig = FeatureDistillConfig(),
    n_classes: Optional[int] = None,
    log_fn: Callable[[str], None] = print,
    mesh=None,
) -> Tuple[Model, Dict[str, List]]:
    """The README-blessed train() recipe. Returns (model, history). With a
    `mesh` the batch splits over its data axis (module docstring): a step
    over W ranks is the JAX meshed step over the global batch."""
    cfg = config
    if n_classes is None:
        n_classes = int(max(train_labels.max(), val_labels.max())) + 1

    model = Model(
        input_size=train_eeg.shape[-1], lstm_size=cfg.lstm_size, lstm_layers=cfg.lstm_layers,
        output_size=train_feats.shape[-1], include_top=True, n_classes=n_classes,
        dtype=cfg.dtype, device=device,
        generator=torch.Generator().manual_seed(cfg.seed),
    )
    # unmasked, as the JAX recipe builds it (no params_mask_source, no decay)
    optimizer = make_optimizer(cfg.optimizer, model.parameters(), cfg.learning_rate)
    # f32 values, as the JAX recipe indexes an f32 array
    temps = teacher_temp_schedule(
        cfg.warmup_teacher_temp, cfg.teacher_temp, cfg.warmup_teacher_temp_epochs,
        cfg.num_epochs,
    ).astype(np.float32)

    loss_fn = distill_loss(cfg, temps)

    def on_device(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    train_eeg_d = on_device(train_eeg, torch.float32)
    train_feats_d = on_device(train_feats, torch.float32)
    train_labels_d = on_device(train_labels, torch.int64)
    val_eeg_d = on_device(val_eeg, torch.float32)
    val_feats_d = on_device(val_feats, torch.float32)
    val_labels_d = on_device(val_labels, torch.int64)

    def run_epoch(epoch):
        # full-size batches + one ragged tail batch (reference DataLoader
        # semantics: no duplicated samples), in the JAX recipe's order
        n_train = len(train_eeg)
        order = np.random.default_rng((cfg.seed, epoch)).permutation(n_train)
        full_n = n_train // cfg.batch_size * cfg.batch_size
        batches = list(order[:full_n].reshape(-1, cfg.batch_size))
        if full_n < n_train:
            batches.append(order[full_n:])
        losses = []
        for idx in batches:
            i = on_device(idx, torch.int64)
            losses.append(feature_distill_step(
                model, optimizer, loss_fn, train_eeg_d[i], train_feats_d[i],
                train_labels_d[i], epoch,
            ))
        return losses, n_train

    if mesh is not None:
        run_epoch = _meshed_distill_epochs(
            mesh, model, optimizer, distill_loss(cfg, temps, mesh.group("data")), cfg,
            train_eeg, train_feats, train_labels, on_device)

    history: Dict[str, List] = {"train_loss": [], "val_loss": [], "recall": [], "precision": [],
                                "epoch_time_s": [], "windows_per_s": []}
    best_val, best_epoch, best_params = None, -1, None

    for epoch in range(cfg.num_epochs):
        t0 = time.perf_counter()
        losses, n_seen = run_epoch(epoch)
        # one device sync per epoch
        epoch_loss = float(np.mean(torch.stack(losses).cpu().numpy()))
        check_finite_loss(epoch_loss, epoch)
        dt = time.perf_counter() - t0
        history["train_loss"].append(epoch_loss)
        history["epoch_time_s"].append(dt)
        history["windows_per_s"].append(n_seen / dt)

        if cfg.validation_frequency and epoch % cfg.validation_frequency == 0 and epoch > 0:
            with torch.no_grad():
                gallery = model(train_eeg_d)[0]
                vfeats, vcls = model(val_eeg_d)
                recall, precision, _, _ = retrieval_recall_precision(
                    gallery, vfeats, train_labels_d, val_labels_d, k=cfg.top_k,
                )
                val_loss = float(loss_fn(vfeats, vcls, val_feats_d, val_labels_d, epoch))
            history["recall"].append((epoch, recall))
            history["precision"].append((epoch, precision))
            history["val_loss"].append((epoch, val_loss))
            if best_val is None or val_loss < best_val:
                best_val, best_epoch = val_loss, epoch
                best_params = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            log_fn(
                f"EPOCH {epoch} train_loss: {epoch_loss:.6f} val_loss: {val_loss:.6f} "
                f"R: {recall:.2f} P: {precision:.2f} best: {best_val:.6f}@{best_epoch}"
            )
        else:
            log_fn(f"EPOCH {epoch} train_loss: {epoch_loss:.6f}")

    history["best"] = [(best_epoch, best_val)]
    history["best_params"] = [best_params]
    return model, history


def _meshed_distill_epochs(mesh, model, optimizer, loss_fn, cfg, train_eeg, train_feats,
                           train_labels, on_device) -> Callable:
    """The JAX meshed branch's epochs (cerebra/train/recipes.py:151-193) →
    run_epoch(epoch) → (losses, windows seen): this rank's block of each
    wrap-padded corpus, ceil(n_local / b_local) steps of b_local draws from
    `local_epoch_indices`, every row trained, the model under DDP."""
    n_data, d = mesh.size("data"), mesh.index("data")
    if cfg.batch_size % n_data:
        # the reference asserts batch divisibility by the world size too
        # (EEG-BarlowNetworks/train.py:129)
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by data-axis size {n_data}")
    b_local = cfg.batch_size // n_data
    eeg, n_local = shard_corpus(mesh, np.asarray(train_eeg, dtype=np.float32))
    eeg = on_device(eeg, torch.float32)
    feats = on_device(shard_corpus(mesh, np.asarray(train_feats, dtype=np.float32))[0])
    labels = on_device(shard_corpus(mesh, np.asarray(train_labels))[0], torch.int64)
    n_steps = -(-n_local // b_local)
    put_replicated(model)
    # only v1 reads the class head: the other losses leave it without a gradient
    ddp = data_parallel(model, mesh, find_unused_parameters=cfg.loss != "feature_dist_v1")

    def run_epoch(epoch):
        idx = local_epoch_indices(n_local, n_data, b_local, n_steps, cfg.seed, epoch)[:, d]
        losses = [feature_distill_step(ddp, optimizer, loss_fn, eeg[i], feats[i], labels[i],
                                       epoch)
                  for i in on_device(idx, torch.int64)]
        return losses, n_steps * cfg.batch_size

    return run_epoch


# ------------------------------------------------------------------- DINO
@dataclasses.dataclass
class DinoSelfDistillConfig:
    """Defaults = LstmDistillation.py flags (:195-346): out_dim 384,
    momentum 0.996, teacher_temp 0.04 with warmup, batch/gpu 8, AdamW,
    crops 2×300 + 4×200."""

    epochs: int = 100
    batch_size_per_device: int = 8
    out_dim: int = 384
    embed_dim: int = 128
    lstm_layers: int = 4
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
    global_length: int = 300
    local_length: int = 200
    n_global: int = 2
    n_local: int = 4
    norm_last_layer: bool = True
    use_bn_in_head: bool = False
    compat_reference_pairing: bool = False
    seed: int = 0
    dtype: Optional[torch.dtype] = None


def build_dino_models(n_channels: int, cfg: DinoSelfDistillConfig,
                      generator: Optional[torch.Generator] = None):
    """(backbone, head): the LSTM stack alone (`Model` with no fc, under
    `lstm.*`, as the JAX recipe's features_only init leaves it) and
    DINOHead(embed_dim → out_dim)."""
    backbone = Model(n_channels, cfg.embed_dim, cfg.lstm_layers, None, dtype=cfg.dtype,
                     generator=generator)
    head = DINOHead(cfg.embed_dim, cfg.out_dim, use_bn=cfg.use_bn_in_head,
                    norm_last_layer=cfg.norm_last_layer, dtype=cfg.dtype, generator=generator)
    return backbone, head


def make_dino_lstm(cfg: DinoSelfDistillConfig, n: int, n_channels: int, device: torch.device,
                   view_fn: Optional[Callable] = None, mesh=None):
    """The recipe's pieces for a corpus of n trials → (state, step,
    niter_per_ep): student and teacher from `cfg.seed` (the teacher a copy
    of the student, dino/main_dino.py:190), the schedules (the
    linear-scaling rule, dino/main_dino.py:257-262, over the global batch
    of batch_size_per_device × the mesh's data size), AdamW over the
    student and the DINO step (temporal multi-crop views unless `view_fn`)."""
    global_batch = cfg.batch_size_per_device * (mesh.size("data") if mesh else 1)
    niter_per_ep = max(n // global_batch, 1)
    gen = torch.Generator().manual_seed(cfg.seed)
    student = MultiCropWrapper(*build_dino_models(n_channels, cfg, gen)).to(device).train()
    teacher = copy.deepcopy(student).eval()
    for p in teacher.parameters():
        p.requires_grad_(False)

    lr_schedule = cosine_scheduler(cfg.lr * global_batch / 256.0, cfg.min_lr, cfg.epochs,
                                   niter_per_ep, warmup_epochs=min(cfg.warmup_epochs, cfg.epochs))
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
        lr_schedule, wd_schedule, momentum_schedule, temps, niter_per_ep, view_fn=view_fn,
        global_length=cfg.global_length, local_length=cfg.local_length, n_global=cfg.n_global,
        n_local=cfg.n_local, freeze_last_layer=cfg.freeze_last_layer,
        compat_reference_pairing=cfg.compat_reference_pairing,
        data_group=mesh.group("data") if mesh else None,
    )
    return state, step, niter_per_ep


def dino_state_dict(state: DinoTrainState) -> dict:
    """Everything a DINO run resumes from, for `AutoResume.save`."""
    return {"step": state.step, "student": state.student.state_dict(),
            "teacher": state.teacher.state_dict(), "optimizer": state.optimizer.state_dict(),
            "center": state.center.detach().cpu()}


def load_dino_state_dict(state: DinoTrainState, saved: dict) -> None:
    state.step = int(saved["step"])
    state.student.load_state_dict(saved["student"])
    state.teacher.load_state_dict(saved["teacher"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.center = saved["center"].to(state.center.device)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The crops' generator of one step, from (seed, step) alone, so a run
    resumed at any step draws the crops an unbroken run draws there (the JAX
    recipe folds the resumed step into its key)."""
    return torch.Generator().manual_seed(
        int(np.random.SeedSequence([seed, step]).generate_state(1)[0]))


def dino_selfdistill_train(
    train_eeg: np.ndarray,  # (N, T, C)
    device: torch.device,
    config: DinoSelfDistillConfig = DinoSelfDistillConfig(),
    log_fn: Callable[[str], None] = print,
    checkpoint_cb: Optional[Callable[[int, DinoTrainState], None]] = None,
    resume=None,  # cerebra_torch.train.resume.AutoResume
    resume_pth: Optional[str] = None,  # reference-layout checkpoint.pth
    mesh=None,
) -> Tuple[DinoTrainState, Dict[str, List]]:
    """LstmDistillation recipe (SURVEY.md §3.2) → (state, history), on one
    device or over a `mesh` (module docstring; `checkpoint_cb` and the
    auto-resume saves then see the gathered state on every rank).

    `resume_pth` restarts from a reference-layout checkpoint: student,
    teacher, center, epoch and the torch-AdamW moments
    (restart_from_checkpoint, utils/utils.py:152-184), so a run begun under
    the reference or the JAX package continues here without resetting Adam.
    `resume` (an AutoResume) restores its newest step, saves after every
    epoch, and on SIGTERM/SIGUSR1 saves at the next step boundary and exits
    (`PreemptionGuard`); a run restored within an epoch takes that epoch's
    remaining steps."""
    cfg = config
    n, n_channels = len(train_eeg), train_eeg.shape[-1]
    global_batch = cfg.batch_size_per_device * (mesh.size("data") if mesh else 1)
    state, step, niter_per_ep = make_dino_lstm(cfg, n, n_channels, device, mesh=mesh)

    start_epoch = 0
    if resume_pth:
        _, _, center, ck_epoch = import_dino_pth(resume_pth, state.student, state.teacher,
                                                  state.optimizer)
        if tuple(center.shape) == (1, cfg.out_dim):  # else the checkpoint has no center
            state.center = center.to(device)
        start_epoch = min(ck_epoch, cfg.epochs)
        state.step = start_epoch * niter_per_ep
        log_fn(f"resumed from {resume_pth} at epoch {start_epoch} (optimizer moments restored)")
    if resume is not None:
        saved_step, saved = resume.restore_latest()
        if saved is not None:
            load_dino_state_dict(state, saved)
            start_epoch = saved_step // niter_per_ep
            log_fn(f"auto-resume: restored step {saved_step} (epoch {start_epoch})")

    def save():
        with gathered_dino_state(state):
            resume.save(state.step, dino_state_dict(state))

    eeg = np.asarray(train_eeg, dtype=np.float32)
    if mesh is not None:
        distribute_dino_state(mesh, state, cfg.out_dim)
        eeg, n_local = shard_corpus(mesh, eeg)
    eeg_d = torch.as_tensor(eeg).to(device)

    def epoch_indices(epoch):
        if mesh is None:
            return epoch_batches(n, global_batch, seed=cfg.seed, epoch=epoch)[0][:niter_per_ep]
        # niter_per_ep steps of batch_size_per_device draws from this rank's
        # block: the reference's floor(n / global_batch) drop-tail epoch
        return local_epoch_indices(n_local, mesh.size("data"), cfg.batch_size_per_device,
                                   niter_per_ep, cfg.seed, epoch)[:, mesh.index("data")]

    history: Dict[str, List] = {"loss": [], "epoch_time_s": [], "windows_per_s": []}
    with (PreemptionGuard(device=device) if resume is not None
          else contextlib.nullcontext()) as guard:
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.perf_counter()
            losses = []
            for it, idx in enumerate(epoch_indices(epoch)):
                if epoch * niter_per_ep + it < state.step:
                    continue  # taken before a preemption within this epoch
                state, metrics = step(state, eeg_d[torch.as_tensor(idx, device=device)],
                                      step_generator(cfg.seed, state.step))
                losses.append(metrics["loss"])
                if guard is not None:
                    guard.exit_if_requested(save)
            loss = float(torch.stack(losses).float().mean())  # one sync per epoch
            check_finite_loss(loss, epoch)
            dt = time.perf_counter() - t0
            history["loss"].append(loss)
            history["epoch_time_s"].append(dt)
            history["windows_per_s"].append(len(losses) * global_batch / dt)
            log_fn(f"EPOCH {epoch} dino_loss: {loss:.6f} "
                   f"({history['windows_per_s'][-1]:.1f} windows/s)")
            if resume is not None:
                save()
            if checkpoint_cb is not None:
                with gathered_dino_state(state):
                    checkpoint_cb(epoch, state)
    return state, history
