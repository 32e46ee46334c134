"""The LSTM→DINOv2 feature-distillation recipe (port of
cerebra/train/recipes.py::feature_distill_train, single-device branch).

LstmDistillFromDinoV2Train.py:351-440: the LSTM regresses EEG windows onto
cached teacher (DINOv2) features with FeatureDistributionLoss v1 under
RMSprop; every `validation_frequency` epochs it scores top-k retrieval and
the validation loss and keeps the best-loss weights. Whole corpora live on
the device; batches are index gathers there.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from cerebra_torch.eval.retrieval import retrieval_recall_precision
from cerebra_torch.losses import feature_distribution_loss_v1, teacher_temp_schedule
from cerebra_torch.models.lstm import Model
from cerebra_torch.train.optim import make_optimizer
from cerebra_torch.train.resume import check_finite_loss
from cerebra_torch.train.steps import feature_distill_step


@dataclasses.dataclass
class FeatureDistillConfig:
    """Defaults = LstmDistillFromDinoV2Train.py flags/HyperParams
    (:16-25, :329: RMSprop lr 1e-3, batch 16, warmup T 1.5→0.22 over 50)."""

    num_epochs: int = 100
    batch_size: int = 16
    learning_rate: float = 1e-3
    lstm_size: int = 96
    lstm_layers: int = 2
    alpha: float = 0.5
    beta: float = 0.5
    warmup_teacher_temp: float = 1.5
    teacher_temp: float = 0.22
    warmup_teacher_temp_epochs: int = 50
    validation_frequency: int = 5
    top_k: int = 5
    seed: int = 43
    dtype: Optional[torch.dtype] = None


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
) -> Tuple[Model, Dict[str, List]]:
    """The README-blessed train() recipe. Returns (model, history)."""
    cfg = config
    if n_classes is None:
        n_classes = int(max(train_labels.max(), val_labels.max())) + 1

    model = Model(
        input_size=train_eeg.shape[-1], lstm_size=cfg.lstm_size, lstm_layers=cfg.lstm_layers,
        output_size=train_feats.shape[-1], include_top=True, n_classes=n_classes,
        dtype=cfg.dtype, device=device,
        generator=torch.Generator().manual_seed(cfg.seed),
    )
    optimizer = make_optimizer("rmsprop", model.parameters(), cfg.learning_rate)
    # f32 values, as the JAX recipe indexes an f32 array
    temps = teacher_temp_schedule(
        cfg.warmup_teacher_temp, cfg.teacher_temp, cfg.warmup_teacher_temp_epochs,
        cfg.num_epochs,
    ).astype(np.float32)

    def loss_fn(feats, cls_pred, teacher_feats, labels, epoch):
        return feature_distribution_loss_v1(
            feats, teacher_feats, labels, cls_pred, temperature=float(temps[epoch]),
            alpha=cfg.alpha, beta=cfg.beta,
        )

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
