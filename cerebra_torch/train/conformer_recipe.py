"""Conformer ExP trainer (port of cerebra/train/conformer_recipe.py; the
reference's self-contained BCI-IV recipe, utils/Conformer.py:222-417).

- BCI-IV 2a `.mat` ingest (`get_source_data`, :281-320): A0{n}T / A0{n}E,
  (time, electrode, trial) → (trial, 1, 22, 1000), labels 1..4 → 0..3,
  both splits standardised by the train set's mean and std.
- Segmentation and Reconstruction (S&R, `interaug`, :254-281): per class,
  new trials stitched from 8 temporal segments of same-class trials,
  segment j from the j-th sampled trial, then shuffled. The draw
  (`draw_interaug`, from a torch.Generator) and the gather
  (`interaug_gather`, draws as data) are apart.
- The loop (:322-417): each step is the real batch concatenated with one
  augmented batch; Adam (lr 2e-4, betas (0.5, 0.999), eps 1e-8);
  cross-entropy over the model's 384-wide output against labels 0..3 (the
  reference's documented quirk, :197-205, :374); the epoch order is
  `np.random.default_rng((seed, epoch)).permutation(n)`, wrap-padded; the
  logged loss is the last step's; the test set is scored every
  `eval_every` epochs, with best and average accuracy and the
  `log_subject{n}.txt` "epoch    acc" lines (:389-399).

Dropout and S&R draw from one torch.Generator on the device, seeded by
`seed`; the JAX package's draws come from its PRNG keys, so the two runs
see other masks and other augmented trials from the same seed.

With a `mesh` (cerebra/train/conformer_recipe.py:240-265) the corpus stays
replicated: every rank draws the same global batch and the same S&R batch
from the same seed, keeps its rows of their concatenation, and trains
under DDP over the data group with BatchNorm's statistics and the loss
taken over the global batch. Dropout then draws from a stream of each
rank's own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cerebra_torch.models.batchnorm import sync_batchnorm
from cerebra_torch.models.conformer import Conformer
from cerebra_torch.models.dropout import Drop, dropout_from
from cerebra_torch.parallel.collectives import pmean
from cerebra_torch.parallel.dataflow import put_replicated, rank_seed
from cerebra_torch.parallel.mesh import data_parallel
from cerebra_torch.train.resume import check_finite_loss


@dataclasses.dataclass
class ExPConfig:
    """Defaults from utils/Conformer.py:223-231, as the JAX package's."""

    batch_size: int = 72
    n_epochs: int = 2000
    n_classes: int = 4
    lr: float = 2e-4
    b1: float = 0.5
    b2: float = 0.999
    n_segments: int = 8
    emb_size: int = 40
    depth: int = 6
    out_features: int = 384
    eval_every: int = 1
    seed: int = 0
    dtype: Optional[torch.dtype] = None

    @property
    def n_aug_per_class(self) -> int:
        """S&R outputs per class per step (reference: batch_size/4)."""
        return max(self.batch_size // self.n_classes, 1)

    @property
    def step_batch(self) -> int:
        """Rows of one step: real + augmented."""
        return self.batch_size + self.n_aug_per_class * self.n_classes


def load_bciiv_mat(root: str, subject: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """BCI-IV 2a ingest (utils/Conformer.py:281-320) → standardised
    (train_data (N,1,C,T), train_labels 0-based, test_data, test_labels)."""
    import scipy.io as sio

    def load(split):
        mat = sio.loadmat(os.path.join(root, f"A0{subject}{split}.mat"))
        data = np.transpose(mat["data"], (2, 1, 0))[:, None]  # (N, 1, C, T)
        labels = np.transpose(mat["label"])[0].astype(np.int64) - 1
        return data.astype(np.float32), labels

    train_data, train_labels = load("T")
    test_data, test_labels = load("E")
    mean, std = train_data.mean(), train_data.std()  # train stats for both
    return (
        (train_data - mean) / std, train_labels,
        (test_data - mean) / std, test_labels,
    )


def make_synthetic_bciiv(
    seed: int = 0, n_per_class: int = 36, n_classes: int = 4,
    n_channels: int = 22, n_samples: int = 1000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Class-coded sinusoid + noise in the BCI-IV shape (the synthetic-EEG
    fake-backend pattern, utils/GenerateRandomEEGNoise.py)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_samples) / 250.0
    data, labels = [], []
    for c in range(n_classes):
        carrier = np.sin(2 * np.pi * (6.0 + 4.0 * c) * t)
        chan_gain = rng.normal(size=(n_channels, 1)) * 0.5 + 1.0
        for _ in range(n_per_class):
            x = 1.5 * chan_gain * carrier + rng.normal(size=(n_channels, n_samples))
            data.append(x[None].astype(np.float32))
            labels.append(c)
    data = np.stack(data)  # (N, 1, C, T)
    labels = np.asarray(labels, dtype=np.int64)
    perm = rng.permutation(len(data))
    return data[perm], labels[perm]


def interaug_table(labels: np.ndarray, n_classes: int) -> Tuple[np.ndarray, np.ndarray]:
    """(table (n_classes, max count): each class's trial ids, padded with its
    first; counts (n_classes,)). Raises for a class with no trials."""
    counts = np.bincount(labels, minlength=n_classes)[:n_classes]
    table = np.zeros((n_classes, int(counts.max())), dtype=np.int64)
    for c in range(n_classes):
        idx = np.where(labels == c)[0]
        if len(idx) == 0:
            raise ValueError(f"class {c} has no trials for S&R augmentation")
        table[c, : len(idx)] = idx
        table[c, len(idx):] = idx[0]  # padding, never drawn
    return table, counts


def draw_interaug(generator: torch.Generator, counts: torch.Tensor, n_per_class_out: int,
                  n_segments: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(idx (n_classes, n_per_class_out, n_segments): a draw in [0, count) of
    each class's table, perm: a permutation of the n_classes·n_per_class_out
    outputs), on the generator's device."""
    n_classes = len(counts)
    u = torch.rand((n_classes, n_per_class_out, n_segments), generator=generator,
                   device=generator.device)
    c = counts.to(generator.device)[:, None, None]
    idx = torch.minimum((u * c).long(), c - 1)
    perm = torch.randperm(n_classes * n_per_class_out, generator=generator,
                          device=generator.device)
    return idx, perm


def interaug_gather(data: torch.Tensor, table: torch.Tensor, idx: torch.Tensor,
                    perm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """S&R from given draws: output (c, o) takes segment j of trial
    table[c, idx[c, o, j]], then the outputs are put in `perm` order →
    (aug (n_classes·n_out, 1, C, T), labels)."""
    N, _, C, T = data.shape
    n_classes, n_out, n_segments = idx.shape
    src = table[torch.arange(n_classes, device=idx.device)[:, None, None], idx]
    data_r = data.reshape(N, C, n_segments, T // n_segments)
    j = torch.arange(n_segments, device=idx.device)[None, None, :]
    picked = data_r[src, :, j, :]  # (cls, out, seg, C, seg_len)
    aug = picked.permute(0, 1, 3, 2, 4).reshape(n_classes * n_out, 1, C, T)
    labels = torch.arange(n_classes, device=idx.device).repeat_interleave(n_out)
    return aug[perm], labels[perm]


def conformer_step(model: Conformer, optimizer: torch.optim.Optimizer, x: torch.Tensor,
                   y: torch.Tensor, drop: Optional[Drop] = None, group=None) -> torch.Tensor:
    """One Adam step on cross-entropy over the full output (f32) → the loss
    on the device; under a data `group` x, y are this rank's rows and the
    loss is the global batch's mean."""
    model.train()
    _, out = model(x, drop)
    loss = F.cross_entropy(out.float(), y)
    if group is not None:
        loss = pmean(loss, group)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def evaluate(model: Conformer, x: torch.Tensor, y: torch.Tensor
             ) -> Tuple[float, float, np.ndarray]:
    """(test loss, accuracy, predictions) in eval mode."""
    model.eval()
    _, out = model(x)
    loss = F.cross_entropy(out.float(), y)
    pred = out.argmax(dim=-1)
    return float(loss), float((pred == y).float().mean()), pred.cpu().numpy()


def conformer_exp_train(
    train_data: np.ndarray,
    train_labels: np.ndarray,
    test_data: np.ndarray,
    test_labels: np.ndarray,
    config: ExPConfig = ExPConfig(),
    log_fn: Callable[[str], None] = print,
    log_write_path: Optional[str] = None,
    device: torch.device = torch.device("cuda"),
    mesh=None,
) -> Tuple[Conformer, Dict[str, List]]:
    """The ExP.train() loop (utils/Conformer.py:322-417) → (the model,
    history with best and average accuracy), on one device or over a `mesh`
    (module docstring)."""
    cfg = config
    n, _, C, T = train_data.shape
    model = Conformer(C, T, emb_size=cfg.emb_size, depth=cfg.depth,
                      out_features=cfg.out_features, dtype=cfg.dtype,
                      generator=torch.Generator().manual_seed(cfg.seed)).to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(cfg.b1, cfg.b2),
                                 eps=1e-8)
    gen = torch.Generator(device).manual_seed(cfg.seed)
    drop = dropout_from(gen)
    group, train_model, rows = None, model, slice(None)
    if mesh is not None:
        group, n_data, d = mesh.group("data"), mesh.size("data"), mesh.index("data")
        if cfg.step_batch % n_data:
            raise ValueError(f"step batch {cfg.step_batch} (batch_size + S&R) not divisible "
                             f"by data-axis size {n_data}")
        b = cfg.step_batch // n_data
        rows = slice(d * b, (d + 1) * b)
        put_replicated(model)
        sync_batchnorm(model, group)
        train_model = data_parallel(model, mesh)
        drop = dropout_from(torch.Generator(device).manual_seed(rank_seed(cfg.seed, d)))

    train_x = torch.from_numpy(np.ascontiguousarray(train_data, np.float32)).to(device)
    train_y = torch.from_numpy(train_labels.astype(np.int64)).to(device)
    test_x = torch.from_numpy(np.ascontiguousarray(test_data, np.float32)).to(device)
    test_y = torch.from_numpy(test_labels.astype(np.int64)).to(device)
    table, counts = (torch.from_numpy(a).to(device)
                     for a in interaug_table(train_labels, cfg.n_classes))

    history: Dict[str, List] = {"train_loss": [], "test_acc": [], "test_loss": [],
                                "epoch_time_s": []}
    best_acc, aver_acc, n_evals = 0.0, 0.0, 0
    best_pred = None
    niter = max(n // cfg.batch_size, 1)
    with open(log_write_path, "w") if log_write_path else contextlib.nullcontext() as log_file:
        for epoch in range(cfg.n_epochs):
            t0 = time.perf_counter()
            order = np.random.default_rng((cfg.seed, epoch)).permutation(n)
            need = niter * cfg.batch_size
            # a train set smaller than one batch wraps cyclically
            order = np.resize(order, need) if need > n else order[:need]
            for idx in torch.from_numpy(order.reshape(niter, cfg.batch_size)).to(device):
                aug_idx, perm = draw_interaug(gen, counts, cfg.n_aug_per_class,
                                              cfg.n_segments)
                aug_x, aug_y = interaug_gather(train_x, table, aug_idx, perm)
                x = torch.cat([train_x[idx], aug_x])[rows]
                y = torch.cat([train_y[idx], aug_y])[rows]
                loss_d = conformer_step(train_model, optimizer, x, y, drop, group)
            # the reference logs the last step's loss (utils/Conformer.py:380-386)
            loss = float(loss_d)
            check_finite_loss(loss, epoch)
            history["train_loss"].append(loss)
            history["epoch_time_s"].append(time.perf_counter() - t0)

            if (epoch + 1) % cfg.eval_every == 0:
                test_loss, acc, pred = evaluate(model, test_x, test_y)
                history["test_acc"].append((epoch, acc))
                history["test_loss"].append((epoch, test_loss))
                n_evals += 1
                aver_acc += acc
                if acc > best_acc:
                    best_acc, best_pred = acc, pred
                log_fn(f"Epoch: {epoch}  Train loss: {loss:.6f}  "
                       f"Test loss: {test_loss:.6f}  Test accuracy is {acc:.6f}")
                if log_file:
                    log_file.write(f"{epoch}    {acc}\n")

        aver_acc = aver_acc / max(n_evals, 1)
        history["best_acc"] = [best_acc]
        history["aver_acc"] = [aver_acc]
        history["best_pred"] = [best_pred]
        log_fn(f"The average accuracy is: {aver_acc}")
        log_fn(f"The best accuracy is: {best_acc}")
        if log_file:
            log_file.write(f"The average accuracy is: {aver_acc}\n")
            log_file.write(f"The best accuracy is: {best_acc}\n")
    return model, history

