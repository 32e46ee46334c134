"""Cross-modal Barlow Twins training (port of cerebra/train/barlow_recipe.py;
EEG-BarlowNetworks/train.py:50-190).

Per step: y1 = an image, y2 = the mel spectrogram stack of its EEG trial.
The reference computes librosa mels on the host per batch (train.py:
144-145); here the whole corpus is spectrogrammed once on the device, in
chunks of 256 trials, and the steps index it. LARS with separate weight and
bias learning rates (learning_rate_weights 0.2 / learning_rate_biases
0.0048, the bias-filtered variant of EEG-BarlowNetworks/optim.py:5-44)
under the warmup + cosine schedule (barlow_utils.py:8-21). The epoch order
comes from `epoch_batches(n, B, seed, epoch)`, as in JAX; the epoch is a
Python loop over steps (the JAX package scans it).

The model computes in f32. Convolutions follow torch's
`torch.backends.cudnn.allow_tf32` (True by default: TF32 on the tensor
cores), matrix products `torch.backends.cuda.matmul.allow_tf32` (False by
default).

With a `mesh` (cerebra/train/barlow_recipe.py:61-80, 164-218; the
multi-process DDP world of train.py:71-99) each data rank spectrograms and
holds its block of the corpus and trains on its rows of every global batch
(`local_epoch_indices`), BatchNorm takes its statistics over the global
batch (SyncBN, train.py:89-90), the loss sums c over the data group, and the
model trains under DDP.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from cerebra_torch.data.sampling import epoch_batches
from cerebra_torch.losses.barlow import barlow_twins_loss
from cerebra_torch.models.barlow import BarlowTwins, graft_pretrained_towers
from cerebra_torch.models.batchnorm import sync_batchnorm
from cerebra_torch.parallel.dataflow import local_epoch_indices, put_replicated, shard_corpus
from cerebra_torch.parallel.mesh import data_parallel
from cerebra_torch.signal.spectro import mel_fft_size, mel_filterbank, melspectrogram
from cerebra_torch.train.optim import Lars
from cerebra_torch.train.resume import check_finite_loss
from cerebra_torch.train.schedules import barlow_learning_rate

SPECTROGRAM_CHUNK = 256  # trials a chunk: the STFT's intermediates, not the step, set the peak


@dataclasses.dataclass
class BarlowConfig:
    """Defaults from EEG-BarlowNetworks/train.py:32-43, as the JAX
    package's (f32 only: its `dtype` field is left out)."""

    epochs: int = 10
    batch_size: int = 16
    learning_rate_weights: float = 0.2
    learning_rate_biases: float = 0.0048
    weight_decay: float = 1e-6
    lambd: float = 0.0051
    projector: Tuple[int, ...] = (8192, 8192, 8192)
    n_mels: int = 224
    image_size: int = 224
    warmup_epochs: int = 10
    seed: int = 0
    # a local torchvision resnet50 .pth for both towers (an extension: the
    # reference's towers start from random init, net.py:15-19)
    pretrained_backbone: str = ""
    # nested stage + block checkpointing in both ResNet towers
    remat: bool = False


@torch.no_grad()
def barlow_spectrogram(eeg: np.ndarray, n_mels: int, sample_rate: float,
                       device: torch.device) -> torch.Tensor:
    """(N, T, C) EEG → (N, n_mels, frames, C) NHWC mel spectrograms on
    `device`, a chunk of SPECTROGRAM_CHUNK trials at a time (only a chunk of
    the EEG is ever on the device)."""
    n, t_len, c = eeg.shape
    mel_w = torch.from_numpy(mel_filterbank(sample_rate, mel_fft_size(t_len), n_mels)).to(device)
    out = None
    for i in range(0, n, SPECTROGRAM_CHUNK):
        e = torch.from_numpy(np.ascontiguousarray(eeg[i:i + SPECTROGRAM_CHUNK], np.float32))
        m = melspectrogram(e.to(device).transpose(1, 2), sr=sample_rate, n_mels=n_mels,
                           mel_weights=mel_w)  # (n_chunk, C, M, F)
        if out is None:
            out = torch.empty((n, n_mels, m.shape[-1], c), device=device)
        out[i:i + len(e)] = m.permute(0, 2, 3, 1)
        del e, m
    return out


def barlow_optimizer(model: BarlowTwins, cfg: BarlowConfig, niter: int) -> Lars:
    """LARS in the JAX recipe's two groups (its optax.multi_transform): `w`
    (ndim > 1) at base·learning_rate_weights with decay and the trust
    ratio, `b` at base·learning_rate_biases with neither. Each group's
    `schedule` holds its learning rate by update, in f32."""
    base = barlow_learning_rate(cfg.epochs, niter, cfg.batch_size, cfg.warmup_epochs)
    params = list(model.parameters())
    return Lars([
        dict(params=[p for p in params if p.dim() > 1], weight_decay=cfg.weight_decay,
             trust_ratio=True, schedule=(base * cfg.learning_rate_weights).astype(np.float32)),
        dict(params=[p for p in params if p.dim() <= 1], weight_decay=0.0, trust_ratio=False,
             schedule=(base * cfg.learning_rate_biases).astype(np.float32)),
    ], lr=0.0, trust_coefficient=0.001)


def barlow_step(model: BarlowTwins, optimizer: Lars, y1: torch.Tensor, y2: torch.Tensor,
                update: int, lambd: float = 0.0051, group=None) -> torch.Tensor:
    """One training step, update number `update` (its learning rates are
    `schedule[min(update, len - 1)]`) → the loss on the device. Under a
    data `group` y1, y2 are this rank's rows and the loss is the global
    batch's."""
    for param_group in optimizer.param_groups:
        sched = param_group["schedule"]
        param_group["lr"] = float(sched[min(update, len(sched) - 1)])
    model.train()
    z1, z2 = model(y1, y2)
    loss = barlow_twins_loss(z1, z2, lambd=lambd, group=group)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def barlow_train(
    images: np.ndarray,  # (N, H, W, 3) NHWC
    eeg: np.ndarray,  # (N, T, C), spectrogrammed here
    config: BarlowConfig = BarlowConfig(),
    sample_rate: float = 256.0,
    log_fn: Callable[[str], None] = print,
    device: torch.device = torch.device("cuda"),
    mesh=None,
) -> Tuple[BarlowTwins, Dict[str, List]]:
    """→ (the trained model, history: `loss` (each epoch's mean step loss)
    and `epoch_time_s`), on one device or over a `mesh` (module
    docstring)."""
    cfg = config
    n = len(images)
    niter = max(n // cfg.batch_size, 1)
    n_data = mesh.size("data") if mesh else 1
    if cfg.batch_size % n_data:
        # the reference asserts batch divisibility too (train.py:129)
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by data-axis size {n_data}")
    if mesh is not None:
        images, n_local = shard_corpus(mesh, np.asarray(images, np.float32))
        eeg = shard_corpus(mesh, np.asarray(eeg, np.float32))[0]
    y2_all = barlow_spectrogram(eeg, cfg.n_mels, sample_rate, device)
    y1_all = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(device)

    model = BarlowTwins(cfg.projector, eeg_in_channels=eeg.shape[-1], remat=cfg.remat,
                        generator=torch.Generator().manual_seed(cfg.seed))
    if cfg.pretrained_backbone:
        graft_pretrained_towers(model, cfg.pretrained_backbone)
    model.to(device)
    optimizer = barlow_optimizer(model, cfg, niter)
    group, train_model = None, model
    if mesh is not None:
        group = mesh.group("data")
        put_replicated(model)
        sync_batchnorm(model, group)
        train_model = data_parallel(model, mesh)

    def epoch_indices(epoch):
        if mesh is None:
            return epoch_batches(n, cfg.batch_size, seed=cfg.seed, epoch=epoch)[0][:niter]
        return local_epoch_indices(n_local, n_data, cfg.batch_size // n_data, niter, cfg.seed,
                                   epoch)[:, mesh.index("data")]

    history: Dict[str, List] = {"loss": [], "epoch_time_s": []}
    update = 0
    for epoch in range(cfg.epochs):
        t0 = time.perf_counter()
        losses = []
        for idx in torch.from_numpy(np.asarray(epoch_indices(epoch))).to(device):
            losses.append(barlow_step(train_model, optimizer, y1_all[idx], y2_all[idx], update,
                                      cfg.lambd, group))
            update += 1
        loss = float(np.mean(torch.stack(losses).cpu().numpy()))  # one sync an epoch
        check_finite_loss(loss, epoch)
        history["loss"].append(loss)
        history["epoch_time_s"].append(time.perf_counter() - t0)
        log_fn(f"EPOCH {epoch} barlow_loss: {loss:.4f}")
    return model, history
