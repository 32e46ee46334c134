"""The port's training slice against the JAX package: ten RMSprop steps of
the feature-distillation step from the same weights and batches (f32, loss
per step within 1e-5), the data layer bit for bit, and the CLI end to end
on the CPU with its checkpoint read back by the JAX package."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.data import EEGCorpus as JaxCorpus
from cerebra.data import make_synthetic_corpus as jax_synthetic
from cerebra.data import random_split_indices as jax_split
from cerebra.data import save_corpus_pth
from cerebra.data.schema import RawCorpus
from cerebra.losses import feature_distribution_loss_v1 as jax_v1
from cerebra.models.lstm import Model as JaxModel
from cerebra.models.lstm import import_torch_state_dict
from cerebra.train.optim import make_optimizer as jax_optimizer
from cerebra.train.steps import TrainState, make_feature_distill_step
from cerebra_torch.cli import lstm_distill_from_dinov2_train as cli
from cerebra_torch.data import EEGCorpus, make_synthetic_corpus, random_split_indices
from cerebra_torch.losses import feature_distribution_loss_v1, teacher_temp_schedule
from cerebra_torch.models import Model, params_from_jax
from cerebra_torch.train.optim import make_optimizer
from cerebra_torch.train.steps import feature_distill_step

torch.set_num_threads(1)


def test_ten_rmsprop_steps_match_jax():
    C, H, F, K, B, T = 6, 5, 8, 4, 4, 10
    temps = teacher_temp_schedule(1.5, 0.22, 4, 10).astype(np.float32)
    jm = JaxModel(input_size=C, lstm_size=H, lstm_layers=2, output_size=F, n_classes=K,
                  input_grad=False)
    params = jm.init(jax.random.key(0), jnp.zeros((1, T, C)))["params"]
    tx = jax_optimizer("rmsprop", 1e-3)
    state = TrainState.create(apply_fn=jm.apply, params=params, tx=tx)
    temps_j = jnp.asarray(temps)
    jax_step = make_feature_distill_step(
        jm.apply, tx,
        lambda f, c, t, y, e: jax_v1(f, t, y, c, temperature=temps_j[e]), donate=False,
    )

    model = Model(C, H, 2, F, n_classes=K)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    opt = make_optimizer("rmsprop", model.parameters(), 1e-3)

    def loss_fn(f, c, t, y, e):
        return feature_distribution_loss_v1(f, t, y, c, temperature=float(temps[e]))

    rng = np.random.default_rng(0)
    for i in range(10):
        eeg = rng.normal(size=(B, T, C)).astype(np.float32)
        teacher = rng.normal(size=(B, F)).astype(np.float32)
        labels = rng.integers(0, K, size=B)
        epoch = i // 3
        state, metrics = jax_step(state, jnp.asarray(eeg), jnp.asarray(teacher),
                                  jnp.asarray(labels), epoch)
        got = feature_distill_step(model, opt, loss_fn, torch.from_numpy(eeg),
                                   torch.from_numpy(teacher), torch.from_numpy(labels), epoch)
        np.testing.assert_allclose(got.item(), float(metrics["loss"]), atol=1e-5,
                                   err_msg=f"step {i}")


def test_synthetic_corpus_and_split_are_bit_equal():
    kw = dict(seed=3, n_per_class=4, n_classes=3, n_channels=5, n_samples=40,
              n_subjects=2, feature_dim=7, class_signal_scale=1.5)
    want, got = jax_synthetic(**kw), make_synthetic_corpus(**kw)
    for name in ("eeg", "labels", "image_idx", "subjects", "image_features",
                 "channel_means", "channel_stds"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (got.mean, got.std, got.image_names) == (want.mean, want.std, want.image_names)
    # the two packages' LabelCatalog classes differ, so compare their fields
    assert dataclasses.astuple(got.catalog) == dataclasses.astuple(want.catalog)
    for n in (12, 1200):
        for a, b in zip(random_split_indices(n, [0.8, 0.2], seed=43), jax_split(n, [0.8, 0.2], seed=43)):
            np.testing.assert_array_equal(a, b)


def test_pth_corpus_loads_like_jax(tmp_path):
    rng = np.random.default_rng(4)
    n, c, t = 6, 3, 20
    raw = RawCorpus(
        eeg=rng.normal(size=(n, c, t)).astype(np.float32),
        labels=np.array([0, 1, 0, 1, 1, 0], np.int32),
        image_idx=np.arange(n, dtype=np.int32),
        subjects=np.array([1, 2, 1, 2, 1, 2], np.int32),
        wnids=["n01", "n02"], image_names=[f"img{i}" for i in range(n)],
        means=np.zeros(c, np.float32), stddevs=np.ones(c, np.float32),
    )
    path = str(tmp_path / "corpus.pth")
    save_corpus_pth(path, raw)
    want = JaxCorpus.from_pth(path, subject=2).window(2, 15)
    got = EEGCorpus.from_pth(path, subject=2).window(2, 15)
    for name in ("eeg", "labels", "image_idx", "subjects", "channel_means"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def test_cli_trains_on_cpu_and_jax_reads_its_checkpoint(tmp_path):
    C, F, K = 8, 16, 4
    log_dir = str(tmp_path / "run")
    model, hist = cli.main([
        "--synthetic", "--device", "cpu", "--num_epochs", "6", "--use_bf16", "false",
        "--synthetic_classes", str(K), "--synthetic_per_class", "8",
        "--synthetic_channels", str(C), "--synthetic_samples", "48",
        "--time_low", "4", "--time_high", "36", "--feature_dim", str(F),
        "--log_dir", log_dir,
    ])
    assert len(hist["train_loss"]) == 6 and all(np.isfinite(hist["train_loss"]))
    assert [e for e, _ in hist["recall"]] == [5]
    pth = os.path.join(log_dir, "lstm_dinov2_best_loss.pth")
    assert os.path.exists(os.path.join(log_dir, "log.txt"))
    sd = torch.load(pth, map_location="cpu")

    eeg = np.random.default_rng(5).normal(size=(3, 32, C)).astype(np.float32)
    port = Model(C, C, 2, F, n_classes=K)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(eeg))[0].numpy()
    jm = JaxModel(input_size=C, lstm_size=C, lstm_layers=2, output_size=F, n_classes=K)
    want = jm.apply(import_torch_state_dict(sd), jnp.asarray(eeg))[0]
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_cli_raises_on_cuda_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        cli.main(["--synthetic", "--device", "cuda", "--log_dir", str(tmp_path)])


def test_cli_profile_dir_writes_a_trace(tmp_path):
    """`--profile_dir` writes a torch.profiler trace of the training loop
    there, as the JAX CLI writes its jax.profiler trace."""
    prof_dir = tmp_path / "prof"
    _, hist = cli.main([
        "--synthetic", "--device", "cpu", "--num_epochs", "1", "--use_bf16", "false",
        "--synthetic_classes", "4", "--synthetic_per_class", "4", "--synthetic_channels", "8",
        "--synthetic_samples", "48", "--time_low", "4", "--time_high", "36",
        "--feature_dim", "16", "--log_dir", str(tmp_path / "run"),
        "--profile_dir", str(prof_dir),
    ])
    assert len(hist["train_loss"]) == 1
    traces = [p for p in prof_dir.iterdir() if p.name.endswith(".pt.trace.json")]
    assert traces and traces[0].stat().st_size > 0, list(prof_dir.iterdir())
