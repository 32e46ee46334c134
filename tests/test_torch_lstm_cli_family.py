"""The port's LSTM CLI family against the JAX package on the CPU: the score
artifacts byte for byte, `evaluate`, `Model` loaded from either checkpoint
layout with its shape read from the weights, and each new CLI end to end
(lstm_distill, lstm_distill_from_dinov2_train_spampinato, lstm_distillation,
lstm_distill_from_dinov2_eval, lstm_distill_retrieval), the JAX eval and
retrieval CLIs reading the port's checkpoints and scoring as the port's do.

Tolerances: the artifacts exactly (same distances and indices); features of
a loaded model to 1e-5 (f32, sums in another order); recall and precision
of the CLIs exactly (the same top-5 neighbours)."""

import argparse
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.cli import lstm_distill_from_dinov2_eval as jax_eval_cli
from cerebra.cli import lstm_distill_retrieval as jax_retrieval_cli
from cerebra.data import make_synthetic_corpus as jax_synthetic
from cerebra.eval import scores as jscores
from cerebra.models.lstm import Model as JaxModel
from cerebra.models.lstm import export_torch_state_dict, import_torch_state_dict
from cerebra.train import checkpoints as jck
from cerebra_torch.cli import (
    lstm_distill,
    lstm_distill_from_dinov2_eval,
    lstm_distill_from_dinov2_train_spampinato,
    lstm_distill_retrieval,
    lstm_distillation,
)
from cerebra_torch.data import make_synthetic_corpus
from cerebra_torch.eval import scores as tscores
from cerebra_torch.models import model_from_state_dict

torch.set_num_threads(1)

SMALL = ["--synthetic", "--device", "cpu", "--use_bf16", "false", "--synthetic_classes", "4",
         "--synthetic_per_class", "5", "--synthetic_channels", "6", "--synthetic_samples", "40",
         "--time_low", "4", "--time_high", "36", "--feature_dim", "16"]


def _catalogs():
    kw = dict(seed=1, n_per_class=3, n_classes=5, n_channels=2, n_samples=8)
    return jax_synthetic(**kw).catalog, make_synthetic_corpus(**kw).catalog


def test_score_artifacts_are_byte_identical_to_jax(tmp_path):
    jcat, tcat = _catalogs()
    assert dataclasses.astuple(jcat) == dataclasses.astuple(tcat)
    rng = np.random.default_rng(0)
    D = np.sort(rng.random((12, 5)).astype(np.float32), axis=1)
    I = rng.integers(0, 20, size=(12, 5))
    g_ids, q_ids = rng.integers(0, 5, size=20), rng.integers(0, 5, size=12)
    meta = {"flags": {"topK": 5, "seed": 43}}
    want = jscores.build_class_scores(D, I, g_ids, q_ids, jcat, meta)
    got = tscores.build_class_scores(D, I, g_ids, q_ids, tcat, meta)
    assert got == want
    r = float(np.mean([c["Recall"] for c in got["data"].values()]))
    p = float(np.mean([c["Precision"] for c in got["data"].values()]))
    wp = jscores.save_score_artifacts(str(tmp_path / "jax"), "synthetic", want, r, p)
    gp = tscores.save_score_artifacts(str(tmp_path / "port"), "synthetic", got, r, p)
    for a, b in zip(gp, wp):
        assert os.path.basename(a) == os.path.basename(b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a


def test_evaluate_matches_jax():
    jcat, tcat = _catalogs()
    rng = np.random.default_rng(1)
    gallery = rng.normal(size=(30, 8)).astype(np.float32)
    query = rng.normal(size=(9, 8)).astype(np.float32)
    g_ids, q_ids = list(rng.integers(0, 5, size=30)), list(rng.integers(0, 5, size=9))
    jr, jp, js = jscores.evaluate(gallery, query, g_ids, q_ids, jcat, top_k=4)
    tr, tp, ts = tscores.evaluate(torch.from_numpy(gallery), torch.from_numpy(query), g_ids,
                                  q_ids, tcat, top_k=4)
    assert (tr, tp) == (jr, jp)
    for name, entry in ts["data"].items():
        want = js["data"][name]
        for k in ("TP", "classIntanceRetrival", "TotalRetrival", "TotalClass", "Predicted",
                  "Recall", "Precision"):
            assert entry[k] == want[k], (name, k)
        assert entry["Topk"]["labels"] == want["Topk"]["labels"]
        np.testing.assert_allclose(entry["Topk"]["scores"], want["Topk"]["scores"], rtol=1e-5)


@pytest.mark.parametrize("layout", ["flat", "ddp_prefixed", "no_top", "dino_teacher"])
def test_model_loads_either_layout_with_its_shape_from_the_weights(layout, tmp_path):
    C, H, L, F, K, T = 5, 7, 3, 6, 4, 9
    include_top = layout != "no_top"
    jm = JaxModel(input_size=C, lstm_size=H, lstm_layers=L, output_size=F, n_classes=K,
                  include_top=include_top)
    params = jax.tree.map(np.array, jm.init(jax.random.key(3), jnp.zeros((1, T, C)))["params"])
    eeg = np.random.default_rng(2).normal(size=(4, T, C)).astype(np.float32)
    path = str(tmp_path / "w.pth")
    if layout == "dino_teacher":
        wrapped = {"backbone": {"lstm": params["lstm"]},
                   "head": {"Dense_0": {"kernel": np.zeros((H, 4), np.float32),
                                        "bias": np.zeros(4, np.float32)},
                            "last_layer": {"v": np.ones((4, 3), np.float32),
                                           "g": np.ones(3, np.float32)}}}
        jck.export_dino_pth(path, wrapped, wrapped, np.zeros((1, 3), np.float32), 0)
        want = jm.apply({"params": params}, jnp.asarray(eeg), features_only=True)
    else:
        sd = export_torch_state_dict({"params": params})
        pre = "module." if layout == "ddp_prefixed" else ""
        torch.save({pre + k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                   path)
        want = jm.apply({"params": params}, jnp.asarray(eeg))
        want = want[0] if include_top else want
    model = lstm_distill_from_dinov2_eval.load_model(
        argparse.Namespace(custom_model_weights=path, seed=0), C, 99, torch.device("cpu"))
    assert model.lstm.num_layers == L and model.lstm.hidden_size == H
    assert hasattr(model, "fc") == (layout != "dino_teacher")
    assert model.include_top == (layout in ("flat", "ddp_prefixed"))
    got = lstm_distill_from_dinov2_eval.features(model, eeg, torch.device("cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _jax_flags(argv):
    return [a for a in argv if a not in ("--device", "cpu")]


def test_lstm_distill_cli_and_both_retrieval_clis_match_jax(tmp_path):
    log_dir = str(tmp_path / "distill")
    model, hist = lstm_distill.main(SMALL + ["--num_epochs", "2", "--log_dir", log_dir])
    assert len(hist["train_loss"]) == 2 and np.isfinite(hist["train_loss"]).all()
    assert [e for e, _ in hist["val_loss"]] == [1]  # validation every epoch past the first
    assert model.lstm.num_layers == 4 and model.lstm.hidden_size == 6
    pth = os.path.join(log_dir, "lstm_best_loss.pth")
    sd = torch.load(pth, map_location="cpu")
    assert sorted(import_torch_state_dict(sd)["params"]) == ["fc", "head", "lstm"]
    for leak in ([], ["--compat_reference_leak"]):
        argv = SMALL + ["--custom_model_weights", pth, *leak]
        got = lstm_distill_retrieval.main(argv + ["--log_dir", str(tmp_path / f"r{len(leak)}")])
        want = jax_retrieval_cli.main(_jax_flags(argv) + ["--log_dir",
                                                          str(tmp_path / f"j{len(leak)}")])
        assert got == want
        for name in ("synthetic_Scores.pth", "synthetic_Scores.txt", "synthetic_.csv"):
            assert os.path.exists(tmp_path / f"r{len(leak)}" / name)


def test_spampinato_cli_writes_its_best_weights(tmp_path):
    log_dir = str(tmp_path / "sp")
    model, hist = lstm_distill_from_dinov2_train_spampinato.main(
        SMALL + ["--num_epochs", "6", "--hyperprams", "{'alpha': 0.3, 'temperature': 3.0}",
                 "--log_dir", log_dir])
    assert len(hist["train_loss"]) == 6 and np.isfinite(hist["train_loss"]).all()
    assert [e for e, _ in hist["val_loss"]] == [5]
    sd = torch.load(os.path.join(log_dir, "lstm_dinov2_best_loss.pth"), map_location="cpu")
    assert model_from_state_dict(sd, 6).lstm.num_layers == 4


def test_lstm_distillation_cli_and_the_jax_eval_cli_read_its_checkpoint(tmp_path):
    # the auto-resume installs a process-wide preemption handler: put the old ones back
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    log_dir = str(tmp_path / "dino")
    base = ["--synthetic", "--device", "cpu", "--use_bf16", "false", "--synthetic_classes", "2",
            "--synthetic_per_class", "3", "--synthetic_channels", "8", "--out_dim", "16",
            "--batch_size_per_gpu", "4", "--saveckp_freq", "1", "--log_dir", log_dir]
    try:
        state, hist = lstm_distillation.main(base + ["--epochs", "1"])
        assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"]).all() and state.step == 1
        for name in ("checkpoint.pth", "checkpoint0000.pth", "log.txt"):
            assert os.path.exists(os.path.join(log_dir, name)), name
        ckpt = torch.load(os.path.join(log_dir, "checkpoint.pth"), weights_only=False)
        assert ckpt["epoch"] == 1 and ckpt["optimizer"]["param_groups"][0]["params"]
        assert not any(".fc." in k for k in ckpt["teacher"])
        # the auto-resume finds epoch 0 done and runs epoch 1 alone
        state, hist = lstm_distillation.main(base + ["--epochs", "2"])
        assert len(hist["loss"]) == 1 and state.step == 2
        with open(os.path.join(log_dir, "log.txt")) as f:
            assert [int(line.split('"epoch": ')[1].rstrip("}\n")) for line in f] == [0, 1]
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)

    argv = ["--synthetic", "--synthetic_classes", "2", "--synthetic_per_class", "3",
            "--synthetic_channels", "8", "--custom_model_weights",
            os.path.join(log_dir, "checkpoint.pth")]
    got = lstm_distill_from_dinov2_eval.main(argv + ["--device", "cpu", "--log_dir",
                                                     str(tmp_path / "eval")])
    want = jax_eval_cli.main(argv + ["--log_dir", str(tmp_path / "jeval")])
    assert got == want
    for name in ("synthetic_Scores.pth", "synthetic_Scores.txt", "synthetic_.csv"):
        assert os.path.exists(tmp_path / "eval" / name)


@pytest.mark.parametrize("cli", [lstm_distill, lstm_distill_from_dinov2_train_spampinato,
                                 lstm_distillation, lstm_distill_from_dinov2_eval,
                                 lstm_distill_retrieval], ids=lambda m: m.__name__.split(".")[-1])
def test_new_clis_raise_on_cuda_without_a_gpu(cli, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        cli.main(["--synthetic", "--device", "cuda", "--log_dir", str(tmp_path)])
