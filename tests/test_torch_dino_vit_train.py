"""The port's main_dino slice against the JAX package on the CPU: three DINO
steps of `make_dino_step` from the same weights and views (f32, no drop
path: loss, center, student and teacher compared), the loss, center, clip,
cancel and EMA pieces, the host-side data helpers bit for bit, and the CLI
end to end.

Tolerances: the loss and center to 1e-5; parameters after three AdamW steps
to 2e-5 (the updates are ~1e-3 and differ only by the order of f32 sums in
the gradients), except the k slice of each qkv bias, whose gradient is zero
in exact arithmetic (see `_assert_params`); the numpy and indexing helpers
exactly."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.data.sampling import epoch_batches as jax_epoch_batches
from cerebra.losses import dino_multicrop_loss as jax_dino_loss
from cerebra.models._torch_interop import strip_torch_prefixes as jax_strip
from cerebra.models.heads import DINOHead as JaxHead
from cerebra.models.vit import VisionTransformer as JaxViT
from cerebra.signal.windows import tile_eeg_to_image as jax_tile
from cerebra.signal.windows import time_window as jax_time_window
from cerebra.train.ema import ema_update as jax_ema
from cerebra.train.optim import per_param_clip as jax_clip
from cerebra.train.schedules import cosine_scheduler as jax_cosine
from cerebra.train.steps import DinoTrainState as JaxState
from cerebra.train.steps import make_dino_step as jax_make_dino_step
from cerebra.train.steps import make_scheduled_optimizer as jax_scheduled_optimizer
from cerebra_torch.cli import main_dino as cli
from cerebra_torch.data import epoch_batches
from cerebra_torch.losses import dino_multicrop_loss
from cerebra_torch.models import heads, vit
from cerebra_torch.models._torch_interop import strip_torch_prefixes
from cerebra_torch.models.multicrop import MultiCropWrapper, multicrop_forward
from cerebra_torch.signal.windows import (
    multicrop_views,
    tile_eeg_to_image,
    tile_eeg_views,
    time_window,
    window_starts,
)
from cerebra_torch.train.ema import ema_update
from cerebra_torch.train.optim import cancel_last_layer_grads, per_param_clip
from cerebra_torch.train.schedules import cosine_scheduler
from cerebra_torch.train.steps import DinoTrainState, make_dino_step, make_scheduled_optimizer

torch.set_num_threads(1)

E, OUT, B = 32, 24, 3


def _jax_models():
    jv = JaxViT(img_size=16, patch_size=8, embed_dim=E, depth=2, num_heads=2)
    jh = JaxHead(in_dim=E, out_dim=OUT, hidden_dim=32, bottleneck_dim=8)
    bp = jv.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)))["params"]
    hp = jh.init(jax.random.key(1), jnp.zeros((1, E)))["params"]
    return jv, jh, {"backbone": bp, "head": hp}


def _torch_student(params):
    backbone = vit.VisionTransformer(img_size=16, patch_size=8, embed_dim=E, depth=2, num_heads=2)
    head = heads.DINOHead(E, OUT, hidden_dim=32, bottleneck_dim=8)
    model = MultiCropWrapper(backbone, head)
    model.load_state_dict(_state_dict(params), strict=True)
    return model


def _state_dict(params):
    params = jax.tree.map(np.asarray, params)
    sd = {f"backbone.{k}": v for k, v in vit.params_from_jax(params["backbone"], 2).items()}
    sd.update({f"head.{k}": v for k, v in heads.params_from_jax(params["head"]).items()})
    return sd


def _assert_params(model, params, atol, lr_total, what):
    """The k slice of each qkv bias is held only to the sum of the learning
    rates: softmax ignores a shift shared by all keys, so its gradient is
    zero in exact arithmetic, and Adam turns the f32 noise left in its place
    into steps of up to lr on both sides."""
    want = _state_dict(params)
    for name, p in model.state_dict().items():
        got, ref = p.numpy(), want[name].numpy()
        if name.endswith("attn.qkv.bias"):
            k = slice(E, 2 * E)
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=lr_total)
            got, ref = np.delete(got, np.r_[k]), np.delete(ref, np.r_[k])
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=f"{what} {name}")


def test_three_dino_steps_match_jax():
    rng = np.random.default_rng(0)
    niter, epochs = 2, 2
    lr = cosine_scheduler(1e-3, 1e-4, epochs, niter, warmup_epochs=0)
    wd = cosine_scheduler(0.04, 0.4, epochs, niter)
    mom = cosine_scheduler(0.9, 1.0, epochs, niter)
    temps = np.array([0.04, 0.07])
    views = [[rng.normal(size=(2, B, 16, 16, 3)).astype(np.float32),
              rng.normal(size=(2, B, 8, 8, 3)).astype(np.float32)] for _ in range(3)]

    jv, jh, params = _jax_models()
    tx = jax_scheduled_optimizer("adamw", lr, wd, params_mask_source=params, clip_grad=3.0)
    jstate = JaxState(step=jnp.zeros([], jnp.int32), student_params=params,
                      teacher_params=jax.tree.map(jnp.copy, params), opt_state=tx.init(params),
                      center=jnp.zeros((1, OUT)))
    jstep = jax_make_dino_step(
        backbone_apply=lambda p, x: jv.apply(p, x), head_apply=lambda p, f: jh.apply(p, f),
        tx=tx, lr_schedule=jnp.asarray(lr, jnp.float32), wd_schedule=jnp.asarray(wd, jnp.float32),
        momentum_schedule=jnp.asarray(mom, jnp.float32),
        teacher_temp_by_epoch=jnp.asarray(temps, jnp.float32), niter_per_ep=niter,
        view_fn=lambda key, batch: [jnp.asarray(v) for v in batch], freeze_last_layer=1,
    )

    student = _torch_student(params).train()
    teacher = copy.deepcopy(student).eval()
    for p in teacher.parameters():
        p.requires_grad_(False)
    state = DinoTrainState(step=0, student=student, teacher=teacher,
                           optimizer=make_scheduled_optimizer("adamw", student, lr, wd, 3.0),
                           center=torch.zeros(1, OUT))
    step = make_dino_step(lr, wd, mom, temps, niter,
                          view_fn=lambda gen, batch: [torch.from_numpy(v) for v in batch],
                          freeze_last_layer=1)

    v0 = _state_dict(params)["head.last_layer.weight_v"]  # the JAX step donates params
    for i in range(3):
        jstate, jm = jstep(jstate, views[i], jax.random.key(i))
        state, m = step(state, views[i])
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=0, atol=1e-5)
    assert state.step == 3
    np.testing.assert_allclose(state.center.numpy(), np.asarray(jstate.center), atol=1e-5)
    lr_total = float(lr[:3].sum())
    _assert_params(state.student, jstate.student_params, 2e-5, lr_total, "student")
    _assert_params(state.teacher, jstate.teacher_params, 2e-5, lr_total, "teacher")
    # epoch 0 zeroed the last-layer grads, yet AdamW decayed last_layer.v
    assert not torch.equal(state.student.state_dict()["head.last_layer.weight_v"], v0)


@pytest.mark.parametrize("pairing", [False, True], ids=["canonical", "compat"])
def test_dino_multicrop_loss_and_center_match_jax(pairing):
    rng = np.random.default_rng(1)
    s = rng.normal(size=(6, 4, 16)).astype(np.float32)
    t = rng.normal(size=(2, 4, 16)).astype(np.float32)
    c = rng.normal(size=(1, 16)).astype(np.float32) * 0.1
    jl, jc = jax_dino_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(c), 0.04,
                           compat_reference_pairing=pairing)
    tl, tc = dino_multicrop_loss(torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(c),
                                 0.04, compat_reference_pairing=pairing)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-7)


def test_clip_cancel_and_ema_match_jax():
    rng = np.random.default_rng(2)
    grads = {"a": rng.normal(size=(4, 5)).astype(np.float32) * 3,
             "b": rng.normal(size=(7,)).astype(np.float32) * 0.01}
    jg, _ = jax_clip(1.0).update(jax.tree.map(jnp.asarray, grads), None)
    ps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads.values()]
    for p, g in zip(ps, grads.values()):
        p.grad = torch.from_numpy(g.copy())
    per_param_clip(ps, 1.0)
    for p, k in zip(ps, grads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[k]), rtol=1e-6)

    model = MultiCropWrapper(torch.nn.Linear(3, 3), heads.DINOHead(3, 5, nlayers=1,
                                                                   bottleneck_dim=4))
    for p in model.parameters():
        p.grad = None
    cancel_last_layer_grads(model, epoch=0, freeze_last_layer=1)
    assert torch.equal(model.head.last_layer.weight_v.grad, torch.zeros(5, 4))
    assert model.backbone.weight.grad is None

    t = {"w": rng.normal(size=(3, 3)).astype(np.float32)}
    s = {"w": rng.normal(size=(3, 3)).astype(np.float32)}
    want = jax_ema(jax.tree.map(jnp.asarray, t), jax.tree.map(jnp.asarray, s), jnp.float32(0.996))
    tm, sm = torch.nn.Linear(3, 3, bias=False), torch.nn.Linear(3, 3, bias=False)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(t["w"]))
        sm.weight.copy_(torch.from_numpy(s["w"]))
    ema_update(tm, sm, 0.996)
    np.testing.assert_allclose(tm.weight.detach().numpy(), np.asarray(want["w"]), rtol=1e-6)


def test_multicrop_forward_orders_group_then_view():
    feats = multicrop_forward(lambda x: x.reshape(x.shape[0], -1)[:, :1], lambda f: f,
                              [torch.arange(6.).reshape(2, 3, 1), torch.arange(6., 10.).reshape(
                                  2, 2, 1)])
    assert feats.flatten().tolist() == list(range(10))


@pytest.mark.parametrize("n,bs,seed,epoch", [(10, 4, 0, 0), (80, 8, 43, 1), (3, 8, 7, 2)])
def test_epoch_batches_bit_equal(n, bs, seed, epoch):
    a, am = epoch_batches(n, bs, seed=seed, epoch=epoch)
    b, bm = jax_epoch_batches(n, bs, seed=seed, epoch=epoch)
    np.testing.assert_array_equal(a, b)
    assert (am is None) == (bm is None)
    if am is not None:
        np.testing.assert_array_equal(am, bm)


@pytest.mark.parametrize("args", [(0.0025, 1e-6, 3, 7, 1), (0.04, 0.4, 2, 5, 0),
                                  (0.996, 1.0, 4, 3, 2)], ids=str)
def test_cosine_scheduler_bit_equal(args):
    base, final, epochs, niter, warmup = args
    np.testing.assert_array_equal(cosine_scheduler(base, final, epochs, niter, warmup),
                                  jax_cosine(base, final, epochs, niter, warmup))


@pytest.mark.parametrize("size", [224, 96, 40])
def test_tile_eeg_to_image_bit_equal_with_a_given_start(size):
    rng = np.random.default_rng(size)
    eeg = rng.normal(size=(96, 460)).astype(np.float32)
    key = jax.random.key(size)
    want = np.asarray(jax_tile(key, jnp.asarray(eeg), size=size))
    # the start jax_tile draws, handed to the port
    start = int(jax.random.randint(key, (), 0, max(460 * (size // 460 + 1) - size, 1)))
    got = tile_eeg_to_image(torch.from_numpy(eeg), size=size, start=start)
    np.testing.assert_array_equal(got.numpy(), want)
    # the batched NHWC form used by the recipe agrees with it
    batch = tile_eeg_views(torch.from_numpy(eeg.T[None]), torch.tensor([[start]]), size)
    np.testing.assert_array_equal(batch[0, 0].numpy(), np.transpose(want, (1, 2, 0)))
    starts = window_starts((50,), 96, 460, size, torch.Generator().manual_seed(0))
    assert int(starts.min()) >= 0 and int(starts.max()) < max(460 * (size // 460 + 1) - size, 1)


def test_multicrop_views_and_time_window_follow_the_jax_rules():
    """Same starts in [0, T) shifted back by any overflow, as the JAX rule;
    the draws themselves differ (a torch.Generator, not a JAX key)."""
    eeg = torch.arange(2 * 50 * 3, dtype=torch.float32).reshape(2, 50, 3)
    g, l = multicrop_views(eeg, 30, 20, 2, 4, torch.Generator().manual_seed(0))
    assert g.shape == (2, 2, 30, 3) and l.shape == (4, 2, 20, 3)
    for views, length in ((g, 30), (l, 20)):
        for v in views:
            start = int(v[0, 0, 0]) // 3
            assert 0 <= start <= 50 - length
            assert torch.equal(v, eeg[:, start:start + length])
    assert torch.equal(time_window(eeg, 5, 9), eeg[:, 5:9])
    np.testing.assert_array_equal(
        time_window(eeg, 5, 9).numpy(), np.asarray(jax_time_window(jnp.asarray(eeg.numpy()), 5, 9)))


def test_strip_torch_prefixes_matches_jax():
    sd = {"module.teacher.backbone.cls_token": torch.ones(1, 1, 2),
          "backbone.blocks.0.norm1.weight": torch.ones(2), "head.mlp.0.bias": torch.zeros(3)}
    got = strip_torch_prefixes(sd)
    want = jax_strip({k: v.numpy() for k, v in sd.items()})
    assert sorted(got) == sorted(want) == ["blocks.0.norm1.weight", "cls_token",
                                           "head.mlp.0.bias"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def test_cli_trains_on_cpu(tmp_path):
    argv = ["--synthetic", "--device", "cpu", "--arch", "vit_tiny", "--patch_size", "16",
            "--global_size", "32", "--local_size", "16", "--out_dim", "32", "--epochs", "2",
            "--warmup_epochs", "1", "--synthetic_classes", "4", "--synthetic_per_class", "2",
            "--batch_size_per_gpu", "4", "--local_crops_number", "2", "--use_bf16", "false",
            "--log_dir", str(tmp_path)]
    state, hist = cli.main(argv)
    assert len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()
    assert state.step == 4
    with open(os.path.join(tmp_path, "log.txt")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1]


def test_cli_device_cuda_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        cli.main(["--synthetic", "--device", "cuda", "--log_dir", str(tmp_path)])
