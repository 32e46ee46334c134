"""The port's Barlow Twins slice against the JAX package on the CPU: the mel
filterbank bit for bit, the mel spectrogram and the recipe's chunked corpus
spectrogram, the loss and its gradients, the warmup + cosine schedule, the
shared projector's two statistics updates a step, BarlowTwins in train mode
(outputs and every running statistic), three training steps against a JAX
step built from `BarlowTwins.apply`, `barlow_twins_loss` and the recipe's
`optax.multi_transform` LARS, the torchvision graft, nested remat, and the
CLI end to end.

Tolerances: the filterbank and the schedule exactly; spectrograms 1e-5 of
the largest value (an FFT in another order); the loss 1e-5 relative, its
gradients 1e-5 of the largest; running statistics 1e-5 relative to each
tensor's largest value (the towers read at most 5.5e-6 here); the
projector outputs 1e-4 of the largest (1.7e-5 here: flax takes the batch
variance in one pass, E[x²] − E[x]², torch in two); over three steps the
losses 1e-4 relative, the parameters 1e-4 absolute, and the three steps'
update of all parameters together 1e-3 in relative Frobenius norm (1.6e-4
here). At 32 px the last stages normalise over 16 and 64 values, so a ReLU
input near 0 can fall on the other side and move whole terms of a
gradient: the worst tensors are BatchNorm biases of such blocks, off by
~1e-3 of their update (on other draws the whole update read 6.0e-6)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from cerebra.losses import barlow_twins_loss as jax_barlow_loss
from cerebra.models.barlow import BarlowTwins as JaxBarlowTwins
from cerebra.models.barlow import Projector as JaxProjector
from cerebra.models.barlow import graft_pretrained_towers as jax_graft
from cerebra.signal import spectro as jspec
from cerebra.train.schedules import barlow_learning_rate as jax_barlow_lr
from cerebra_torch.cli import barlow_train as cli
from cerebra_torch.losses import barlow_twins_loss
from cerebra_torch.models import barlow as tb
from cerebra_torch.models import resnet as tres
from cerebra_torch.signal import spectro as tspec
from cerebra_torch.train import barlow_recipe as trec
from cerebra_torch.train.schedules import barlow_learning_rate

torch.set_num_threads(1)
TOL = 1e-5
B, S, M, F = 16, 32, 32, 8  # pairs, image size, mels, frames
PROJ = (64, 64)


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def _stats_match(got_sd, want_sd, what, tol=TOL):
    names = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert names
    for k in names:
        err = float((got_sd[k] - want_sd[k]).abs().max())
        assert err <= tol * float(want_sd[k].abs().max()), (what, k, err)


def _pairs(seed, n=B):
    rng = np.random.default_rng(seed)
    y1 = rng.normal(0.45, 0.22, size=(n, S, S, 3)).astype(np.float32)
    y2 = (5.0 * rng.random((n, M, F, 96))).astype(np.float32)  # mel power, NHWC
    return y1, y2


# ------------------------------------------------------------ the spectrogram


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [
    (256.0, 256, 224, 0.0, None), (256.0, 2048, 224, 0.0, None), (128.0, 64, 32, 1.0, 50.0),
    (16000.0, 512, 40, 0.0, None)])
def test_mel_filterbank_is_bit_equal(sr, n_fft, n_mels, fmin, fmax):
    got = tspec.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    want = jspec.mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("T", [460, 2100])
def test_melspectrogram_matches_jax(T):
    """T = 460 (the CLI's window) takes n_fft 256, hop 64, 8 frames; T =
    2100 the default n_fft 2048."""
    x = np.random.default_rng(T).normal(size=(2, 3, T)).astype(np.float32)
    want = jspec.melspectrogram(jnp.asarray(x))
    got = tspec.melspectrogram(torch.from_numpy(x))
    assert got.shape == (2, 3, 224, {460: 8, 2100: 5}[T])
    _close(got, want)
    _close(tspec.stft_magnitude(torch.from_numpy(x), 256, 64),
           jspec.stft_magnitude(jnp.asarray(x), 256, 64))


def test_corpus_spectrogram_in_chunks_matches_jax():
    """300 trials: two chunks; (N, T, C) EEG → (N, M, frames, C) NHWC."""
    eeg = np.random.default_rng(1).normal(size=(300, 460, 3)).astype(np.float32)
    got = trec.barlow_spectrogram(eeg, 32, 256.0, torch.device("cpu"))
    w = jnp.asarray(jspec.mel_filterbank(256.0, 256, 32))
    want = jnp.transpose(jspec.melspectrogram(jnp.swapaxes(jnp.asarray(eeg), 1, 2), n_mels=32,
                                              mel_weights=w), (0, 2, 3, 1))
    assert got.shape == (300, 32, 8, 3)
    _close(got, want)


# -------------------------------------------------------- loss and schedule


def test_barlow_twins_loss_and_gradients_match_jax():
    rng = np.random.default_rng(2)
    z1 = (3.0 + rng.normal(size=(16, 512))).astype(np.float32)
    z2 = (rng.normal(size=(16, 512)) - 1.0).astype(np.float32)
    want, (g1, g2) = jax.value_and_grad(jax_barlow_loss, argnums=(0, 1))(
        jnp.asarray(z1), jnp.asarray(z2))
    t1, t2 = (torch.from_numpy(z).requires_grad_() for z in (z1, z2))
    got = barlow_twins_loss(t1, t2)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= TOL * abs(float(want))
    _close(t1.grad, g1, tol=TOL * float(np.abs(g1).max()))
    _close(t2.grad, g2, tol=TOL * float(np.abs(g2).max()))


@pytest.mark.parametrize("epochs,niter,batch,warmup", [(10, 5, 16, 10), (3, 7, 64, 1),
                                                      (2, 4, 16, 0)])
def test_barlow_learning_rate_is_bit_equal(epochs, niter, batch, warmup):
    np.testing.assert_array_equal(barlow_learning_rate(epochs, niter, batch, warmup),
                                  jax_barlow_lr(epochs, niter, batch, warmup))


# ---------------------------------------------------------------- the model


class _SharedProjector(nn.Module):
    """flax's BarlowTwins' use of its projector: one module, two calls."""

    @nn.compact
    def __call__(self, a, b, train=True):
        proj = JaxProjector(PROJ + (48,), name="projector")
        return proj(a, train=train), proj(b, train=train)


def test_shared_projector_updates_its_statistics_twice_like_flax():
    """The image pass moves the running statistics first, the EEG pass
    then moves them again."""
    rng = np.random.default_rng(3)
    a = (1.0 + rng.normal(size=(B, 2048))).astype(np.float32)
    b = rng.normal(size=(B, 2048)).astype(np.float32)
    jm = _SharedProjector()
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(0), a, b, train=False))
    (w1, w2), upd = jm.apply(variables, a, b, mutable=["batch_stats"])
    tm = tb.Projector(2048, PROJ + (48,))
    tm.load_state_dict(tb.projector_from_jax(variables["params"]["projector"],
                                             variables["batch_stats"]["projector"]))
    with torch.no_grad():
        got1, got2 = tm.train()(torch.from_numpy(a)), tm(torch.from_numpy(b))
    _close(got1, w1)
    _close(got2, w2)
    new = tb.projector_from_jax(variables["params"]["projector"],
                                upd["batch_stats"]["projector"])
    _stats_match(tm.state_dict(), new, "projector")
    assert all(int(tm[i].num_batches_tracked) == 2 for i in (1, 4))


@pytest.fixture(scope="module")
def jax_barlow():
    """JAX's BarlowTwins (32 px, projector 64-64) and its init."""
    jm = JaxBarlowTwins(projector_sizes=PROJ)
    y1, y2 = _pairs(0, 1)
    init = jax.jit(lambda a, b: jm.init(jax.random.key(0), a, b, train=False))
    return jm, jax.tree.map(np.asarray, init(y1, y2))


def _port(variables, **kw):
    tm = tb.BarlowTwins(PROJ, **kw)
    tm.load_state_dict(tb.params_from_jax(variables, projector_depth=len(PROJ)))
    return tm


def test_barlow_train_forward_and_running_stats_match_jax(jax_barlow):
    jm, variables = jax_barlow
    y1, y2 = _pairs(4)
    (z1, z2), upd = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=True,
                                                     mutable=["batch_stats"]))(variables, y1, y2)
    tm = _port(variables)
    with torch.no_grad():
        g1, g2 = tm.train()(torch.from_numpy(y1), torch.from_numpy(y2))
    assert g1.shape == g2.shape == (B, 64)
    _close(g1, z1, tol=1e-4)
    _close(g2, z2, tol=1e-4)
    new = tb.params_from_jax({"params": variables["params"], "batch_stats": upd["batch_stats"]},
                             projector_depth=len(PROJ))
    _stats_match(tm.state_dict(), new, "BarlowTwins")
    assert int(tm.projector[1].num_batches_tracked) == 2
    assert int(tm.backbone_eeg.bn1.num_batches_tracked) == 1


def test_three_barlow_steps_match_jax(jax_barlow):
    jm, variables = jax_barlow
    niter = 3
    cfg = trec.BarlowConfig(epochs=1, batch_size=B, projector=PROJ, warmup_epochs=0)
    base = jax_barlow_lr(1, niter, B, 0)
    lr_w = jnp.asarray(base * cfg.learning_rate_weights, jnp.float32)
    lr_b = jnp.asarray(base * cfg.learning_rate_biases, jnp.float32)

    def sched(arr):
        return lambda step: arr[jnp.minimum(step, arr.shape[0] - 1)]

    labels = jax.tree.map(lambda p: "w" if jnp.ndim(p) > 1 else "b", variables["params"])
    tx = optax.multi_transform({
        "w": optax.lars(sched(lr_w), weight_decay=cfg.weight_decay, trust_coefficient=0.001),
        "b": optax.lars(sched(lr_b), weight_decay=0.0, trust_coefficient=0.001,
                        trust_ratio_mask=False)}, labels)

    @jax.jit
    def jax_step(params, stats, opt_state, y1, y2):
        def loss_fn(p):
            (z1, z2), upd = jm.apply({"params": p, "batch_stats": stats}, y1, y2, train=True,
                                     mutable=["batch_stats"])
            return jax_barlow_loss(z1, z2, lambd=cfg.lambd,
                                   global_batch_size=y1.shape[0]), upd["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), stats, opt_state, loss

    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    tm = _port(variables)
    opt = trec.barlow_optimizer(tm, cfg, niter)
    n_w = sum(1 for label in jax.tree.leaves(labels) if label == "w")
    assert [len(g["params"]) for g in opt.param_groups] == [n_w, len(jax.tree.leaves(labels)) - n_w]
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    for step in range(niter):
        y1, y2 = _pairs(10 + step)
        params, stats, opt_state, want = jax_step(params, stats, opt_state, y1, y2)
        got = trec.barlow_step(tm, opt, torch.from_numpy(y1), torch.from_numpy(y2), step,
                               cfg.lambd)
        assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want)), (step, got, want)
    want_sd = tb.params_from_jax(jax.tree.map(np.asarray, {"params": params,
                                                           "batch_stats": stats}),
                                 projector_depth=len(PROJ))
    got_sd = tm.state_dict()
    diff2 = norm2 = 0.0
    for k, v in want_sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert float((got_sd[k] - v).abs().max()) <= 1e-4, k
        if not k.endswith(("running_mean", "running_var")):
            d_want, d_got = (v - before[k]).double(), (got_sd[k] - before[k]).double()
            diff2 += float((d_got - d_want).square().sum())
            norm2 += float(d_want.square().sum())
    assert norm2 > 0 and (diff2 / norm2) ** 0.5 <= 1e-3, (diff2 / norm2) ** 0.5


def _random_torchvision_pth(path, seed):
    src = tres.resnet50(generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, b in src.named_buffers():
            if name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g))
            elif name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
    torch.save({"state_dict": src.state_dict()}, path)
    return src.state_dict()


def test_graft_pretrained_towers_matches_jax(jax_barlow, tmp_path):
    _, variables = jax_barlow
    path = str(tmp_path / "resnet50.pth")
    src = _random_torchvision_pth(path, 20)
    want = tb.params_from_jax(jax.tree.map(np.asarray, jax_graft(variables, path)),
                              projector_depth=len(PROJ))
    tm = tb.graft_pretrained_towers(_port(variables), path)
    got = tm.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k
    for tower in tb.TOWERS:
        for k, v in src.items():
            assert torch.equal(got[f"{tower}.{k}"], v), (tower, k)


def test_nested_remat_keeps_gradients_and_updates_statistics_once():
    """Stage and block checkpoints: the same loss, gradients and running
    statistics as without; a block ahead of its stage's last starts its
    forward three times (the forward, the stage's recompute, its own
    recompute; a recompute stops early once it has the tensors it needs),
    and the running statistics move on the first only."""
    gen = torch.Generator().manual_seed(5)
    models = [tb.BarlowTwins((32, 32), remat=r, generator=gen) for r in (False, True)]
    models[1].load_state_dict(models[0].state_dict())
    y1, y2 = (torch.from_numpy(a[:4]) for a in _pairs(6))
    calls = {}
    for m in models:
        calls[m.backbone_image.remat] = 0

        def hook(mod, args, r=m.backbone_image.remat):
            calls[r] += 1

        m.backbone_image.layer3[1].register_forward_pre_hook(hook)
        m.train()
        z1, z2 = m(y1, y2)
        barlow_twins_loss(z1, z2).backward()
    assert calls == {False: 1, True: 3}
    (a, b) = [dict(m.named_parameters()) for m in models]
    for k in a:
        torch.testing.assert_close(b[k].grad, a[k].grad, rtol=1e-5, atol=1e-6, msg=k)
    for k, v in models[0].state_dict().items():
        assert torch.equal(v, models[1].state_dict()[k]), k
    assert int(models[1].backbone_image.layer3[1].bn2.num_batches_tracked) == 1


# ---------------------------------------------------------------- the CLI

TINY = ["--synthetic", "--synthetic_classes", "2", "--synthetic_per_class", "4", "--epochs", "2",
        "--batch_size", "4", "--projector", "32-32", "--n_mels", "32", "--image_size", "32"]


def test_barlow_cli_end_to_end(tmp_path):
    """Finite losses, stats.txt as JSONL with the JAX CLI's lines, and a
    checkpoint.pt whose model forwards as the trained one."""
    model, hist = cli.main(TINY + ["--device", "cpu", "--log_dir", str(tmp_path)])
    assert len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()
    lines = [json.loads(line)["msg"] for line in (tmp_path / "stats.txt").read_text().splitlines()]
    assert lines == [f"EPOCH {e} barlow_loss: {hist['loss'][e]:.4f}" for e in range(2)]
    loaded = cli.load_checkpoint(str(tmp_path / cli.CHECKPOINT), projector=(32, 32))
    y1, y2 = _pairs(7, 4)
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(y1), torch.from_numpy(y2))
        got = loaded(torch.from_numpy(y1), torch.from_numpy(y2))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_barlow_cli_needs_a_gpu_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(TINY + ["--log_dir", str(tmp_path)])
    assert not (tmp_path / "stats.txt").exists()
