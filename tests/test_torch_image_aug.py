"""The stimulus-image crops of the DINO recipe (cerebra_torch/signal/image_aug.py)
against the JAX package on the CPU. The JAX functions draw from their keys;
the tests recompute those draws from the same keys (the same splits and
distributions) and feed them to the port's ops, which take their draws as
data and run batched over (views, batch). Each op, both crop recipes, the
draw wrapper's ranges, and the recipe's view function with images, whose
draws are replaced by JAX's for the same key.

Tolerance: 1e-5 absolute on [0, 1] images and 1e-5 of the largest value on
normalised crops (f32 both sides; the YIQ matrix products, the channel means
and the blur's 9-tap sums are summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.signal import image_aug as ja
from cerebra.train import dino_vit as jdv
from cerebra_torch.signal import image_aug as ta
from cerebra_torch.train import dino_vit as tdv

torch.set_num_threads(1)
TOL = 1e-5


def _close(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), (what, err)


def _images(B=3, H=40, W=40, seed=0):
    return np.random.default_rng(seed).random((B, H, W, 3)).astype(np.float32)


def _keys(V, B, seed=5):
    return jax.random.split(jax.random.key(seed), V * B).reshape(V, B)


def _crop_draws(key, H, W, scale):
    a1, a2, a3, a4 = jax.random.split(key, 4)
    area = H * W * jax.random.uniform(a1, (), minval=scale[0], maxval=scale[1])
    log_ratio = jax.random.uniform(a2, (), minval=jnp.log(3 / 4), maxval=jnp.log(4 / 3))
    aspect = jnp.exp(log_ratio)
    w = jnp.clip(jnp.sqrt(area * aspect), 8, W).astype(jnp.int32)
    h = jnp.clip(jnp.sqrt(area / aspect), 8, H).astype(jnp.int32)
    top = jax.random.randint(a3, (), 0, jnp.maximum(H - h + 1, 1))
    left = jax.random.randint(a4, (), 0, jnp.maximum(W - w + 1, 1))
    return dict(area=area, log_ratio=log_ratio, top=top, left=left)


def _jitter_draws(key, hue=0.1, p=0.8):
    kb, kc, ks, kh, kp = jax.random.split(key, 5)
    return dict(
        brightness=1.0 + jax.random.uniform(kb, (), minval=-0.4, maxval=0.4),
        contrast=1.0 + jax.random.uniform(kc, (), minval=-0.4, maxval=0.4),
        saturation=1.0 + jax.random.uniform(ks, (), minval=-0.2, maxval=0.2),
        theta=2.0 * jnp.pi * jax.random.uniform(kh, (), minval=-hue, maxval=hue),
        jitter=jax.random.bernoulli(kp, p),
    )


def _blur_draws(key, p):
    k1, k2 = jax.random.split(key)
    return dict(sigma=jax.random.uniform(k1, (), minval=0.1, maxval=2.0),
                blur=jax.random.bernoulli(k2, p))


def _recipe_draws(key, H, W, local: bool, solarize_p=0.0):
    """The draws dino_local_crop / dino_global_crop make from `key`."""
    if local:
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        kg, ksol, scale, blur_p = k5, None, (0.05, 0.4), 0.5
    else:
        k1, k2, k3, k4, ksol, kg = jax.random.split(key, 6)
        scale, blur_p = (0.4, 1.0), 1.0
    d = _crop_draws(k1, H, W, scale)
    d["flip"] = jax.random.bernoulli(k2, 0.5)
    d.update(_jitter_draws(k3))
    d["gray"] = jax.random.bernoulli(kg, 0.2)
    d.update(_blur_draws(k4, blur_p))
    if solarize_p > 0:
        d["solarize"] = jax.random.bernoulli(ksol, solarize_p)
    return d


def _stack(fn, keys):
    """fn(key) → dict of scalars, over a (V, B) key grid → dict of (V, B) tensors."""
    return {k: torch.from_numpy(np.array(v)) for k, v in jax.vmap(jax.vmap(fn))(keys).items()}


def _per_view(fn_j, keys, imgs):
    """A JAX op over every (view, sample), the image of sample b in each view."""
    return jax.vmap(jax.vmap(fn_j, in_axes=(0, 0)), in_axes=(0, None))(keys, jnp.asarray(imgs))


def test_normalize_matches_jax():
    x = _images()
    _close(ta.normalize(torch.from_numpy(x)), ja.normalize(jnp.asarray(x)))


@pytest.mark.parametrize("scale", [(0.05, 0.4), (0.4, 1.0)], ids=["local", "global"])
@pytest.mark.parametrize("hw", [(40, 40), (37, 52)], ids=["square", "oblong"])
def test_random_resized_crop_matches_jax(scale, hw):
    H, W = hw
    imgs = _images(H=H, W=W)
    keys = _keys(4, 3)
    want = _per_view(lambda k, im: ja.random_resized_crop(k, im, 16, scale=scale), keys, imgs)
    d = _stack(lambda k: _crop_draws(k, H, W, scale), keys)
    got = ta.random_resized_crop(torch.from_numpy(imgs), 16, **d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_random_hflip_matches_jax():
    imgs = _images()
    keys = _keys(4, 3)
    views = np.broadcast_to(imgs, (4,) + imgs.shape).copy()
    want = jax.vmap(jax.vmap(ja.random_hflip))(keys, jnp.asarray(views))
    flip = _stack(lambda k: {"f": jax.random.bernoulli(k, 0.5)}, keys)["f"]
    got = ta.random_hflip(torch.from_numpy(views), flip)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hue", [0.1, 0.0], ids=["hue", "no_hue"])
def test_color_jitter_matches_jax(hue):
    imgs = _images()
    keys = _keys(4, 3, seed=7)
    views = np.broadcast_to(imgs, (4,) + imgs.shape).copy()
    want = jax.vmap(jax.vmap(lambda k, im: ja.color_jitter(k, im, hue=hue, p=0.6)))(
        keys, jnp.asarray(views))
    d = _stack(lambda k: _jitter_draws(k, hue=hue, p=0.6), keys)
    got = ta.color_jitter(torch.from_numpy(views), d["brightness"], d["contrast"],
                          d["saturation"], d["theta"] if hue > 0 else None, d["jitter"])
    _close(got, want)


def test_random_grayscale_and_solarization_match_jax():
    imgs = _images()
    keys = _keys(4, 3, seed=8)
    views = np.broadcast_to(imgs, (4,) + imgs.shape).copy()
    bits = _stack(lambda k: {"b": jax.random.bernoulli(k, 0.5)}, keys)["b"]
    want = jax.vmap(jax.vmap(lambda k, im: ja.random_grayscale(k, im, p=0.5)))(
        keys, jnp.asarray(views))
    _close(ta.random_grayscale(torch.from_numpy(views), bits), want)
    want = jax.vmap(jax.vmap(lambda k, im: ja.solarization(k, im, p=0.5)))(
        keys, jnp.asarray(views))
    np.testing.assert_array_equal(ta.solarization(torch.from_numpy(views), bits).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("hw", [(24, 24), (9, 31)], ids=["square", "thin"])
def test_gaussian_blur_matches_jax_zero_padded(hw):
    imgs = _images(B=2, H=hw[0], W=hw[1])
    keys = _keys(3, 2, seed=9)
    views = np.broadcast_to(imgs, (3,) + imgs.shape).copy()
    want = jax.vmap(jax.vmap(lambda k, im: ja.gaussian_blur(k, im, p=0.7)))(
        keys, jnp.asarray(views))
    d = _stack(lambda k: _blur_draws(k, 0.7), keys)
    assert d["blur"].any()
    got = ta.gaussian_blur(torch.from_numpy(views), d["sigma"], d["blur"])
    _close(got, want)
    # zeros beyond the border: a constant image darkens at its edges
    ones = torch.ones(1, 1, 12, 12, 3)
    edge = ta.gaussian_blur(ones, torch.tensor([[2.0]]), torch.tensor([[True]]))
    assert edge[0, 0, 0, 0, 0] < 0.8 and abs(float(edge[0, 0, 6, 6, 0]) - 1.0) < 1e-6


def test_dino_local_crop_matches_jax():
    imgs = _images(B=3, H=40, W=48)
    keys = _keys(4, 3, seed=11)
    want = _per_view(lambda k, im: ja.dino_local_crop(k, im, 16), keys, imgs)
    d = _stack(lambda k: _recipe_draws(k, 40, 48, local=True), keys)
    _close(ta.dino_local_crop(torch.from_numpy(imgs), ta.CropDraws(**d), 16), want)


@pytest.mark.parametrize("solarize_p", [0.0, 0.6], ids=["plain", "solarize"])
def test_dino_global_crop_matches_jax(solarize_p):
    imgs = _images(B=2, H=40, W=40)
    keys = _keys(2, 2, seed=12)
    want = _per_view(lambda k, im: ja.dino_global_crop(k, im, 24, solarize_p=solarize_p),
                     keys, imgs)
    d = _stack(lambda k: _recipe_draws(k, 40, 40, local=False, solarize_p=solarize_p), keys)
    _close(ta.dino_global_crop(torch.from_numpy(imgs), ta.CropDraws(**d), 24), want)


def test_draw_crop_ranges():
    """The wrapper's draws lie where the JAX package's do: the box inside
    the image, the factors in their intervals; the solarize bit only when
    asked for."""
    g = torch.Generator().manual_seed(0)
    d = ta.draw_crop(g, (64, 8), 40, 52, scale=(0.05, 0.4), blur_p=0.5)
    h, w = ta.crop_box(40, 52, d.area, d.log_ratio)
    assert ((d.top >= 0) & (d.top + h <= 40)).all() and ((d.left >= 0) & (d.left + w <= 52)).all()
    assert ((d.area >= 0.05 * 40 * 52) & (d.area <= 0.4 * 40 * 52)).all()
    assert ((d.brightness - 1).abs() <= 0.4).all() and ((d.saturation - 1).abs() <= 0.2).all()
    assert (d.theta.abs() <= 2 * np.pi * 0.1).all() and ((d.sigma >= 0.1) & (d.sigma <= 2)).all()
    assert d.solarize is None and 0.3 < d.blur.float().mean() < 0.7
    assert ta.draw_crop(g, (2, 2), 8, 8, (0.4, 1.0), 1.0, solarize_p=0.2).solarize is not None


def test_view_fn_with_images_matches_jax(monkeypatch):
    """make_eeg_image_view_fn(has_images=True): the EEG globals and the
    image locals against JAX's view function for one key, the port's window
    starts and crop draws replaced by those JAX draws from that key."""
    rng = np.random.default_rng(2)
    B, T, C, n_g, n_l, S, s = 3, 40, 12, 2, 3, 32, 16
    eeg = rng.normal(size=(B, T, C)).astype(np.float32)
    imgs = _images(B=B, H=36, W=44)
    key = jax.random.key(21)
    want = jdv.make_eeg_image_view_fn(n_g, n_l, S, s, True)(key, (jnp.asarray(eeg),
                                                                  jnp.asarray(imgs)))
    kg, kl = jax.random.split(key)
    g_keys = jax.random.split(kg, n_g * B).reshape(n_g, B)
    l_keys = jax.random.split(kl, n_l * B).reshape(n_l, B)
    width = T * (S // T + 1)
    starts = _stack(lambda k: {"s": jax.random.randint(k, (), 0, max(width - S, 1))},
                    g_keys)["s"]
    draws = _stack(lambda k: _recipe_draws(k, 36, 44, local=True), l_keys)
    monkeypatch.setattr(tdv, "window_starts", lambda *a, **k: starts)
    monkeypatch.setattr(tdv, "draw_crop", lambda *a, **k: ta.CropDraws(**draws))
    got = tdv.make_eeg_image_view_fn(n_g, n_l, S, s, True)(
        None, (torch.from_numpy(eeg), torch.from_numpy(imgs)))
    assert len(got) == len(want) == 2
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1], "locals")


def test_dino_vit_train_with_images_steps_on_cpu():
    """dino_vit_train(images=...) takes the image locals: two steps of a
    tiny recipe give finite losses."""
    rng = np.random.default_rng(3)
    eeg = rng.normal(size=(8, 40, 12)).astype(np.float32)
    imgs = rng.random((8, 36, 36, 3)).astype(np.float32)
    cfg = tdv.DinoVitConfig(arch="vit_tiny", patch_size=16, out_dim=16, epochs=1,
                            batch_size_per_device=4, global_size=32, local_size=16,
                            local_crops_number=2, warmup_epochs=0)
    _, hist = tdv.dino_vit_train(eeg, images=imgs, config=cfg, log_fn=lambda m: None)
    assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"][0])
