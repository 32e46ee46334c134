"""The port's autoencoders and InlineLSTM against the JAX classes on the CPU
(the JAX LSTMs run their lax.scan path), with the JAX weights carried over by
`params_from_jax`; and five RMSprop steps of the feature-distillation step
on the recurrent autoencoder against the JAX step. f32 values atol 1e-5,
gradients atol 2e-5 / rtol 2e-4, losses per step atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerebra.models import autoencoders as jae
from cerebra.models.lstm import InlineLSTM as JaxInlineLSTM
from cerebra.train.optim import make_optimizer as jax_optimizer
from cerebra.train.steps import TrainState, make_feature_distill_step
from cerebra_torch.models import (
    EEGAutoencoderConv,
    EEGAutoencoderFC,
    InlineLSTM,
    RecurrentAutoencoder,
    feature_matching_loss,
    params_from_jax,
)
from cerebra_torch.train.optim import make_optimizer
from cerebra_torch.train.steps import feature_distill_step

torch.set_num_threads(1)


def init(jax_module, x, seed=0, **kw):
    params = jax_module.init(jax.random.key(seed), jnp.asarray(x), **kw)["params"]
    return jax.tree.map(np.asarray, params)


def port(module, params):
    module.load_state_dict(params_from_jax(params), strict=True)
    return module


def close(got, want, grad=False):
    tol = dict(atol=2e-5, rtol=2e-4) if grad else dict(atol=1e-5)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def test_recurrent_autoencoder_values_and_gradients():
    T, C, E, B = 7, 3, 5, 4
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    w_enc = rng.normal(size=(B, E)).astype(np.float32)
    w_dec = rng.normal(size=(B, T, C)).astype(np.float32)
    jm = jae.RecurrentAutoencoder(seq_len=T, n_features=C, embedding_dim=E)
    params = init(jm, x)

    def loss(p):
        enc, dec = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(enc * w_enc) + jnp.sum(dec * w_dec), (enc, dec)

    (_, (want_enc, want_dec)), want_g = jax.value_and_grad(loss, has_aux=True)(params)
    model = port(RecurrentAutoencoder(T, C, E), params)
    enc, dec = model(torch.from_numpy(x))
    close(enc.detach(), want_enc)
    close(dec.detach(), want_dec)
    ((enc * torch.from_numpy(w_enc)).sum() + (dec * torch.from_numpy(w_dec)).sum()).backward()
    want_g = params_from_jax(jax.tree.map(np.asarray, want_g))
    assert set(want_g) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        close(p.grad, want_g[name], grad=True)


@pytest.mark.parametrize("compat_view_bug", [False, True])
def test_inline_lstm_matches_jax(compat_view_bug):
    B, C, T, H, F, K = 3, 4, 9, 5, 6, 7
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, C, T)).astype(np.float32)  # (B, C, T): turned to (B, T, C)
    w = rng.normal(size=(B, K)).astype(np.float32)
    jm = JaxInlineLSTM(input_size=C, hidden_size=H, num_layers=2, output_size=F, n_classes=K,
                       compat_view_bug=compat_view_bug)
    params = init(jm, x)

    def loss(p):
        feats, cls = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(cls * w), (feats, cls)

    (_, (want_f, want_c)), want_g = jax.value_and_grad(loss, has_aux=True)(params)
    model = port(InlineLSTM(C, H, 2, F, n_classes=K, compat_view_bug=compat_view_bug), params)
    feats, cls = model(torch.from_numpy(x))
    close(feats.detach(), want_f)
    close(cls.detach(), want_c)
    (cls * torch.from_numpy(w)).sum().backward()
    want_g = params_from_jax(jax.tree.map(np.asarray, want_g))
    for name, p in model.named_parameters():
        close(p.grad, want_g[name], grad=True)


def test_eeg_autoencoder_fc_matches_jax_in_eval():
    B, C, T, E = 2, 4, 6, 5
    x = np.random.default_rng(2).normal(size=(B, C, T)).astype(np.float32)
    jm = jae.EEGAutoencoderFC(channels=C, time_freq=T, latent_dim=E, num_residual_blocks=2)
    params = init(jm, x, train=False)
    want_enc, want_dec = jm.apply({"params": params}, jnp.asarray(x), train=False)
    model = port(EEGAutoencoderFC(C, T, E, num_residual_blocks=2), params)
    with torch.no_grad():
        enc, dec = model(torch.from_numpy(x), train=False)
    close(enc, want_enc)
    close(dec, want_dec)


def test_eeg_autoencoder_fc_dropout_draws_from_the_generator():
    model = EEGAutoencoderFC(3, 4, 5, num_residual_blocks=1,
                             generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 4, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = model(x, True, torch.Generator().manual_seed(7))
        b = model(x, True, torch.Generator().manual_seed(7))
        c = model(x, train=False)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert not torch.equal(a[0], c[0])
    with pytest.raises(ValueError):
        model(x, train=True)


@pytest.mark.parametrize("T", [20, 21])
def test_eeg_autoencoder_conv_matches_jax(T):
    """Includes the flax ConvTranspose (zero insertion, (1, 2) padding, no
    kernel flip) and the crop back to T."""
    B, C, E = 2, 8, 16
    x = np.random.default_rng(3).normal(size=(B, C, T)).astype(np.float32)
    jm = jae.EEGAutoencoderConv(in_channels=C, latent_dim=E)
    params = init(jm, x)
    want = jm.apply({"params": params}, jnp.asarray(x))
    model = port(EEGAutoencoderConv(C, E, time_freq=T), params)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (B, C, T)
    close(got, want)


def test_feature_matching_loss_matches_jax():
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(2, 3, 5)).astype(np.float32)
    close(feature_matching_loss(torch.from_numpy(a), torch.from_numpy(b)),
          jae.feature_matching_loss(jnp.asarray(a), jnp.asarray(b)))


def test_five_rmsprop_steps_match_jax():
    """The slice: RecurrentAutoencoder through feature_distill_step with
    feature_matching_loss on the encoded latent, RMSprop, f32."""
    T, C, E, B = 12, 6, 8, 4
    jm = jae.RecurrentAutoencoder(seq_len=T, n_features=C, embedding_dim=E)
    params = jm.init(jax.random.key(0), jnp.zeros((1, T, C)))["params"]
    tx = jax_optimizer("rmsprop", 1e-3)
    state = TrainState.create(apply_fn=jm.apply, params=params, tx=tx)
    jax_step = make_feature_distill_step(
        jm.apply, tx, lambda f, c, t, y, e: jae.feature_matching_loss(f, t), donate=False)

    model = port(RecurrentAutoencoder(T, C, E), jax.tree.map(np.asarray, params))
    opt = make_optimizer("rmsprop", model.parameters(), 1e-3)

    def loss_fn(f, c, t, y, e):
        return feature_matching_loss(f, t)

    rng = np.random.default_rng(5)
    for i in range(5):
        eeg = rng.normal(size=(B, T, C)).astype(np.float32)
        teacher = rng.normal(size=(B, E)).astype(np.float32)
        labels = np.zeros(B, np.int32)
        state, metrics = jax_step(state, jnp.asarray(eeg), jnp.asarray(teacher),
                                  jnp.asarray(labels), 0)
        got = feature_distill_step(model, opt, loss_fn, torch.from_numpy(eeg),
                                   torch.from_numpy(teacher), torch.from_numpy(labels), 0)
        np.testing.assert_allclose(got.item(), float(metrics["loss"]), atol=1e-5,
                                   err_msg=f"step {i}")
