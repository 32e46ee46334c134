"""The port's losses, optimizer zoo and feature-distillation recipe losses
against the JAX package on the CPU.

Tolerances: each loss's value and its gradients in the student (and the
teacher) in f32 to 1e-6 relative (the same formulas, sums in another order);
ten steps of each optimizer from the same parameters and gradients to 5e-6
(parameters up to ~3 and updates of ~5e-2: torch.optim.Adam and optax.adam
alone, with no clip or decay, end 2.8e-6 apart after ten such steps, their
bias corrections and p + u rounded in another order; sgd, rmsprop and lars
agree to 1e-6); ten
feature-distillation steps per recipe loss, each with the optimizer of its
CLI, the loss of every step to 1e-5 (as `test_torch_train_parity.py`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cerebra.losses as jl
from cerebra.models.lstm import Model as JaxModel
from cerebra.train.optim import make_optimizer as jax_optimizer
from cerebra.train.steps import TrainState, make_feature_distill_step
import cerebra_torch.losses as tl
from cerebra_torch.losses import teacher_temp_schedule
from cerebra_torch.models import Model, params_from_jax
from cerebra_torch.train.optim import Lars, make_optimizer
from cerebra_torch.train.recipes import FeatureDistillConfig, distill_loss
from cerebra_torch.train.steps import feature_distill_step

torch.set_num_threads(1)

B, D = 5, 12
LABELS = np.array([0, 3, 11, 2, 7])
TARGET = np.array([1, -1, 1, -1, 1])

# name: (JAX loss of (s, t), port loss of (s, t))
LOSSES = {
    "feature_dist_v2": (jl.feature_distribution_loss_v2, tl.feature_distribution_loss_v2),
    "feature_dist_v3": (lambda s, t: jl.feature_distribution_loss_v3(s, t, 0.7),
                        lambda s, t: tl.feature_distribution_loss_v3(s, t, 0.7)),
    "feature_dist_v3_cold": (lambda s, t: jl.feature_distribution_loss_v3(s, t, 0.004),
                             lambda s, t: tl.feature_distribution_loss_v3(s, t, 0.004)),
    "hinton_kd": (lambda s, t: jl.hinton_kd_loss(s, jnp.asarray(LABELS), t, 2.0, 0.3),
                  lambda s, t: tl.hinton_kd_loss(s, torch.from_numpy(LABELS), t, 2.0, 0.3)),
    "kl_kd_smooth_l1": (lambda s, t: jl.kl_kd_smooth_l1_loss(s, t, 1.5, 0.25, 0.75),
                        lambda s, t: tl.kl_kd_smooth_l1_loss(s, t, 1.5, 0.25, 0.75)),
    "cosine": (jl.cosine_similarity_loss, tl.cosine_similarity_loss),
    "cosine_negative": (lambda s, t: jl.cosine_similarity_loss(s, t, negative_form=True),
                        lambda s, t: tl.cosine_similarity_loss(s, t, negative_form=True)),
    "cosine_embedding": (lambda s, t: jl.cosine_embedding_loss(s, t, jnp.asarray(TARGET), 0.1),
                         lambda s, t: tl.cosine_embedding_loss(s, t, torch.from_numpy(TARGET),
                                                               0.1)),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_loss_value_and_gradients_match_jax(name):
    jax_fn, port_fn = LOSSES[name]
    rng = np.random.default_rng(len(name))
    s = rng.normal(size=(B, D)).astype(np.float32) * 2
    t = rng.normal(size=(B, D)).astype(np.float32) * 2
    want, (gs_want, gt_want) = jax.value_and_grad(jax_fn, argnums=(0, 1))(jnp.asarray(s),
                                                                         jnp.asarray(t))
    st, tt = torch.tensor(s, requires_grad=True), torch.tensor(t, requires_grad=True)
    got = port_fn(st, tt)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-7)
    for g, w in ((st.grad, gs_want), (tt.grad, gt_want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6 * max(np.abs(w).max(), 1e-3))


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd", "rmsprop", "lars"])
def test_ten_optimizer_steps_match_jax(name):
    """Mixed-rank parameters (the decay and, for LARS, the trust ratio
    masked to ndim > 1), weight decay 0.05, a per-parameter clip at 1.0 that
    bites on some steps, gradients that depend on the parameters."""
    rng = np.random.default_rng(7)
    shapes = {"w": (4, 5), "b": (5,), "k": (3, 4, 2)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    target = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    noise = [{k: rng.normal(size=s).astype(np.float32) * 0.3 for k, s in shapes.items()}
             for _ in range(10)]
    lr = 0.05

    params = {k: jnp.asarray(v) for k, v in init.items()}
    tx = jax_optimizer(name, lr, weight_decay=0.05, params_mask_source=params, clip_grad=1.0)
    opt_state = tx.init(params)
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = make_optimizer(name, ps.values(), lr, weight_decay=0.05, clip_grad=1.0, masked=True)
    if name == "lars":
        assert isinstance(opt, Lars)

    def grads(p, i, as_torch):
        return {k: (p[k] - target[k]) * (0.4 + 0.1 * i) + noise[i][k] for k in shapes} if not \
            as_torch else {k: (p[k].detach() - torch.from_numpy(target[k])) * (0.4 + 0.1 * i)
                           + torch.from_numpy(noise[i][k]) for k in shapes}

    for i in range(10):
        updates, opt_state = tx.update(grads(params, i, False), opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        for k, g in grads(ps, i, True).items():
            ps[k].grad = g
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(ps[k].detach().numpy(), np.asarray(params[k]), rtol=0,
                                   atol=5e-6 if name.startswith("adam") else 1e-6,
                                   err_msg=f"{name} {k}")
        assert not np.allclose(np.asarray(params[k]), init[k])


# loss: (the JAX recipe's loss_fn at that `loss`, cerebra/train/recipes.py:127-142,
#        the optimizer of the CLI that runs it)
C, H, F, K, BS, T = 6, 5, 8, 4, 4, 10
TEMPS = teacher_temp_schedule(1.5, 0.22, 4, 10).astype(np.float32)
RECIPE_LOSSES = {
    "feature_dist_v1": (lambda f, c, t, y, e: jl.feature_distribution_loss_v1(
        f, t, y, c, temperature=jnp.asarray(TEMPS)[e], alpha=0.5, beta=0.5), "rmsprop"),
    "hinton_kd": (lambda f, c, t, y, e: jl.hinton_kd_loss(f, y, t, 2.0, 0.5), "adamw"),
    "cosine": (lambda f, c, t, y, e: jl.cosine_similarity_loss(f, t), "adam"),
    "feature_dist_v2": (lambda f, c, t, y, e: jl.feature_distribution_loss_v2(f, t), "sgd"),
    "feature_dist_v3": (lambda f, c, t, y, e: jl.feature_distribution_loss_v3(
        f, t, jnp.asarray(TEMPS)[e]), "lars"),
}


@pytest.mark.parametrize("loss", list(RECIPE_LOSSES))
def test_ten_feature_distill_steps_per_loss_match_jax(loss):
    jax_loss, opt_name = RECIPE_LOSSES[loss]
    jm = JaxModel(input_size=C, lstm_size=H, lstm_layers=2, output_size=F, n_classes=K,
                  input_grad=False)
    params = jm.init(jax.random.key(1), jnp.zeros((1, T, C)))["params"]
    tx = jax_optimizer(opt_name, 1e-2)
    state = TrainState.create(apply_fn=jm.apply, params=params, tx=tx)
    jax_step = make_feature_distill_step(jm.apply, tx, jax_loss, donate=False)

    model = Model(C, H, 2, F, n_classes=K)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    cfg = FeatureDistillConfig(loss=loss, optimizer=opt_name, learning_rate=1e-2)
    # the recipe's optimizer: unmasked, as the JAX recipe's (no mask source)
    opt = make_optimizer(cfg.optimizer, model.parameters(), cfg.learning_rate)
    loss_fn = distill_loss(cfg, TEMPS)

    rng = np.random.default_rng(2)
    for i in range(10):
        eeg = rng.normal(size=(BS, T, C)).astype(np.float32)
        teacher = rng.normal(size=(BS, F)).astype(np.float32)
        labels = rng.integers(0, K, size=BS)
        epoch = i // 3
        state, metrics = jax_step(state, jnp.asarray(eeg), jnp.asarray(teacher),
                                  jnp.asarray(labels), epoch)
        got = feature_distill_step(model, opt, loss_fn, torch.from_numpy(eeg),
                                   torch.from_numpy(teacher), torch.from_numpy(labels), epoch)
        np.testing.assert_allclose(got.item(), float(metrics["loss"]), rtol=0, atol=1e-5,
                                   err_msg=f"{loss} step {i}")


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("adagrad", [torch.nn.Parameter(torch.zeros(2))])
    with pytest.raises(ValueError, match="unknown loss"):
        distill_loss(FeatureDistillConfig(loss="mse"), TEMPS)
