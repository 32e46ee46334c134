"""The port's Barlow Twins and Conformer trainers over two gloo ranks against
the JAX package's on a 2-device mesh, on the CPU, and one step of each over
two ranks against one process on the same rows (tests/_torch_dist.py runs
the ranks).

Barlow: `barlow_train` at W = 2 (SyncBN, c summed over the data group)
against the JAX recipe on the same mesh shape from the JAX init's weights,
one step of the one-device test's batch of 16 an epoch for three epochs. The tolerances are the one-device
Barlow test's (tests/test_torch_barlow.py, where the reasons are given: at
32 px the ResNet-50 towers' last stages normalise over 16 and 64 values):
the losses 1e-4 relative, the parameters and running statistics 1e-4
absolute, all the parameters' updates together 1e-3 relative Frobenius.

Conformer: three Adam steps of `conformer_step` under DDP with the
dropout masks fed (each rank its rows of the global batch's masks) against
the JAX recipe's step jitted over the batch sharded on a 2-device mesh, the
step batch (real rows and S&R rows) the same on both sides: the losses
1e-5 relative, the parameters by the one-device Conformer test's rule
(tests/test_torch_conformer.py): 99.5 % of each tensor's elements to 1e-6
and all to Adam's bound 2·steps·lr, the tensors whose gradient is 0 in
exact arithmetic (biases ahead of a BatchNorm or a softmax) to the bound
alone.

W = 2 against one process: the loss 1e-5 relative, each gradient 1e-5
relative Frobenius, the parameters after the step 1e-5 of the tensor's
largest value; Barlow's step in f64 (in f32 either side carries up to
~6e-3 of rounding in its gradients, the batch-16 BatchNorms' cancellation:
one process as often as the ranks, as f64 references show)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cerebra.models.barlow import BarlowTwins as JaxBarlowTwins
from cerebra.models.conformer import Conformer as JaxConformer
from cerebra.train.barlow_recipe import BarlowConfig as JaxBarlowConfig
from cerebra.train.barlow_recipe import barlow_train as jax_barlow_train
from cerebra_torch.models import barlow as tb
from cerebra_torch.models import conformer as tconf
from cerebra_torch.train.barlow_recipe import barlow_spectrogram
from tests import _torch_dist as tdist
from tests._flax_dropout import DropoutMasks

torch.set_num_threads(1)
PROJ = (32, 32)


def _mesh2():
    return Mesh(np.asarray(jax.devices()[:2]), ("data",))


def _barlow_data(n, seed):
    rng = np.random.default_rng(seed)
    images = rng.normal(0.45, 0.22, size=(n, 32, 32, 3)).astype(np.float32)
    eeg = rng.normal(size=(n, 64, 6)).astype(np.float32)
    return images, eeg


def _jax_barlow_init(images, eeg, cfg):
    """The JAX recipe's init (its key, the shapes of its first pair) as the
    port's state dict."""
    y2 = barlow_spectrogram(eeg[:1], cfg["n_mels"], 256.0, torch.device("cpu")).numpy()
    jm = JaxBarlowTwins(projector_sizes=PROJ, eeg_in_channels=eeg.shape[-1])
    variables = jax.jit(lambda a, b: jm.init(jax.random.key(cfg["seed"]), a, b, train=False))(
        images[:1], y2)
    return tb.params_from_jax(jax.tree.map(np.asarray, variables), projector_depth=len(PROJ))


def test_barlow_at_two_ranks_matches_the_jax_mesh():
    images, eeg = _barlow_data(16, 0)
    cfg = dict(epochs=3, batch_size=16, projector=PROJ, n_mels=32, image_size=32,
               warmup_epochs=0, seed=0)
    variables, hist = jax_barlow_train(images, eeg, JaxBarlowConfig(**cfg), mesh=_mesh2(),
                                       log_fn=lambda m: None)
    before = _jax_barlow_init(images, eeg, cfg)
    want = tb.params_from_jax(jax.tree.map(np.asarray, variables), projector_depth=len(PROJ))
    ranks = tdist.run_world(tdist.barlow_rank, 2, images, eeg, cfg, before)
    assert ranks[0]["loss"] == ranks[1]["loss"]
    np.testing.assert_allclose(ranks[0]["loss"], hist["loss"], rtol=1e-4)
    for r, out in enumerate(ranks):
        diff2 = norm2 = 0.0
        for k, v in want.items():
            if k.endswith("num_batches_tracked"):
                continue
            got = out["params"][k]
            assert float((got - v).abs().max()) <= 1e-4, (r, k)
            if not k.endswith(("running_mean", "running_var")):
                d_want, d_got = (v - before[k]).double(), (got - before[k]).double()
                diff2 += float((d_got - d_want).square().sum())
                norm2 += float(d_want.square().sum())
        assert norm2 > 0 and (diff2 / norm2) ** 0.5 <= 1e-3, (r, (diff2 / norm2) ** 0.5)


C, T, B = 4, 200, 8  # the step batch of 8 rows: 4 real + 4 S&R
DIMS = dict(emb_size=20, depth=1, out_features=16)
LR, STEPS = 2e-4, 3
# zero gradients in exact arithmetic: biases ahead of a BatchNorm or a softmax
ZERO_GRAD = ("keys.bias", "patch_embedding.conv_0.bias", "patch_embedding.conv_1.bias")


def _conformer(seed):
    """JAX's Conformer, its init, and the shapes and rates of its dropout
    masks (an abstract trace)."""
    jm = JaxConformer(**DIMS)
    x0 = jax.ShapeDtypeStruct((B, 1, C, T), jnp.float32)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.key(seed), jnp.zeros(x0.shape),
                                                 train=False))
    shapes = DropoutMasks(0)
    with shapes.intercept():
        jax.eval_shape(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]),
                       variables, x0)
    return jm, variables, shapes


def test_conformer_steps_at_two_ranks_match_the_jax_mesh():
    jm, variables, shapes = _conformer(6)
    rng = np.random.default_rng(5)
    tx = optax.adam(LR, b1=0.5, b2=0.999)
    rows = NamedSharding(_mesh2(), P("data"))

    @jax.jit
    def jax_step(params, stats, opt_state, x, y, masks):
        def loss_fn(p):
            (_, out), upd = jm.apply({"params": p, "batch_stats": stats}, x, train=True,
                                     mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(
                out.astype(jnp.float32), y).mean()
            return loss, upd["batch_stats"]

        with DropoutMasks(feed=masks).intercept():
            (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), stats, opt_state, loss

    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    batches, masks, want = [], [], []
    for step in range(STEPS):
        x = rng.normal(size=(B, 1, C, T)).astype(np.float32)
        y = rng.integers(0, 4, size=B)
        m = shapes.draw_again(100 + step)
        assert all(np.shape(a)[0] == B for a in m)  # every mask leads with the batch
        params, stats, opt_state, loss = jax_step(
            params, stats, opt_state, jax.device_put(x, rows),
            jax.device_put(y.astype(np.int32), rows), [jax.device_put(a, rows) for a in m])
        batches.append((x, y))
        masks.append(m)
        want.append(float(loss))
    sd = tconf.params_from_jax(variables, depth=DIMS["depth"])
    ranks = tdist.run_world(tdist.conformer_world_rank, 2, sd, DIMS, batches, masks)
    final = tconf.params_from_jax(jax.tree.map(np.asarray, {"params": params,
                                                           "batch_stats": stats}),
                                  depth=DIMS["depth"])
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["loss"], want, rtol=1e-5, err_msg=str(r))
        for k, v in final.items():
            if k.endswith("num_batches_tracked"):
                continue
            err = np.abs(out["params"][k].numpy() - v.numpy())
            assert err.max() <= 2 * STEPS * LR, (r, k, err.max())
            if not k.endswith(("running_mean", "running_var", *ZERO_GRAD)):
                assert (err <= 1e-6).mean() >= 0.995, (r, k, (err <= 1e-6).mean())
        tdist.close(out["params"]["patch_embedding.bn.running_var"],
               final["patch_embedding.bn.running_var"], f"rank {r} running_var")


def test_one_barlow_step_at_two_ranks_equals_one_process():
    images, eeg = _barlow_data(8, 1)
    y2 = barlow_spectrogram(eeg, 32, 256.0, torch.device("cpu")).numpy()
    sd = tb.BarlowTwins(PROJ, eeg_in_channels=6,
                        generator=torch.Generator().manual_seed(0)).state_dict()
    ranks = tdist.run_world(tdist.barlow_step_rank, 2, sd, PROJ, (images, y2))
    tdist.world_equals_one(ranks)


def test_one_conformer_step_at_two_ranks_equals_one_process():
    _, variables, shapes = _conformer(8)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, 1, C, T)).astype(np.float32)
    y = rng.integers(0, 4, size=B)
    sd = tconf.params_from_jax(variables, depth=DIMS["depth"])
    ranks = tdist.run_world(tdist.conformer_step_rank, 2, sd, DIMS, (x, y),
                            shapes.draw_again(8))
    names = [k for k in sd if k.endswith(ZERO_GRAD)]
    tdist.world_equals_one(ranks, zero_grad=names, lr=LR)
