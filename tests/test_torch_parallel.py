"""The port's multi-GPU slice against the JAX package's meshes, on the CPU.

JAX runs on the suite's 8 virtual CPU devices (tests/conftest.py); the port
on gloo ranks, each a process of its own with one torch thread
(tests/_torch_dist.py). The port's sharding host code is bit-equal to JAX's
(the cyclic wrap-pad of a tiny corpus too); its collectives give JAX's
values, and the differentiable ones W times JAX's gradient in each rank's
share (every rank holds the replicated output, the port's convention);
`feature_distill_train` (losses v1 and v2) at W = 2 and the DINO
self-distillation at (data, model) = (2, 1), (1, 2) and (2, 2) (the
prototypes sharded over "model", per-parameter clipping binding on the
sharded last layer) match the JAX recipes on the same mesh shape from the
same weights and crops; and one step over two ranks equals one step of one
process on the same rows for every recipe.

Tolerances: host code exactly; collectives 1e-6 relative; the recipes'
per-step losses 1e-5 relative; every parameter (and the DINO center) 1e-5
of the tensor's largest value, or of 1 when that is smaller, for the SGD
feature-distill runs, 2e-5 for the AdamW DINO runs (the one-device DINO
test's bound, tests/test_torch_dino_lstm.py): Adam's first update is
lr·g/(|g| + 1e-8), so a prototype whose gradient is a few eps from 0 (one
moves 5.9e-5 where the rest move 1e-3) carries the f32 rounding of its
gradient at full weight, 1.9e-5 here; the largest updates are two orders
of magnitude above the bounds. W = 2 against one process: the loss 1e-5
relative, each gradient 1e-5 relative Frobenius, the parameters after the
step 1e-5 of the tensor's largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from cerebra.models.lstm import Model as JaxModel
from cerebra.parallel import dataflow as jflow
from cerebra.parallel.tp import shard_params_tp
from cerebra.train import recipes as jrec
from cerebra.train.steps import make_scheduled_optimizer
from cerebra_torch.models import heads, lstm
from cerebra_torch.parallel import dataflow
from tests import _torch_dist as tdist

torch.set_num_threads(1)
TOL = 1e-5
ADAM_TOL = 2e-5


def _mesh(shape, axes=("data",)):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)


def _state_dicts_close(got, want, before, what, moved=1e-3, tol=TOL):
    """Every tensor of `want` in `got`; the largest update at least `moved`."""
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        tdist.close(got[k], v, f"{what} {k}", tol)
    step = max(float((want[k] - before[k]).abs().max()) for k in want)
    assert step >= moved, (what, step)


# ------------------------------------------------------------ host code


@pytest.mark.parametrize("n,n_data", [(3, 8), (30, 8), (7, 2), (16, 2)])
def test_blocked_corpus_is_jax_shard_corpus(n, n_data):
    arr = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    want, want_local = jflow.shard_corpus(_mesh((n_data,)), arr)
    got = dataflow.blocked_corpus(arr, n_data)
    assert got.shape[1] == want_local
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("args", [(5, 4, 2, 3, 0, 1), (4, 2, 4, 1, 43, 0), (1, 8, 3, 2, 7, 5)],
                         ids=str)
def test_local_epoch_indices_are_bit_equal(args):
    got, want = dataflow.local_epoch_indices(*args), jflow.local_epoch_indices(*args)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- collectives


def test_collectives_match_jax_values_and_gradients():
    """psum, pmean, all_gather and axis_size over a world of 4 against
    shard_map over 4 devices; the gradients of a loss through psum and
    through all_gather are 4 × JAX's (each of the 4 ranks seeds its copy of
    the loss); `shard_params_tp` on a (2, 2) mesh gives each rank the block
    JAX's gives the device at its mesh position."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 3)).astype(np.float32)
    c = rng.normal(size=(4, 3)).astype(np.float32)
    mesh = _mesh((4,))

    def smap(f, check_vma=True):
        return jax.shard_map(f, mesh=mesh, in_specs=P("data"), out_specs=P(),
                             check_vma=check_vma)

    psum = smap(lambda xl: jax.lax.psum(xl, "data"))
    pmean = smap(lambda xl: jax.lax.pmean(xl, "data"))
    # the tiled gather's replication is not inferred: the check is off for it
    gather = smap(lambda xl: jax.lax.all_gather(xl, "data", axis=0, tiled=True), False)
    size = smap(lambda xl: jnp.full((1, 1), jax.lax.psum(1, "data")))
    psum_grad = jax.grad(lambda a: jnp.sum(psum(a)[0] ** 2 * c[0]))(x)
    gather_grad = jax.grad(lambda a: jnp.sum(gather(a) ** 3 * c))(x)

    tp = shard_params_tp({"kernel": np.arange(16 * 64.0, dtype=np.float32).reshape(16, 64),
                          "bias": np.arange(64.0, dtype=np.float32),
                          "odd": np.arange(16 * 7.0, dtype=np.float32).reshape(16, 7)},
                         _mesh((2, 2), ("data", "model")))
    ranks = tdist.run_world(tdist.collectives_rank, 4, x, c)
    for r, out in enumerate(ranks):
        assert out["size"] == int(size(x)[0, 0]) == 4, out["size"]
        np.testing.assert_allclose(out["psum"], np.asarray(psum(x))[0], rtol=1e-6)
        np.testing.assert_allclose(out["pmean"], np.asarray(pmean(x))[0], rtol=1e-6)
        np.testing.assert_allclose(out["gather"], np.asarray(gather(x)), rtol=1e-6)
        np.testing.assert_allclose(out["psum_grad"], 4 * np.asarray(psum_grad)[r], rtol=1e-6)
        np.testing.assert_allclose(out["gather_grad"], 4 * np.asarray(gather_grad)[r],
                                   rtol=1e-6)
        # MetricLogger: count and total summed over the world, the window local
        assert out["meter"] == (10, 0 * 1 + 1 * 2 + 2 * 3 + 3 * 4, float(r))
        for k, v in tp.items():  # rank r holds device r's shard of JAX's layout
            shard = next(sh.data for sh in v.addressable_shards if sh.device == jax.devices()[r])
            np.testing.assert_array_equal(out["tp"][k].numpy(), np.asarray(shard), err_msg=k)


# ------------------------------------------------------ the recipes at W


@pytest.mark.parametrize("loss", ["feature_dist_v1", "feature_dist_v2"])
def test_feature_distill_at_two_ranks_matches_the_jax_mesh(loss):
    """Seven training rows wrap-pad to 2 × 4; batch 8 is one step an epoch,
    so the epoch losses are the step losses (three). SGD at lr 0.1 (the
    zoo's, momentum 0.9): the weights move by the gradients themselves,
    where RMSprop's g/√v would lift a rounding in a near-zero gradient to a
    whole step."""
    C, T, H, F, K, n = 5, 12, 6, 8, 3, 7
    rng = np.random.default_rng(1)
    eeg = rng.normal(size=(n + 2, T, C)).astype(np.float32)
    feats = rng.normal(size=(n + 2, F)).astype(np.float32)
    labels = rng.integers(0, K, n + 2)
    args = (eeg[:n], feats[:n], labels[:n], eeg[n:], feats[n:], labels[n:])
    cfg = dict(num_epochs=3, batch_size=8, lstm_size=H, lstm_layers=2, loss=loss,
               optimizer="sgd", learning_rate=0.1,
               validation_frequency=0, warmup_teacher_temp_epochs=2, warmup_teacher_temp=1.0,
               teacher_temp=0.5)
    jm = JaxModel(input_size=C, lstm_size=H, lstm_layers=2, output_size=F, include_top=True,
                  input_grad=False, n_classes=K)
    init = jm.init(jax.random.key(43), jnp.asarray(eeg[:1]))["params"]
    state, hist = jrec.feature_distill_train(*args, config=jrec.FeatureDistillConfig(**cfg),
                                             mesh=_mesh((2,)), n_classes=K,
                                             log_fn=lambda m: None)
    before = lstm.params_from_jax(jax.tree.map(np.asarray, init))
    want = lstm.params_from_jax(jax.tree.map(np.asarray, state.params))
    ranks = tdist.run_world(tdist.feature_distill_rank, 2, args, dict(cfg), before)
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["loss"], hist["train_loss"], rtol=TOL, err_msg=str(r))
        _state_dicts_close(out["params"], want, before, f"rank {r}")
    assert ranks[0]["loss"] == ranks[1]["loss"]


DINO = dict(epochs=3, batch_size_per_device=2, out_dim=16, embed_dim=8, lstm_layers=1,
            global_length=12, local_length=8, warmup_epochs=0, freeze_last_layer=0,
            clip_grad=0.02, seed=0)
STARTS = ([0, 4], [1, 3, 5, 7])  # the crops (T = 16): global and local starts


def _jax_dino_init(cfg, n_channels):
    """The JAX recipe's initial weights (its own key splits) as the port's
    state dict."""
    backbone, head = jrec.build_dino_models(n_channels, cfg)
    k1, k2, _ = jax.random.split(jax.random.key(cfg.seed), 3)
    bp = backbone.init(k1, jnp.zeros((1, cfg.global_length, n_channels)),
                       features_only=True)["params"]
    hp = head.init(k2, jnp.zeros((1, cfg.embed_dim)))["params"]
    return _dino_state_dict({"backbone": bp, "head": hp})


def _dino_state_dict(params):
    params = jax.tree.map(np.asarray, params)
    sd = {f"backbone.{k}": v for k, v in lstm.params_from_jax(params["backbone"]).items()}
    sd.update({f"head.{k}": v for k, v in heads.params_from_jax(params["head"]).items()})
    return sd


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=lambda s: "x".join(map(str, s)))
def test_dino_selfdistill_matches_the_jax_mesh(shape, monkeypatch):
    """The DINO-LSTM recipe on a (data, model) mesh: one step an epoch
    (n = the global batch), three epochs, the crops at fixed starts on both
    sides, AdamW at 1e-3 a step with the last layer free from the first
    step and the per-parameter clip at 0.02 binding on every parameter (the
    sharded last layer's norm is the whole layer's, summed over the model
    group). Every rank holds the losses, the gathered weights and center
    JAX holds; a model axis of 2 leaves each rank 8 of the 16 prototypes."""
    data, model = shape
    n, C, T = DINO["batch_size_per_device"] * data, 3, 16
    cfg = dict(DINO, lr=1e-3 * 256 / (DINO["batch_size_per_device"] * data))
    eeg = np.random.default_rng(2).normal(size=(n, T, C)).astype(np.float32)

    def fixed(key, x, global_length, local_length, n_global, n_local):
        return (jnp.stack([x[..., s:s + global_length, :] for s in STARTS[0][:n_global]]),
                jnp.stack([x[..., s:s + local_length, :] for s in STARTS[1][:n_local]]))

    monkeypatch.setattr("cerebra.train.steps.multicrop_views", fixed)
    jcfg = jrec.DinoSelfDistillConfig(**cfg)
    state, hist = jrec.dino_selfdistill_train(eeg, jcfg, mesh=_mesh(shape, ("data", "model")),
                                              log_fn=lambda m: None)
    before = _jax_dino_init(jcfg, C)
    ranks = tdist.run_world(tdist.dino_rank, data * model, eeg, cfg, before, STARTS, shape)
    student = _dino_state_dict(state.student_params)
    teacher = _dino_state_dict(state.teacher_params)
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["loss"], hist["loss"], rtol=TOL, err_msg=str(r))
        _state_dicts_close(out["student"], student, before, f"student, rank {r}", tol=ADAM_TOL)
        _state_dicts_close(out["teacher"], teacher, before, f"teacher, rank {r}", moved=1e-6,
                           tol=ADAM_TOL)
        tdist.close(out["center"], np.asarray(state.center), f"center, rank {r}")
        assert out["shard"] == (DINO["out_dim"] // model, 256), out["shard"]


def test_sharded_dino_checkpoints_hold_the_whole_head(tmp_path):
    """Prototypes over a model axis of 2: each rank trains 8 of 16, yet
    rank 0's checkpoint.pth and auto-resume files hold all 16 (gathered on
    every rank first); JAX's importer reads the checkpoint, moments
    included; a 3-epoch run cut after epoch 2 and started again resumes
    from its files and logs the third epoch of an unbroken run."""
    from cerebra.train import checkpoints as jck

    eeg = np.random.default_rng(5).normal(size=(4, 16, 3)).astype(np.float32)
    cfg = dict(DINO, lr=0.1)
    first = tdist.run_world(tdist.dino_checkpoint_rank, 2, eeg, cfg, str(tmp_path / "a"), 2)
    ck = torch.load(tmp_path / "a" / "checkpoint.pth", weights_only=False)
    assert ck["epoch"] == 2
    assert tuple(ck["student"]["module.head.last_layer.weight_v"].shape) == (16, 256)
    assert tuple(ck["dino_loss"]["center"].shape) == (1, 16)
    assert {tuple(s["exp_avg"].shape) for s in ck["optimizer"]["state"].values()} >= {(16, 256)}
    path = str(tmp_path / "a" / "checkpoint.pth")
    student = jax.tree.map(jnp.asarray, jck.import_dino_pth(path)[0])
    tx = make_scheduled_optimizer("adamw", [1e-3], [0.04], params_mask_source=student,
                                  clip_grad=cfg["clip_grad"])
    _, _, center, epoch, opt_state = jck.import_dino_pth(path, tx.init(student))
    assert epoch == 2 and np.shape(student["head"]["last_layer"]["v"]) == (256, 16)
    mu = jck._find_adam_state(opt_state).mu["head"]["last_layer"]["v"]
    assert np.shape(mu) == (256, 16) and float(np.abs(np.asarray(mu)).max()) > 0
    np.testing.assert_array_equal(center, ck["dino_loss"]["center"].numpy())
    resumed = tdist.run_world(tdist.dino_checkpoint_rank, 2, eeg, cfg, str(tmp_path / "a"))
    unbroken = tdist.run_world(tdist.dino_checkpoint_rank, 2, eeg, cfg, str(tmp_path / "b"))
    assert [out["shard"] for out in resumed] == [(8, 256)] * 2
    assert len(unbroken[0]["loss"]) == 3 and first[0]["loss"] == unbroken[0]["loss"][:2]
    assert resumed[0]["loss"] == unbroken[0]["loss"][2:] == resumed[1]["loss"]


# ------------------------------------------- one step at W = 2 against W = 1


@pytest.mark.parametrize("loss", ["feature_dist_v1", "feature_dist_v2", "cosine"])
def test_one_distill_step_at_two_ranks_equals_one_process(loss):
    C, T, H, F, K, B = 5, 12, 6, 8, 3, 8
    rng = np.random.default_rng(3)
    batch = (rng.normal(size=(B, T, C)).astype(np.float32),
             rng.normal(size=(B, F)).astype(np.float32), rng.integers(0, K, B))
    dims = (C, H, 2, F, True, K)
    sd = lstm.Model(*dims, generator=torch.Generator().manual_seed(0)).state_dict()
    tdist.world_equals_one(tdist.run_world(tdist.distill_step_rank, 2, sd, dims, batch, loss))


def test_one_dino_step_at_two_ranks_equals_one_process():
    """make_dino_step under DDP with the head sharded over a model axis of
    2 (a (1, 2) mesh: both ranks hold the whole batch) and over a data axis
    of 2, against one process."""
    ranks = tdist.run_world(tdist.dino_step_rank, 2, DINO, STARTS)
    tdist.world_equals_one([out["data"] for out in ranks])
    tdist.world_equals_one([out["model"] for out in ranks])


def test_one_dino_vit_step_at_two_ranks_equals_one_process():
    """main_dino's recipe: the windows of the EEG-image views are drawn for
    the global batch on every rank and each keeps its rows, so a step over
    two ranks (no drop path) is one process's step on the whole batch."""
    ranks = tdist.run_world(tdist.dino_vit_step_rank, 2)
    tdist.world_equals_one(ranks)
