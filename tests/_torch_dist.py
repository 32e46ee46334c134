"""Gloo worlds for the port's distributed tests, the work their ranks do,
and the checks on what they return.

`run_world(fn, world, *args)` starts `world` fresh processes
(torch.multiprocessing, spawn: the test process runs JAX's threads, which a
fork would copy mid-flight), each with one torch thread and the env://
variables of its rank, brings the process group up through the port's
`init_distributed` (gloo on the CPU) and returns every rank's `fn(*args)`.
This module imports neither JAX nor the JAX package: the ranks import it.
"""

from __future__ import annotations

import copy
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cerebra_torch.cli.common import init_distributed
from cerebra_torch.cli.launch import _free_port
from cerebra_torch.parallel import collectives
from cerebra_torch.parallel.mesh import make_mesh, shard_batch

CPU = torch.device("cpu")


def _rank_main(rank, fn, world, port, out_dir, args):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    init_distributed(CPU)
    try:
        torch.save(fn(*args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_world(fn, world: int, *args) -> list:
    """[fn(*args) on rank r for r in range(world)]; any rank's exception
    raises here."""
    with tempfile.TemporaryDirectory() as out_dir:
        mp.start_processes(_rank_main, args=(fn, world, _free_port(), out_dir, args),
                           nprocs=world, start_method="spawn", join=True)
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


TOL = 1e-5


def close(got, want, what, tol=TOL):
    """max |got − want| within `tol` of the largest |want|, or of 1."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def world_equals_one(ranks, zero_grad=(), lr=0.0):
    """`zero_grad`: parameters whose gradient is 0 in exact arithmetic (a
    bias ahead of a BatchNorm): both sides' gradients are f32 noise, below
    1e-5 of the largest gradient's norm, and Adam's step on them is held
    to its bound, 2·lr."""
    for r, out in enumerate(ranks):
        one, world = out["one"], out["world"]
        np.testing.assert_allclose(float(world["loss"]), float(one["loss"]), rtol=TOL,
                                   err_msg=f"rank {r}")
        assert sorted(world["grads"]) == sorted(one["grads"])
        scale = max(float(g.double().norm()) for g in one["grads"].values())
        for k, g in one["grads"].items():
            diff = float((world["grads"][k] - g).double().norm())
            if k in zero_grad:
                assert max(float(g.norm()), float(world["grads"][k].norm())) <= 1e-5 * scale, k
                continue
            err = diff / max(float(g.double().norm()), 1e-30)
            assert err <= TOL, (r, k, err, float(g.norm()))
        for k, v in one["params"].items():
            if k in zero_grad:
                assert float((world["params"][k] - v).abs().max()) <= 2 * lr, (r, k)
            else:
                close(world["params"][k], v, f"rank {r} {k}")


def _sd(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _grads(module) -> dict:
    return {n: p.grad.detach().clone() for n, p in module.named_parameters()
            if p.grad is not None}


# ------------------------------------------------------------ collectives


def collectives_rank(x: np.ndarray, c: np.ndarray) -> dict:
    """This rank's row of x (world, n): psum, pmean, all_gather, axis_size,
    and the gradients in its row of sum(psum(x)² · c) and
    sum(all_gather(x)³ · c) (c (n,), (world, n)); a MetricLogger meter
    after `synchronize_between_processes`; `shard_params_tp` of three
    arrays over a (2, 2) mesh's model axis."""
    r = dist.get_rank()
    out = {"size": collectives.axis_size()}
    xr = torch.from_numpy(x[r]).requires_grad_(True)
    s = collectives.psum(xr)
    out["psum"], out["pmean"] = s.detach(), collectives.pmean(xr).detach()
    (s ** 2 * torch.from_numpy(c[0])).sum().backward()
    out["psum_grad"] = xr.grad.clone()
    xr.grad = None
    g = collectives.all_gather(xr[None])
    out["gather"] = g.detach()
    (g ** 3 * torch.from_numpy(c)).sum().backward()
    out["gather_grad"] = xr.grad.clone()
    from cerebra_torch.utils.logging import MetricLogger

    logger = MetricLogger()
    for v in range(r + 1):  # rank r logs r + 1 values of r
        logger.update(loss=float(r))
    logger.synchronize_between_processes()
    out["meter"] = (logger.loss.count, logger.loss.total, logger.loss.value)
    from cerebra_torch.parallel.tp import shard_params_tp

    params = {"kernel": torch.arange(16 * 64.0).reshape(16, 64), "bias": torch.arange(64.0),
              "odd": torch.arange(16 * 7.0).reshape(16, 7)}
    out["tp"] = shard_params_tp(params, make_mesh(("data", "model"), (2, 2)))
    return out


# ------------------------------------------------------- the recipes, fed


def _loaded(factory, state_dict):
    """`factory` whose modules start from `state_dict` (the weights JAX's
    recipe initialises)."""
    def make(*args, **kwargs):
        module = factory(*args, **kwargs)
        module.load_state_dict(state_dict)
        return module
    return make


def feature_distill_rank(args, cfg_kwargs: dict, state_dict: dict) -> dict:
    """`feature_distill_train` over a 1-D data mesh of the world from
    `state_dict` → its epoch losses and final weights."""
    from cerebra_torch.train import recipes

    recipes.Model = _loaded(recipes.Model, state_dict)
    model, hist = recipes.feature_distill_train(
        *args, device=CPU, config=recipes.FeatureDistillConfig(**cfg_kwargs),
        log_fn=lambda m: None, mesh=make_mesh())
    return {"loss": hist["train_loss"], "params": _sd(model)}


def fixed_multicrop(starts):
    """The port's `multicrop_views` with the crops at `starts` = (global
    starts, local starts), whatever the generator."""
    def views(eeg, global_length, local_length, n_global, n_local, generator=None):
        g = torch.stack([eeg[..., s:s + global_length, :] for s in starts[0][:n_global]])
        l = torch.stack([eeg[..., s:s + local_length, :] for s in starts[1][:n_local]])
        return g, l
    return views


def dino_rank(eeg, cfg_kwargs: dict, state_dict: dict, starts, shape) -> dict:
    """`dino_selfdistill_train` over a (data, model) mesh of `shape` from
    `state_dict` (student and teacher), crops at `starts` → its epoch losses
    and the gathered student, teacher and center; the sharded last layer's
    shape on this rank."""
    from cerebra_torch.parallel.tp import gathered_dino_state
    from cerebra_torch.train import recipes, steps

    steps.multicrop_views = fixed_multicrop(starts)
    make = recipes.make_dino_lstm

    def make_loaded(*args, **kwargs):
        state, step, niter = make(*args, **kwargs)
        state.student.load_state_dict(state_dict)
        state.teacher.load_state_dict(state_dict)
        return state, step, niter

    recipes.make_dino_lstm = make_loaded
    state, hist = recipes.dino_selfdistill_train(
        eeg, CPU, recipes.DinoSelfDistillConfig(**cfg_kwargs), log_fn=lambda m: None,
        mesh=make_mesh(("data", "model"), shape))
    shard = tuple(state.student.head.last_layer.weight_v.shape)
    with gathered_dino_state(state):
        return {"loss": hist["loss"], "student": _sd(state.student),
                "teacher": _sd(state.teacher), "center": state.center.clone(), "shard": shard}


def barlow_rank(images, eeg, cfg_kwargs: dict, state_dict: dict) -> dict:
    """`barlow_train` over a 1-D data mesh from `state_dict` → its epoch
    losses and final weights and statistics."""
    from cerebra_torch.train import barlow_recipe

    barlow_recipe.BarlowTwins = _loaded(barlow_recipe.BarlowTwins, state_dict)
    model, hist = barlow_recipe.barlow_train(
        images, eeg, barlow_recipe.BarlowConfig(**cfg_kwargs), log_fn=lambda m: None,
        device=CPU, mesh=make_mesh())
    return {"loss": hist["loss"], "params": _sd(model)}


# ------------------------------------------------ one step, W ranks vs one


def _step_pair(build, step, batch, **extra):
    """Two copies of `build()`: one steps on the whole `batch` alone, the
    other on this rank's rows under DDP over the world's data group. →
    {loss, grads, params} of each ("one", "world")."""
    from cerebra_torch.parallel.mesh import data_parallel

    mesh = make_mesh()
    one = build()
    world = copy.deepcopy(one)
    out = {"one": step(one, batch, None)}
    out["one"].update(grads=_grads(one), params=_sd(one))
    ddp = data_parallel(world, mesh, **extra)
    out["world"] = step(ddp, shard_batch(mesh, batch), mesh)
    out["world"].update(grads=_grads(world), params=_sd(world))
    return out


def distill_step_rank(state_dict, dims, batch, loss: str) -> dict:
    """One RMSprop step of the feature-distill recipe's step and loss."""
    from cerebra_torch.models.lstm import Model
    from cerebra_torch.train.optim import make_optimizer
    from cerebra_torch.train.recipes import FeatureDistillConfig, distill_loss
    from cerebra_torch.train.steps import feature_distill_step

    cfg = FeatureDistillConfig(loss=loss)
    temps = np.full(4, 0.5, np.float32)

    def build():
        m = Model(*dims)
        m.load_state_dict(state_dict)
        return m

    def step(model, b, mesh):
        opt = make_optimizer("rmsprop", model.parameters(), 1e-3)
        eeg, feats, labels = (torch.from_numpy(a) for a in b)
        loss_fn = distill_loss(cfg, temps, mesh and mesh.group("data"))
        return {"loss": feature_distill_step(model, opt, loss_fn, eeg, feats, labels, 1)}

    return _step_pair(build, step, batch, find_unused_parameters=loss != "feature_dist_v1")


def barlow_step_rank(state_dict, projector, batch) -> dict:
    """One LARS step of `barlow_step`, SyncBN under the world, in f64: in
    f32 either side's gradients carry up to ~6e-3 of rounding (the batch-16
    BatchNorms subtract most of each column's gradient), one process's as
    often as the ranks', so f32 cannot tell them apart at 1e-5."""
    from cerebra_torch.models.barlow import BarlowTwins
    from cerebra_torch.models.batchnorm import sync_batchnorm
    from cerebra_torch.train.barlow_recipe import BarlowConfig, barlow_optimizer, barlow_step

    cfg = BarlowConfig(epochs=1, batch_size=len(batch[0]), projector=projector,
                       warmup_epochs=0)

    def build():
        m = BarlowTwins(projector, eeg_in_channels=batch[1].shape[-1])
        m.load_state_dict(state_dict)
        return m.double()

    def step(model, b, mesh):
        group = mesh and mesh.group("data")
        inner = getattr(model, "module", model)
        sync_batchnorm(inner, group)
        opt = barlow_optimizer(inner, cfg, 1)
        y1, y2 = (torch.from_numpy(a).double() for a in b)
        return {"loss": barlow_step(model, opt, y1, y2, 0, cfg.lambd, group)}

    return _step_pair(build, step, batch)


def conformer_step_rank(state_dict, dims, batch, masks) -> dict:
    """One Adam step of `conformer_step` with the dropout `masks` (numpy,
    global batch first), SyncBN under the world."""
    from cerebra_torch.models.batchnorm import sync_batchnorm
    from cerebra_torch.models.conformer import Conformer
    from cerebra_torch.train.conformer_recipe import conformer_step

    x, y = batch

    def build():
        m = Conformer(x.shape[2], x.shape[3], **dims)
        m.load_state_dict(state_dict)
        return m

    def step(model, b, mesh):
        group = mesh and mesh.group("data")
        inner = getattr(model, "module", model)
        sync_batchnorm(inner, group)
        opt = torch.optim.Adam(inner.parameters(), lr=2e-4, betas=(0.5, 0.999), eps=1e-8)
        rank_masks = masks if mesh is None else [shard_batch(mesh, m) for m in masks]
        return {"loss": conformer_step(model, opt, torch.from_numpy(b[0]), torch.from_numpy(b[1]),
                                       replay(rank_masks), group)}

    return _step_pair(build, step, batch)


def replay(masks):
    """`drop(x, rate)` that applies `masks` (numpy) in order (the masks of
    tests/_flax_dropout.py without its JAX half)."""
    it = iter(masks)

    def drop(x, rate):
        mask = torch.from_numpy(np.asarray(next(it)))
        assert tuple(mask.shape) == tuple(x.shape), (mask.shape, x.shape)
        return torch.where(mask, x / (1.0 - rate), torch.zeros((), dtype=x.dtype))

    return drop


def _gathered_grads(module, group) -> dict:
    """The module's gradients, the prototype shards gathered over `group`."""
    from cerebra_torch.parallel.tp import dino_tp_dim

    out = _grads(module)
    if group is not None:
        size = dist.get_world_size(group)
        for name, g in out.items():
            dim = dino_tp_dim(name, g, 1)
            if dim is not None:
                parts = [torch.empty_like(g) for _ in range(size)]
                dist.all_gather(parts, g.contiguous(), group=group)
                out[name] = torch.cat(parts, dim)
    return out


def dino_step_rank(cfg_kwargs: dict, starts) -> dict:
    """One DINO-LSTM step (`make_dino_step`, crops at `starts`) on a batch
    of 4 over a (2, 1) and a (1, 2) mesh against one process on the whole
    batch with the same global batch (so the same schedules) → {"data",
    "model"}: {"one", "world"} of loss, gradients (prototype shards
    gathered) and parameters."""
    import dataclasses

    from cerebra_torch.parallel.tp import gathered_dino_state
    from cerebra_torch.train import recipes, steps

    steps.multicrop_views = fixed_multicrop(starts)
    cfg = recipes.DinoSelfDistillConfig(**cfg_kwargs)
    B, T, C = 4, 16, 3
    eeg = torch.from_numpy(np.random.default_rng(4).normal(size=(B, T, C)).astype(np.float32))
    out = {}
    for name, shape in (("data", (2, 1)), ("model", (1, 2))):
        mesh = make_mesh(("data", "model"), shape)
        one_cfg = dataclasses.replace(cfg, batch_size_per_device=B)
        one, one_step, _ = recipes.make_dino_lstm(one_cfg, B, C, CPU)
        world_cfg = dataclasses.replace(cfg, batch_size_per_device=B // shape[0])
        world, world_step, _ = recipes.make_dino_lstm(world_cfg, B, C, CPU, mesh=mesh)
        steps.distribute_dino_state(mesh, world, cfg.out_dim)
        one, m_one = one_step(one, eeg)
        world, m_world = world_step(world, shard_batch(mesh, eeg))
        pair = {"one": {"loss": m_one["loss"], "grads": _grads(one.student),
                        "params": _sd(one.student)},
                "world": {"loss": m_world["loss"],
                          "grads": _gathered_grads(world.student, world.student.head.model_group)}}
        with gathered_dino_state(world):
            pair["world"]["params"] = _sd(world.student)
        out[name] = pair
    return out


def conformer_world_rank(state_dict, dims, batches, masks) -> dict:
    """`conformer_step` under DDP over the world's data group, one step a
    (x, y) global batch with its dropout masks, this rank's rows of each →
    the losses and the final weights and statistics."""
    from cerebra_torch.models.batchnorm import sync_batchnorm
    from cerebra_torch.models.conformer import Conformer
    from cerebra_torch.parallel.mesh import data_parallel
    from cerebra_torch.train.conformer_recipe import conformer_step

    mesh = make_mesh()
    x0 = batches[0][0]
    model = Conformer(x0.shape[2], x0.shape[3], **dims)
    model.load_state_dict(state_dict)
    sync_batchnorm(model, mesh.group("data"))
    opt = torch.optim.Adam(model.parameters(), lr=2e-4, betas=(0.5, 0.999), eps=1e-8)
    ddp = data_parallel(model, mesh)
    losses = []
    for (x, y), step_masks in zip(batches, masks):
        x, y = shard_batch(mesh, (x, y))
        drop = replay([shard_batch(mesh, m) for m in step_masks])
        losses.append(float(conformer_step(ddp, opt, torch.from_numpy(x), torch.from_numpy(y),
                                           drop, mesh.group("data"))))
    return {"loss": losses, "params": _sd(model)}


class _Stop(Exception):
    pass


def dino_checkpoint_rank(eeg, cfg_kwargs: dict, log_dir: str, stop=None) -> dict:
    """The DINO-LSTM recipe with the prototypes over a (1, world) mesh,
    rank 0 writing `checkpoint.pth` (the reference layout, AdamW moments
    in it) every epoch and the auto-resume saving each epoch into
    `log_dir/resume`, the run cut after epoch `stop` when given: → the
    epoch losses logged and this rank's head shard."""
    from cerebra_torch.train import recipes
    from cerebra_torch.train.checkpoints import export_dino_pth
    from cerebra_torch.train.resume import AutoResume
    from cerebra_torch.utils.config import is_main_process

    losses = []

    def checkpoint_cb(epoch, state):
        if is_main_process():
            export_dino_pth(os.path.join(log_dir, "checkpoint.pth"), state.student,
                            state.teacher, state.center, epoch, optimizer=state.optimizer)
        if stop is not None and epoch + 1 == stop:
            raise _Stop

    cfg = recipes.DinoSelfDistillConfig(**cfg_kwargs)
    mesh = make_mesh(("data", "model"), (1, dist.get_world_size()))

    def log(msg):  # "EPOCH e dino_loss: x (...)"
        if msg.startswith("EPOCH"):
            losses.append(float(msg.split()[3]))

    try:
        state, _ = recipes.dino_selfdistill_train(
            eeg, CPU, cfg, log_fn=log, checkpoint_cb=checkpoint_cb,
            resume=AutoResume(os.path.join(log_dir, "resume")), mesh=mesh)
        shard = tuple(state.student.head.last_layer.weight_v.shape)
    except _Stop:
        shard = None
    return {"loss": losses, "shard": shard}


def dino_vit_step_rank() -> dict:
    """One `dino_vit_train` step (ViT-Ti/16 at 32 px, no drop path, the
    EEG-image views drawn for the global batch of 4) over a (2, 1) mesh
    against one process on the whole batch → {"one", "world"} of loss,
    gradients and parameters."""
    import dataclasses

    from cerebra_torch.train import dino_vit, steps

    cfg = dino_vit.DinoVitConfig(arch="vit_tiny", patch_size=16, out_dim=32, epochs=2,
                                 batch_size_per_device=2, global_size=32, local_size=16,
                                 drop_path_rate=0.0, warmup_epochs=0, freeze_last_layer=0)
    B = 4
    eeg = torch.from_numpy(np.random.default_rng(6).normal(size=(B, 40, 6)).astype(np.float32))
    mesh = make_mesh(("data", "model"), (2, 1))
    one, one_step, gen_one, _ = dino_vit.make_dino_vit(
        dataclasses.replace(cfg, batch_size_per_device=B), B, CPU)
    world, world_step, gen_world, _ = dino_vit.make_dino_vit(cfg, B, CPU, mesh=mesh)
    steps.distribute_dino_state(mesh, world, cfg.out_dim)
    one, m_one = one_step(one, eeg, gen_one)
    world, m_world = world_step(world, shard_batch(mesh, eeg), gen_world)
    return {"one": {"loss": m_one["loss"], "grads": _grads(one.student),
                    "params": _sd(one.student)},
            "world": {"loss": m_world["loss"], "grads": _grads(world.student),
                      "params": _sd(world.student)}}
