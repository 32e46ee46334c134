"""Tensor parallelism over the mesh's "model" axis (port of
cerebra/parallel/tp.py).

The DINOHead's weight-normalised prototype layer (out_dim up to 65536,
dino/main_dino.py:55) shards over prototypes: the weight norm of a
prototype is local (a norm over the unsharded input dim), the logits split
by prototype, and every softmax, cross-entropy and center reduction over
prototypes becomes a reduction over the model group
(`losses/dino.py::dino_multicrop_loss`). `dino_tp_dim` is the rule of the
JAX `dino_tp_spec` in the port's layout: `last_layer.weight_v` (out, in)
and `last_layer.weight_g` (out, 1) shard their dim 0 (JAX's v (in, out) by
columns, g (out,)), so do their AdamW moments, and the center (1, out) its
dim 1; everything else replicates.

`shard_dino_state` slices a full DinoTrainState in place, this rank's
prototypes kept; `gathered_dino_state` rebuilds the full state on every rank
for a checkpoint and gives the shards back after. `shard_params_tp`
(column sharding of divisible 2-D arrays) remains for experiments.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.distributed as dist

from cerebra_torch.parallel.dataflow import put_global, put_replicated
from cerebra_torch.parallel.mesh import Mesh


def shard_params_tp(params: Dict[str, torch.Tensor], mesh: Mesh, axis: str = "model"
                    ) -> Dict[str, torch.Tensor]:
    """This rank's column block of every 2-D array whose last dim divides
    over `axis`; everything else as it is."""
    size = mesh.size(axis)
    return {k: put_global(mesh, v, 1, axis) if v.ndim == 2 and v.shape[-1] % size == 0
            and v.shape[-1] > 0 else v for k, v in params.items()}


def dino_tp_dim(name: str, leaf: torch.Tensor, model_size: int) -> Optional[int]:
    """The dim of a DINO state leaf that shards over the model axis (a
    student/teacher parameter by its state-dict name, or "center"), or None."""
    parts = name.split(".")
    if "last_layer" in parts and leaf.ndim == 2 and leaf.shape[0] % model_size == 0:
        return 0  # weight_v (out, in), weight_g (out, 1)
    if parts[-1] == "center" and leaf.ndim == 2 and leaf.shape[-1] % model_size == 0:
        return 1
    return None


def _sharded_leaves(state, model_size: int):
    """[(holder, key, dim)]: the parameters (holder = the Parameter, key
    None), their AdamW moments (holder = the optimizer state dict) and the
    center (holder = the state) that shard."""
    leaves = []
    moments = state.optimizer.inner.state
    for module in (state.student, state.teacher):
        for name, p in module.named_parameters():
            dim = dino_tp_dim(name, p, model_size)
            if dim is None:
                continue
            leaves.append((p, None, dim))
            for key in ("exp_avg", "exp_avg_sq"):
                if key in moments.get(p, {}):
                    leaves.append((moments[p], key, dim))
    if dino_tp_dim("center", state.center, model_size) is not None:
        leaves.append((state, "center", 1))
    return leaves


def _get(holder, key):
    if key is None:
        return holder.data
    return holder[key] if isinstance(holder, dict) else getattr(holder, key)


def _set(holder, key, value):
    if key is None:
        holder.data = value
    elif isinstance(holder, dict):
        holder[key] = value
    else:
        setattr(holder, key, value)


def _heads(state):
    return [m.head for m in (state.student, state.teacher)]


def shard_dino_state(mesh: Mesh, state, axis: str = "model",
                     out_dim: Optional[int] = None) -> None:
    """Lay a full DinoTrainState out over the mesh, in place: every rank
    takes rank 0's values (the student's and teacher's parameters and
    buffers and the center), then, where a `model` axis of size > 1 divides
    out_dim, keeps its prototypes of the sharded leaves, and the heads and
    the optimizer learn their model group. Call before the first step and
    before DDP wraps the student."""
    for module in (state.student, state.teacher):
        put_replicated(module)
    put_replicated(state.center)
    size = mesh.size(axis)
    if size <= 1 or (out_dim is not None and out_dim % size):
        return
    group = mesh.group(axis)
    for holder, key, dim in _sharded_leaves(state, size):
        _set(holder, key, put_global(mesh, _get(holder, key), dim, axis).clone())
    for head in _heads(state):
        head.model_group = group
    state.optimizer.shard_group(group, [p for p, key, _ in _sharded_leaves(state, size)
                                        if key is None and p.requires_grad])


@contextlib.contextmanager
def gathered_dino_state(state):
    """Inside the block the sharded leaves hold the full prototype axis on
    every rank (a collective: every rank of the world enters); after it,
    each holds its shards again. A state that is not sharded passes
    through."""
    group = state.student.head.model_group
    if group is None:
        yield state
        return
    size = dist.get_world_size(group)
    shards = _sharded_leaves(state, 1)  # the shards divide by 1: the names pick the leaves
    kept = []
    for holder, key, dim in shards:
        local = _get(holder, key)
        parts = [torch.empty_like(local) for _ in range(size)]
        dist.all_gather(parts, local.contiguous(), group=group)
        kept.append(local)
        _set(holder, key, torch.cat(parts, dim=dim))
    heads = _heads(state)
    for head in heads:
        head.model_group = None
    try:
        yield state
    finally:
        for (holder, key, _), local in zip(shards, kept):
            _set(holder, key, local)
        for head in heads:
            head.model_group = group
