"""The mesh of ranks and batch sharding (port of cerebra/parallel/mesh.py).

`Mesh` lays the world's ranks out as a row-major array of shape
(data, model) in JAX's order: rank r sits at mesh position r, so the ranks
of one model group are consecutive and a data group strides by the model
size. Each axis has one process group per line of the array; a rank keeps
the groups it belongs to. `torch.distributed` must be initialised
(`cerebra_torch.cli.common.init_distributed`) before a mesh is made.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """The world's ranks as an array over named axes, with this rank's
    process group and coordinate on each axis."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int]):
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if len(shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} for axes {self.axis_names}")
        world = dist.get_world_size()
        if int(np.prod(shape)) != world:
            raise ValueError(f"mesh shape {tuple(shape)} does not hold a world of {world}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.ranks = np.arange(world).reshape(tuple(shape))
        self.rank = dist.get_rank()
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(self.rank, self.ranks.shape))))
        self._groups = {}
        for i, name in enumerate(self.axis_names):
            # every rank creates every group, in one order (new_group is collective)
            lines = np.moveaxis(self.ranks, i, -1).reshape(-1, self.ranks.shape[i])
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self._groups[name] = group

    def group(self, axis: str = "data"):
        """The process group of this rank's line along `axis`."""
        return self._groups[axis]

    def size(self, axis: str = "data") -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str = "data") -> int:
        """This rank's coordinate along `axis` (0 for an absent axis)."""
        return self.coords.get(axis, 0)


def make_mesh(axes: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over the whole world, its groups on the world's backend.
    Default: a 1-D "data" mesh, the reference's DP world; axes=("data",
    "model") with a shape shards the DINO head over "model"."""
    if shape is None:
        shape = [dist.get_world_size()] + [1] * (len(axes) - 1)
    return Mesh(axes, shape)


def put_global(mesh: Mesh, arr, dim: int = 0, axis: str = "data"):
    """This rank's block of `arr` along `dim`, `arr` split over `axis`."""
    size = mesh.size(axis)
    if arr.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(arr.shape)} does not split over {size} ranks")
    b = arr.shape[dim] // size
    i = mesh.index(axis)
    index = [slice(None)] * arr.ndim
    index[dim] = slice(i * b, (i + 1) * b)
    return arr[tuple(index)]


def shard_batch(mesh: Mesh, batch, axis: str = "data"):
    """This rank's rows of a global batch: `put_global` along the leading
    dim of every array or tensor in a dict/list/tuple tree; 0-d leaves as
    they are."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v, axis) for v in batch)
    return batch if np.ndim(batch) == 0 else put_global(mesh, batch, 0, axis)


def data_parallel(module: torch.nn.Module, mesh: Mesh, find_unused_parameters: bool = False):
    """`module` under DDP over the mesh's data group: its parameters
    broadcast from the group's first rank, its gradients averaged over the
    group in buckets as backward produces them. Buffers are not broadcast
    at each forward: the port's BatchNorms take global statistics under a
    mesh, so their running statistics agree on every rank already."""
    from torch.nn.parallel import DistributedDataParallel

    with warnings.catch_warnings():  # newer torch renames the flag; 2.x keeps it
        warnings.simplefilter("ignore", FutureWarning)
        return DistributedDataParallel(module, process_group=mesh.group("data"),
                                       broadcast_buffers=False,
                                       find_unused_parameters=find_unused_parameters)
