"""Named collectives over a process group (port of
cerebra/parallel/collectives.py; the reference's torch.distributed calls).

| reference                                         | here            |
|----------------------------------------------------|-----------------|
| dist.all_reduce(center) (dino/main_dino.py:477)    | pmean           |
| dist.all_reduce(c) (EEG-BarlowNetworks/net.py:38)  | psum            |
| dist.all_gather(feats) (PerilsEEGDataset.py:194)   | all_gather      |
| metric sync all_reduce (utils/utils.py:248-251)    | psum            |

`psum`, `pmean` and `all_gather` are differentiable, as JAX's are: the
backward of a sum over the group is a sum over the group of the incoming
gradients, and the backward of a gather is that sum sliced to this rank's
block. So when every rank holds the same global loss, each rank's gradient
is the group size times its share of the true gradient, and DDP's mean over
the group gives the gradient of the global loss.

Two conjugate ops serve the "model" axis (Megatron's f and g):
`copy_to_group` is the identity forward and a sum of the gradients
backward (a replicated input to a sharded layer); `reduce_from_group` is a
sum forward and the identity backward (the last reduction of a loss every
rank of the group then holds). `group=None` is the whole world.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def axis_size(group=None) -> int:
    """world_size of the group (utils/utils.py:429-433)."""
    return dist.get_world_size(group)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        ctx.index, ctx.size = dist.get_rank(group), dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(ctx.size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=axis)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.chunk(ctx.size, dim=ctx.axis)[ctx.index].contiguous(), None, None


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group; the backward sums the gradients over it."""
    return _Psum.apply(x, group)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    return psum(x, group) / axis_size(group)


def all_gather(x: torch.Tensor, group=None, axis: int = 0) -> torch.Tensor:
    """The group's blocks of `x`, in rank order, concatenated along `axis`
    (JAX's all_gather with tiled=True)."""
    return _AllGather.apply(x, group, axis)


def copy_to_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """Identity forward; the gradients of the group summed backward."""
    return _Copy.apply(x, group)


def reduce_from_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group forward; identity backward."""
    return _Reduce.apply(x, group)


@torch.no_grad()
def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise max over the group (no gradient)."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out
