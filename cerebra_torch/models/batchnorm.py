"""BatchNorm as flax's `nn.BatchNorm(momentum=0.9)` computes it, under
torch's module names and state-dict keys.

In training mode both normalise with the batch's biased variance, but
torch's `nn.BatchNorm{1,2}d` folds the *unbiased* one into `running_var`
(n/(n-1) larger), flax the biased one. These modules fold the biased
variance, at torch momentum 0.1 (flax's decay 0.9), and compute in f32 for a
bf16 or f16 input (flax's statistics and normalisation are f32; the output
takes the input's dtype). Eval mode uses the running statistics, as torch does.

`update_once` runs a function (a checkpointed stage or block) so that only
its first call moves the running statistics: a recompute of the same
forward leaves them as the first pass left them, as flax's remat does.

Under a mesh flax normalises with the global batch's statistics (GSPMD
reduces over the sharded batch). `sync_batchnorm(module, group)` gives every
BatchNorm of a module a process group: training mode then gathers each
rank's count, mean and sum of squared deviations (one differentiable
all-gather, `parallel/collectives.py::all_gather`), merges them into the
global batch's mean and biased variance (torch's SyncBatchNorm merges its
Welford moments the same way; the one-device path's two-pass variance is
kept, where flax's E[x²] − E[x]² would cancel on a large mean) and folds
that variance into `running_var` as above.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from cerebra_torch.parallel.collectives import all_gather

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # flax's momentum 0.9 is the decay; torch's is the new batch's weight


class _FlaxStats:
    """The training-mode forward of flax's BatchNorm over a torch
    `_BatchNorm`; `frozen` > 0 holds the running statistics (a recompute);
    `group` (a process group) takes the statistics over its global batch."""

    frozen = 0
    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        dtype = x.dtype
        xf = x.float() if dtype in (torch.float16, torch.bfloat16) else x
        if not self.training:
            y = F.batch_norm(xf, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.eps)
            return y.to(dtype)
        if self.group is not None:
            y, mean, var = self._global_batch_norm(xf)
        else:
            y, mean, invstd = torch.native_batch_norm(xf, self.weight, self.bias, None, None,
                                                      True, 0.0, self.eps)
            var = invstd.pow(-2) - self.eps  # the biased batch variance
        if not self.frozen:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean * m)
                self.running_var.mul_(1.0 - m).add_(var * m)
                self.num_batches_tracked.add_(1)
        return y.to(dtype)

    def _global_batch_norm(self, x: torch.Tensor):
        """(y, mean, biased var) over the group's global batch; x is f32
        with the channels at dim 1. Each rank's count, mean and sum of
        squared deviations are gathered and merged (Chan et al.'s pairwise
        rule), so the variance is the two-pass one of the whole batch."""
        C = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        shape = [1, C] + [1] * (x.dim() - 2)
        mean = x.mean(dims)
        m2 = ((x - mean.view(shape)) ** 2).sum(dims)
        count = torch.full((1,), x.numel() // C, dtype=x.dtype, device=x.device)
        parts = all_gather(torch.cat([mean, m2, count])[None], self.group)  # (W, 2C + 1)
        counts = parts[:, 2 * C:]
        total = counts.sum()
        mean = (parts[:, :C] * counts).sum(0) / total
        var = (parts[:, C:2 * C].sum(0) + (counts * (parts[:, :C] - mean) ** 2).sum(0)) / total
        y = (x - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        if self.weight is not None:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        return y, mean.detach(), var.detach()


class BatchNorm1d(_FlaxStats, nn.BatchNorm1d):
    def __init__(self, num_features: int, eps: float = BN_EPS, momentum: float = BN_MOMENTUM):
        super().__init__(num_features, eps=eps, momentum=momentum)


class BatchNorm2d(_FlaxStats, nn.BatchNorm2d):
    def __init__(self, num_features: int, eps: float = BN_EPS, momentum: float = BN_MOMENTUM):
        super().__init__(num_features, eps=eps, momentum=momentum)


def sync_batchnorm(module: nn.Module, group) -> nn.Module:
    """Every BatchNorm of `module` takes its training statistics over
    `group` (None: each over its own batch again)."""
    for m in module.modules():
        if isinstance(m, _FlaxStats):
            m.group = group
    return module


@contextlib.contextmanager
def stats_frozen(module: nn.Module):
    """Hold the running statistics of every BatchNorm in `module`."""
    bns = [m for m in module.modules() if isinstance(m, _FlaxStats)]
    for m in bns:
        m.frozen += 1
    try:
        yield
    finally:
        for m in bns:
            m.frozen -= 1


def update_once(fn: Callable, module: nn.Module) -> Callable:
    """`fn` as checkpoint's function: its first call moves the running
    statistics of `module`'s BatchNorms, every later call (checkpoint's
    recompute, at any depth of nesting) leaves them. Make one per forward."""
    calls = [0]

    def run(*args):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*args)
        with stats_frozen(module):
            return fn(*args)

    return run
