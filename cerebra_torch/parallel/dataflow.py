"""Sharded corpora and shard-local batches (port of
cerebra/parallel/dataflow.py).

The reference's DDP + DistributedSampler input path, as the JAX package
lays it out:

- `blocked_corpus` wrap-pads an (N, ...) corpus to n_data·n_local rows
  (n_local = ceil(N/n_data); the padding repeats rows cyclically, the
  DistributedSampler's `total_size` rule, so no row is dropped) and blocks it
  as (n_data, n_local, ...). `shard_corpus` keeps rank d's block d.
- `local_epoch_indices` gives every data rank its own per-epoch permutation
  of its block, seeded by (seed, epoch, 17), truncated or cyclically extended
  to n_steps·batch_local draws. The stream differs from the one-device
  recipes' `np.random.default_rng((seed, epoch))`, so a world of one takes
  the one-device path.
- A step's batch is plain indexing into the rank's block: rank d's rows of
  the global batch are block d at `idx[step, d]`, the JAX gather's rows.

`put_global` (`mesh.py`'s, re-exported) and `put_replicated` become
"take my block" and "broadcast from rank 0". Every rank holds the whole host corpus, as every DDP rank
loads the whole .pth.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from cerebra_torch.parallel.mesh import Mesh, put_global  # noqa: F401  (re-exported)


def blocked_corpus(arr: np.ndarray, n_data: int) -> np.ndarray:
    """(N, ...) → (n_data, n_local, ...), N wrap-padded cyclically."""
    N = arr.shape[0]
    n_local = -(-N // n_data)
    total = n_data * n_local
    if total != N:
        # np.resize semantics: a single arr[:pad] under-fills when pad > N
        reps = np.concatenate([arr] * (-(-(total - N) // max(N, 1)) + 1), axis=0)
        arr = np.concatenate([arr, reps[: total - N]], axis=0)[:total]
    return np.ascontiguousarray(arr.reshape((n_data, n_local) + arr.shape[1:]))


def shard_corpus(mesh: Mesh, arr: np.ndarray, axis: str = "data") -> Tuple[np.ndarray, int]:
    """(N, ...) host corpus → (this rank's block (n_local, ...), n_local)."""
    blocked = blocked_corpus(arr, mesh.size(axis))
    return blocked[mesh.index(axis)], blocked.shape[1]


def local_epoch_indices(n_local: int, n_data: int, batch_local: int, n_steps: int, seed,
                        epoch: int) -> np.ndarray:
    """(n_steps, n_data, batch_local) int32: every data rank's draws for one
    epoch, the same on every process (the JAX function, bit for bit)."""
    rng = np.random.default_rng((int(seed), int(epoch), 17))
    need = n_steps * batch_local
    out = np.empty((n_data, need), np.int32)
    for d in range(n_data):
        perm = rng.permutation(n_local).astype(np.int32)
        out[d] = np.resize(perm, need)
    return np.ascontiguousarray(out.reshape(n_data, n_steps, batch_local).transpose(1, 0, 2))


def rank_seed(seed: int, index: int) -> int:
    """A seed of data rank `index`'s own from the run's seed (the per-rank
    dropout and drop-path streams)."""
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1)[0])


def put_replicated(module_or_tensor):
    """Rank 0's values on every rank of the world, in place (a module's
    parameters and buffers, or one tensor): the reference's DDP init
    broadcast."""
    if isinstance(module_or_tensor, torch.nn.Module):
        tensors = list(module_or_tensor.parameters()) + list(module_or_tensor.buffers())
    else:
        tensors = [module_or_tensor]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, 0)
    return module_or_tensor
