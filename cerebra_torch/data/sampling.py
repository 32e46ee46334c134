"""Splits and epoch batches (copy of cerebra/data/sampling.py:
random_split_indices, epoch_batches)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def random_split_indices(n: int, fractions: Sequence[float], seed: int = 43) -> List[np.ndarray]:
    """Split `range(n)` like torch.utils.data.random_split with
    `torch.Generator().manual_seed(seed)` (LstmDistillFromDinoV2Train.py:
    289-290): floor(n * frac) per split, remainders distributed round-robin
    from the first split, and each split in randperm order."""
    lengths = [int(np.floor(n * f)) for f in fractions]
    for i in range(n - sum(lengths)):
        lengths[i % len(lengths)] += 1
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed)).numpy()
    out, offset = [], 0
    for length in lengths:
        out.append(perm[offset : offset + length].astype(np.int64))
        offset += length
    return out


def epoch_batches(
    n: int, batch_size: int, *, seed: int = 0, epoch: int = 0
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """All batches of an epoch as one (num_batches, batch_size) index array,
    in the order `np.random.default_rng((seed, epoch))` gives. When n is not
    a multiple of batch_size, the tail batch is padded by wrapping the
    permutation, and the returned mask marks the real entries."""
    order = np.random.default_rng((seed, epoch)).permutation(n)
    num_batches = int(np.ceil(n / batch_size))
    padded = num_batches * batch_size
    mask = None
    if padded != n:
        # wrap as many times as needed (batch_size may exceed n)
        pad = np.resize(order, padded - n)
        mask = np.ones((padded,), dtype=bool)
        mask[n:] = False
        order = np.concatenate([order, pad])
        mask = mask.reshape(num_batches, batch_size)
    return order.reshape(num_batches, batch_size), mask
