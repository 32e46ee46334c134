"""Splits (copy of cerebra/data/sampling.py::random_split_indices)."""

from __future__ import annotations

from typing import List, Sequence

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
