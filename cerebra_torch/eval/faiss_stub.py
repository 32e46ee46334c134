"""A drop-in `faiss` replacement backed by the native C++ top-k
(native/topk_l2.cpp via cerebra_torch.eval.native_topk; port of
cerebra/eval/faiss_stub.py).

faiss is the reference's only native dependency (SURVEY.md §2.8.1:
`faiss.IndexFlatL2` at utils/Utilities.py:45-55 and 6 clones) and is not
installed on the GPU machine. This stub implements the exact API surface
the reference uses — `IndexFlatL2(d)`, `.is_trained`, `.add`, `.ntotal`,
`.search(q, k) -> (D, I)` with squared-L2 distances — so the reference's own
`evaluate` can run as a parity oracle against
`cerebra_torch.eval.scores.evaluate`.

`install()` registers the stub as `sys.modules["faiss"]`; it never shadows a
real faiss installation.
"""

from __future__ import annotations

import sys
import types

import numpy as np

from cerebra_torch.eval.native_topk import topk_l2_native


class IndexFlatL2:
    """Exact squared-L2 index (faiss semantics: ascending distances,
    ties broken toward the lower gallery index)."""

    def __init__(self, d: int):
        self.d = int(d)
        self.is_trained = True
        self._chunks = []

    @property
    def ntotal(self) -> int:
        return sum(len(c) for c in self._chunks)

    def add(self, x) -> None:
        arr = np.ascontiguousarray(np.asarray(x), dtype=np.float32).reshape(-1, self.d)
        self._chunks.append(arr)

    def reset(self) -> None:
        self._chunks = []

    def search(self, q, k: int):
        query = np.ascontiguousarray(np.asarray(q), dtype=np.float32).reshape(-1, self.d)
        if not self._chunks:  # faiss on an empty index: sentinel fill, no crash
            return (
                np.full((len(query), int(k)), np.float32(3.4028235e38)),
                np.full((len(query), int(k)), -1, dtype=np.int64),
            )
        gallery = (
            np.concatenate(self._chunks, axis=0)
            if len(self._chunks) != 1
            else self._chunks[0]
        )
        D, I = topk_l2_native(gallery, query, int(k))
        if D.shape[1] < int(k):  # faiss returns exactly k columns even when
            # ntotal < k, padded with FLT_MAX distances and -1 ids
            pad = int(k) - D.shape[1]
            D = np.concatenate(
                [D, np.full((len(query), pad), np.float32(3.4028235e38))], axis=1
            )
            I = np.concatenate(
                [I, np.full((len(query), pad), -1, dtype=I.dtype)], axis=1
            )
        return D, I


def install() -> types.ModuleType:
    """Register this stub as the `faiss` module if none is installed."""
    if "faiss" in sys.modules:
        return sys.modules["faiss"]
    try:
        import faiss  # noqa: F401  — a real install wins

        return sys.modules["faiss"]
    except ImportError:
        pass
    mod = types.ModuleType("faiss")
    mod.IndexFlatL2 = IndexFlatL2
    mod.__is_cerebra_stub__ = True
    sys.modules["faiss"] = mod
    return mod
