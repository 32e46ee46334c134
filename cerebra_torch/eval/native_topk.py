"""ctypes binding for the native C++ brute-force L2 top-k (native/topk_l2.cpp;
port of cerebra/eval/native_topk.py) — a host oracle for the on-device
retrieval (SURVEY.md §2.8.1: the reference's only native dependency was
faiss IndexFlatL2).

The shared library is built on demand with g++ into build/cerebra_torch/ by
`utils/native_build.py`. `available()` reports whether it builds.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

from cerebra_torch.utils.native_build import NATIVE_DIR, build_and_load

_SRC = os.path.join(NATIVE_DIR, "topk_l2.cpp")

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = build_and_load(_SRC)
    lib.topk_l2.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
    ]
    lib.topk_l2.restype = None
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):  # no g++, or it failed
        return False


def topk_l2_native(
    gallery: np.ndarray, query: np.ndarray, k: int, n_threads: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact squared-L2 k-NN on the host (faiss IndexFlatL2 semantics)."""
    lib = _load()

    def as2d(a):
        a = np.asarray(a, dtype=np.float32)
        # reshape(n, -1) cannot infer -1 when n == 0; flatten explicitly
        feat = int(np.prod(a.shape[1:])) if a.ndim > 1 else 1
        return np.ascontiguousarray(a.reshape(a.shape[0], feat))

    gallery = as2d(gallery)
    query = as2d(query)
    ng, dim = gallery.shape
    nq = query.shape[0]
    if query.shape[1] != dim:
        raise ValueError(
            f"query dim {query.shape[1]} != gallery dim {dim} — the C kernel "
            "would read out of bounds"
        )
    if ng == 0 or nq == 0:  # empty split: defined empty/sentinel result
        return (
            np.full((nq, k), np.float32(np.finfo(np.float32).max), np.float32),
            np.full((nq, k), -1, np.int64),
        )
    k = min(k, ng)
    out_dist = np.empty((nq, k), dtype=np.float32)
    out_idx = np.empty((nq, k), dtype=np.int64)
    lib.topk_l2(
        gallery.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        query.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ng, nq, dim, k,
        out_dist.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_threads,
    )
    return out_dist, out_idx
