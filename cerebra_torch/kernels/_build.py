"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled by nvcc into
`build/cerebra_torch/lib<name>-<hash>.so` at the root of the checkout, where
`<hash>` covers the sources and the flags, so a changed source rebuilds and
an unchanged one loads the library already built. No PyTorch header is
included, so a build takes seconds (torch.utils.cpp_extension would take
minutes). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cerebra_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def _sources(name: str):
    main = os.path.join(CSRC, f"{name}.cu")
    headers = sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")
    )
    return main, headers


def library_path(name: str) -> str:
    """Where the library built from the current sources lives."""
    main, headers = _sources(name)
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [main] + headers:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> Tuple[str, float]:
    """Compile `csrc/<name>.cu` unless a library of the same hash exists.
    Returns (library path, seconds spent compiling; 0.0 when cached)."""
    so = library_path(name)
    if os.path.exists(so):
        return so, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    main, _ = _sources(name)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, main],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {main}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees a half-written file
    return so, time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        so, _ = build(name)
        lib = ctypes.CDLL(so)
        _LOADED[name] = lib
    return lib
