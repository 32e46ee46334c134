"""On-demand g++ build and cache of the repo's host C++ sources under
`native/` (the port's counterpart of cerebra/utils/native_build.py).

`build_and_load(src)` compiles `src` into
`build/cerebra_torch/lib<name>-<hash>.so` at the root of the checkout, where
`<hash>` covers the source and the flags (as `kernels/_build.py` names the
CUDA libraries), then dlopens it. A library older than its source is built
again. The compile writes a per-process temporary name and moves it into
place with an atomic os.replace, so ranks that build at once never load a
half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_ROOT, "native")
BUILD_DIR = os.path.join(_ROOT, "build", "cerebra_torch")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")


def library_path(src: str) -> str:
    """Where the library built from the current `src` lives."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(src, "rb") as f:
        digest.update(f.read())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_and_load(src: str) -> ctypes.CDLL:
    """Compile `src` → `library_path(src)` if missing or older than `src`,
    and dlopen it."""
    lib_path = library_path(src)
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    if not os.path.exists(lib_path) or os.path.getmtime(lib_path) < os.path.getmtime(src):
        tmp = f"{lib_path}.tmp.{os.getpid()}"
        try:
            subprocess.run(["g++", *GXX_FLAGS, src, "-o", tmp], check=True, capture_output=True)
            os.replace(tmp, lib_path)  # atomic: no reader ever sees a partial .so
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(lib_path)
