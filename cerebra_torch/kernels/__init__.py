"""The hand-written CUDA kernels: their build (`_build.py`), the dispatch and
ctypes helpers every wrapper module shares, and one count of launches per
kernel.

Each wrapper module adds its kernels' names to `LAUNCHES` when it is
imported and adds one to a name where it launches that kernel, and nowhere
else, so a run can show that its main path went through the kernels.
`LAUNCH_SHAPES` counts the same launches by (kernel, shape) where a
wrapper passes a launch's shape to `count_shape`, so a run can show which
shapes its launches took."""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch

LAUNCHES: Dict[str, int] = {}
LAUNCH_SHAPES: Dict[Tuple, int] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SHAPES.clear()


def count_shape(name: str, *shape: int) -> None:
    """One launch of `name` at `shape`, beside the `LAUNCHES[name]` bump."""
    key = (name, *shape)
    LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + 1


def on_cuda(*tensors: Optional[torch.Tensor]) -> bool:
    """True for CUDA tensors, False for CPU ones (None entries are skipped);
    raises on a mix of devices or any other device: a CPU tensor takes a
    kernel's plain version, a CUDA tensor the kernel."""
    present = [t for t in tensors if t is not None]
    dev = present[0].device
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"no kernel implementation for device {dev}")
    for t in present:
        if t.device != dev:
            raise RuntimeError(f"tensors on {dev} and {t.device}")
    return dev.type == "cuda"


def load_lib(name: str, typed: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, with `typed` setting its
    entry points' ctypes signatures once."""
    from cerebra_torch.kernels import _build

    lib = _build.load(name)
    if not getattr(lib, "_cerebra_typed", False):
        typed(lib)
        lib.cerebra_cuda_error_string.argtypes = [ctypes.c_int]
        lib.cerebra_cuda_error_string.restype = ctypes.c_char_p
        lib._cerebra_typed = True
    return lib


def check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on the CUDA error code a C entry point returned."""
    if rc != 0:
        msg = lib.cerebra_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_of(x: torch.Tensor) -> int:
    """PyTorch's current stream on x's device, where the kernels launch."""
    return torch.cuda.current_stream(x.device).cuda_stream
