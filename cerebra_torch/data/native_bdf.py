"""ctypes binding for the native C++ BDF reader (native/bdf_reader.cpp), the
multithreaded counterpart of `cerebra_torch.data.bdf.read_raw_bdf` (port of
cerebra/data/native_bdf.py). Same `BDFData` contract; built on demand with
g++ into build/cerebra_torch/ by `utils/native_build.py`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from cerebra_torch.data.bdf import BDFData
from cerebra_torch.utils.native_build import NATIVE_DIR, build_and_load

_SRC = os.path.join(NATIVE_DIR, "bdf_reader.cpp")

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = build_and_load(_SRC)
    lib.bdf_query.restype = ctypes.c_int
    lib.bdf_query.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.bdf_read.restype = ctypes.c_int
    lib.bdf_read.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_char_p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    """True when the reader is built or can be (a g++ toolchain is present)."""
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):  # no g++, or it failed
        return False


def read_raw_bdf(path: str) -> BDFData:
    """Native read; the contract of cerebra_torch.data.bdf.read_raw_bdf."""
    lib = _load()
    n_ch = ctypes.c_int()
    n_samp = ctypes.c_long()
    rate = ctypes.c_double()
    rc = lib.bdf_query(path.encode(), ctypes.byref(n_ch), ctypes.byref(n_samp),
                       ctypes.byref(rate))
    if rc != 0:
        raise ValueError(f"bdf_query failed (rc={rc}) for {path!r}")
    C, T = n_ch.value, n_samp.value
    signals = np.empty((C, T), dtype=np.float32)
    status = np.zeros((T,), dtype=np.int32)
    labels_buf = ctypes.create_string_buffer(17 * C)
    rc = lib.bdf_read(path.encode(), signals, status, labels_buf)
    if rc != 0:
        raise ValueError(f"bdf_read failed (rc={rc}) for {path!r}")
    labels = [
        labels_buf.raw[17 * i:17 * i + 16].split(b"\0", 1)[0].decode("ascii", errors="replace")
        .strip()
        for i in range(C)
    ]
    return BDFData(signals=signals, channel_names=labels, sample_rate=rate.value, status=status)
