"""One LSTM layer's recurrence over a precomputed input projection: the CUDA
kernels K12, K13, K14 and their plain PyTorch versions (port of
cerebra/models/pallas_lstm.py, `lstm_scan_pallas`).

- K12 `scan_fwd_infer`: h_all (T, B, H) from x_proj (T, B, 4H) =
  x·W_ih + b for every t and w_hh (H, 4H): gates = f32(x_proj_t) +
  (h rounded to the stream dtype)·W_hh with f32 accumulation, f32 cell.
- K13 `scan_fwd_train`: K12 plus the backward's residuals prefac
  (T, B, 4H) = [g·i(1−i), c_prev·f(1−f), i(1−g²), tanh c·o(1−o)] and qf
  (T, B, 2H) = [o(1−tanh²c), f].
- K14 `scan_bwd`: the reverse-time, transcendental-free backward on those
  residuals, emitting dgates = dx_proj (T, B, 4H); no dW. It is the reverse
  scan that K2/K2g run once per layer (`lstm_stack.bwd_scan`; one CUDA
  template, one plain version `_scan_bwd_ref`). dW_hh = Σ_t h_{t−1}ᵀ·dgates_t
  is one matmul outside the kernel, as `pallas_lstm.py`'s `_vjp_bwd` does it
  outside its Pallas kernel.

x_proj and w_hh share one stream dtype (float32 or bfloat16); gate order
[i, f, g, o]. `batch_tile`, the TPU's VMEM choice, becomes `tile`, the batch
rows of one CUDA block, and the Pallas wrappers' 8-row alignment is not
ported: the kernels mask a ragged tile themselves.

Dispatch: a tensor on the CPU takes the plain version (`_scan_fwd_infer_ref`,
`_scan_fwd_train_ref`, `_scan_bwd_ref`); a CUDA tensor launches the kernel,
built at first use, or raises. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from cerebra_torch.kernels import LAUNCHES, check_rc, load_lib, on_cuda, ptr, stream_of
from cerebra_torch.models.lstm_stack import (  # noqa: F401  (_scan_bwd_ref is K14's plain version)
    _MAX_SMEM,
    _STREAM_DTYPES,
    _TILES,
    _cuda_checks,
    _residuals,
    _scan_bwd_ref,
    scan_tile,
)

LAUNCHES.update(scan_fwd_infer=0, scan_fwd_train=0, scan_bwd=0)


def _dims(x_proj: torch.Tensor, w_hh: torch.Tensor) -> Tuple[int, int, int]:
    """(T, B, H) after checking that x_proj and w_hh form one layer in one
    stream dtype on one device."""
    if x_proj.dim() != 3 or x_proj.shape[-1] % 4:
        raise ValueError(f"x_proj must be (T, B, 4H), got shape {tuple(x_proj.shape)}")
    T, B, G = x_proj.shape
    H = G // 4
    if T < 1 or B < 1 or H < 1:
        raise ValueError(f"empty input of shape {tuple(x_proj.shape)}")
    if tuple(w_hh.shape) != (H, G):
        raise ValueError(f"w_hh must be ({H}, {G}), got {tuple(w_hh.shape)}")
    if x_proj.dtype not in _STREAM_DTYPES:
        raise TypeError(f"stream dtype must be float32 or bfloat16, got {x_proj.dtype}")
    if w_hh.dtype != x_proj.dtype or w_hh.device != x_proj.device:
        raise TypeError(f"w_hh must be {x_proj.dtype} on {x_proj.device}, "
                        f"got {w_hh.dtype} on {w_hh.device}")
    return T, B, H


# ---------------------------------------------------------- plain versions
def _scan_fwd(x_proj: torch.Tensor, w_hh: torch.Tensor, train: bool):
    T, B, H = _dims(x_proj, w_hh)
    sd = x_proj.dtype
    dev = x_proj.device
    h = torch.zeros(B, H, device=dev)
    c = torch.zeros(B, H, device=dev)
    w = w_hh.float()
    h_all = torch.empty(T, B, H, dtype=sd, device=dev)
    prefac = torch.empty(T, B, 4 * H, dtype=sd, device=dev) if train else None
    qf = torch.empty(T, B, 2 * H, dtype=sd, device=dev) if train else None
    for t in range(T):
        gates = x_proj[t].float() + h.to(sd).float() @ w
        i, f, o = (torch.sigmoid(gates[:, k * H:(k + 1) * H]) for k in (0, 1, 3))
        g = torch.tanh(gates[:, 2 * H:3 * H])
        c_prev = c
        c = f * c_prev + i * g
        tanh_c = torch.tanh(c)
        h = o * tanh_c
        h_all[t] = h.to(sd)
        if train:
            prefac[t], qf[t] = _residuals(i, f, g, o, c_prev, tanh_c, sd)
    return (h_all, prefac, qf) if train else h_all


def _scan_fwd_infer_ref(x_proj: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Plain K12 → h_all (T, B, H)."""
    return _scan_fwd(x_proj, w_hh, train=False)


def _scan_fwd_train_ref(x_proj: torch.Tensor, w_hh: torch.Tensor):
    """Plain K13 → (h_all, prefac, qf)."""
    return _scan_fwd(x_proj, w_hh, train=True)


def _dw_hh(h_all: torch.Tensor, dgates: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """dW_hh = Σ_{t≥1} h_{t−1}ᵀ·dgates_t (the t = 0 term vanishes: h_prev = 0)
    as one matmul with f32 operands, in w_hh's dtype; outside any kernel, as
    in the JAX package. Exact products of the bf16 streams, summed in f32:
    TF32 is turned off for the matmul whatever the caller set, and restored."""
    H = h_all.shape[-1]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dw = h_all[:-1].reshape(-1, H).float().t() @ dgates[1:].reshape(-1, 4 * H).float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return dw.to(w_hh.dtype)


# ------------------------------------------------------------ CUDA kernels
def _typed(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.cerebra_scan_fwd.argtypes = [i, i, i] + [vp] * 5 + [i] * 3 + [vp]
    lib.cerebra_scan_fwd.restype = i
    lib.cerebra_scan_bwd.argtypes = [i, i] + [vp] * 5 + [i] * 3 + [vp]
    lib.cerebra_scan_bwd.restype = i


def _lib():
    return load_lib("lstm_scan", _typed)


def pick_tile(B: int, H: int) -> int:
    """Batch rows per CUDA block of the forwards K12 and K13: 8, as the
    stack's forward takes (its block time hardly grows from 1 to 8 rows, and
    8 rows keep B = 1024 to one wave), or fewer where 8 rows' carries
    overflow shared memory. K14 takes the reverse scan's `scan_tile`.
    Raises if one row's carries overflow."""
    for bt in _TILES:
        if bt <= 8 and 4 * bt * 6 * H <= _MAX_SMEM:  # (2 carries + 4H gates) × bt floats
            return bt
    raise ValueError(f"H={H}: the carries exceed one block's shared memory")


def _fwd_cuda(x_proj, w_hh, train: bool, tile=None):
    T, B, H = _dims(x_proj, w_hh)
    tile = tile or pick_tile(B, H)
    _cuda_checks(tile, x_proj, w_hh)
    sd, dev = x_proj.dtype, x_proj.device
    h_all = torch.empty(T, B, H, dtype=sd, device=dev)
    prefac = torch.empty(T, B, 4 * H, dtype=sd, device=dev) if train else None
    qf = torch.empty(T, B, 2 * H, dtype=sd, device=dev) if train else None
    lib = _lib()
    rc = lib.cerebra_scan_fwd(
        int(train), int(sd == torch.bfloat16), tile, x_proj.data_ptr(), w_hh.data_ptr(),
        h_all.data_ptr(), ptr(prefac), ptr(qf), T, B, H, stream_of(x_proj),
    )
    kind = "scan_fwd_train" if train else "scan_fwd_infer"
    check_rc(lib, rc, kind)
    LAUNCHES[kind] += 1
    return (h_all, prefac, qf) if train else h_all


def _bwd_cuda(g, prefac, qf, w_hh, tile=None):
    T, B, G = prefac.shape
    H = G // 4
    sd = prefac.dtype
    tile = tile or scan_tile(B, H, sd)
    if (tuple(g.shape) != (T, B, H) or tuple(qf.shape) != (T, B, 2 * H)
            or tuple(w_hh.shape) != (H, G)
            or any(t.dtype != sd for t in (g, qf, w_hh))):
        raise ValueError("cotangent, residuals or w_hh do not match one layer")
    w_hhT = w_hh.t().contiguous()
    _cuda_checks(tile, g, prefac, qf)
    dgates = torch.empty(T, B, G, dtype=sd, device=prefac.device)
    lib = _lib()
    rc = lib.cerebra_scan_bwd(
        int(sd == torch.bfloat16), tile, prefac.data_ptr(), qf.data_ptr(), g.data_ptr(),
        w_hhT.data_ptr(), dgates.data_ptr(), T, B, H, stream_of(prefac),
    )
    check_rc(lib, rc, "scan_bwd")
    LAUNCHES["scan_bwd"] += 1
    return dgates


# ---------------------------------------------------------------- wrappers
def scan_fwd_infer(x_proj: torch.Tensor, w_hh: torch.Tensor, tile=None) -> torch.Tensor:
    """K12 on CUDA, its plain version on the CPU → h_all (T, B, H)."""
    if on_cuda(x_proj, w_hh):
        return _fwd_cuda(x_proj, w_hh, False, tile)
    return _scan_fwd_infer_ref(x_proj, w_hh)


def scan_fwd_train(x_proj: torch.Tensor, w_hh: torch.Tensor, tile=None):
    """K13 on CUDA, its plain version on the CPU → (h_all, prefac, qf)."""
    if on_cuda(x_proj, w_hh):
        return _fwd_cuda(x_proj, w_hh, True, tile)
    return _scan_fwd_train_ref(x_proj, w_hh)


def scan_bwd(g, prefac, qf, w_hh, tile=None) -> torch.Tensor:
    """K14 on CUDA, its plain version on the CPU → dgates (T, B, 4H)."""
    if on_cuda(g, prefac, qf, w_hh):
        return _bwd_cuda(g, prefac, qf, w_hh, tile)
    return _scan_bwd_ref(g, prefac, qf, w_hh)


class _Scan(torch.autograd.Function):
    """h_all (T, B, H) with gradients for x_proj (the dgates stream) and w_hh.
    `impl` is (forward-train, backward) — the dispatching wrappers, or the
    plain versions for timing them on the card."""

    @staticmethod
    def forward(ctx, impl, x_proj, w_hh):
        h_all, prefac, qf = impl[0](x_proj, w_hh)
        ctx.impl = impl
        ctx.save_for_backward(w_hh, h_all, prefac, qf)
        return h_all.clone()  # a copy: the saved h_all feeds dW_hh

    @staticmethod
    def backward(ctx, g):
        w_hh, h_all, prefac, qf = ctx.saved_tensors
        dgates = ctx.impl[1](g.to(prefac.dtype).contiguous(), prefac, qf, w_hh)
        dw = _dw_hh(h_all, dgates, w_hh) if ctx.needs_input_grad[2] else None
        return None, dgates if ctx.needs_input_grad[1] else None, dw


def _scan(impl, infer, x_proj: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and (x_proj.requires_grad or w_hh.requires_grad):
        return _Scan.apply(impl, x_proj, w_hh)
    return infer(x_proj, w_hh)


def lstm_scan(x_proj: torch.Tensor, w_hh: torch.Tensor, tile=None) -> torch.Tensor:
    """One LSTM layer over precomputed input projections (the contract of the
    Pallas `lstm_scan_pallas`): x_proj (T, B, 4H) = x·W_ih + b for every t
    and w_hh (H, 4H) in one stream dtype → h_all (T, B, H) in that dtype.

    K13 forward and K14 backward (dx_proj = the dgates stream, dW_hh one
    matmul over it) when grad is enabled and x_proj or w_hh requires grad,
    K12 otherwise. `tile` is the batch rows of one CUDA block (default
    `pick_tile` for the forwards, `scan_tile` for K14)."""
    impl = (functools.partial(scan_fwd_train, tile=tile), functools.partial(scan_bwd, tile=tile))
    return _scan(impl, functools.partial(scan_fwd_infer, tile=tile), x_proj, w_hh)


def lstm_scan_ref(x_proj: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """`lstm_scan` through the plain versions on any device (for timing the
    kernels against them on the card)."""
    return _scan((_scan_fwd_train_ref, _scan_bwd_ref), _scan_fwd_infer_ref, x_proj, w_hh)
