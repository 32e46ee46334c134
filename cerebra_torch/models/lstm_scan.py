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
[i, f, g, o]. K12 and K13 run on one of two kernels, chosen by `scan_path`
before the launch: in bf16 where `scan_wave_fits`, the scan's wavefront
forward (`scan_wave_kernel`: 16-row tiles, W_hh in shared memory, the step's
product on mma.sync, x_proj through a cp.async ring; NS = 2 splits a tile's
units over two CTAs), its plain composition `_scan_wave_ref`; else
`scan_fwd_kernel` with `tile` batch rows a block (the TPU's `batch_tile`,
VMEM's choice; the Pallas wrappers' 8-row alignment is not ported: the
kernels mask a ragged tile themselves).

Dispatch: a tensor on the CPU takes the plain version (`_scan_fwd_infer_ref`,
`_scan_fwd_train_ref`, `_scan_bwd_ref`); a CUDA tensor launches the kernel,
built at first use, or raises. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from cerebra_torch.kernels import LAUNCHES, check_rc, load_lib, on_cuda, ptr, stream_of
from cerebra_torch.models.lstm_stack import (  # noqa: F401  (_scan_bwd_ref is K14's plain version)
    _MAX_SMEM,
    _STREAM_DTYPES,
    _TILES,
    _WAVE_RING,
    _WAVE_ROWS,
    _cuda_checks,
    _residuals,
    _scan_bwd_ref,
    scan_tile,
)

# scan_fwd_infer / scan_fwd_train: each K12 / K13 call on either kernel;
# scan_fwd_wave / scan_fwd_wave_split: each launch of the scan's wavefront
# forward with one / two CTAs a tile
LAUNCHES.update(scan_fwd_infer=0, scan_fwd_train=0, scan_bwd=0, scan_fwd_wave=0,
                scan_fwd_wave_split=0)


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
def _cell(gates, c, sd, res: bool):
    """The f32 cell of one step from its pre-activations gates (..., 4U) f32
    (gate order [i, f, g, o], U units) and c_{t−1} (..., U) f32 → (h_t f32,
    c_t f32, and with `res` the step's prefac and qf in the stream dtype sd,
    else None, None)."""
    U = gates.shape[-1] // 4
    i, f, o = (torch.sigmoid(gates[..., k * U:(k + 1) * U]) for k in (0, 1, 3))
    g = torch.tanh(gates[..., 2 * U:3 * U])
    c_new = f * c + i * g
    tanh_c = torch.tanh(c_new)
    prefac, qf = _residuals(i, f, g, o, c, tanh_c, sd) if res else (None, None)
    return o * tanh_c, c_new, prefac, qf


def _outputs(T: int, B: int, H: int, sd, dev, train: bool):
    """Empty h_all (T, B, H) and, for K13, prefac (T, B, 4H) and qf (T, B, 2H)."""
    h_all = torch.empty(T, B, H, dtype=sd, device=dev)
    if not train:
        return h_all, None, None
    return (h_all, torch.empty(T, B, 4 * H, dtype=sd, device=dev),
            torch.empty(T, B, 2 * H, dtype=sd, device=dev))


def _scan_fwd(x_proj: torch.Tensor, w_hh: torch.Tensor, train: bool):
    T, B, H = _dims(x_proj, w_hh)
    sd = x_proj.dtype
    dev = x_proj.device
    h = torch.zeros(B, H, device=dev)
    c = torch.zeros(B, H, device=dev)
    w = w_hh.float()
    h_all, prefac, qf = _outputs(T, B, H, sd, dev, train)
    for t in range(T):
        h, c, pf, q = _cell(x_proj[t].float() + h.to(sd).float() @ w, c, sd, train)
        h_all[t] = h.to(sd)
        if train:
            prefac[t], qf[t] = pf, q
    return (h_all, prefac, qf) if train else h_all


def _scan_fwd_infer_ref(x_proj: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """Plain K12 → h_all (T, B, H)."""
    return _scan_fwd(x_proj, w_hh, train=False)


def _scan_fwd_train_ref(x_proj: torch.Tensor, w_hh: torch.Tensor):
    """Plain K13 → (h_all, prefac, qf)."""
    return _scan_fwd(x_proj, w_hh, train=True)


def _scan_wave_ref(x_proj: torch.Tensor, w_hh: torch.Tensor, train: bool, ns: int = 1):
    """K12 (`train` False: h_all) or K13 (h_all, prefac, qf) as the scan's
    wavefront forward composes them, with `ns` CTAs a tile: the batch in
    tiles of 16 rows, zero rows past B (the tiles side by side: their rows
    never meet); in each tile CTA s of ns owns the units [s U, (s+1) U),
    U = H/ns, and at every step computes their four gates f32(x_proj_t) +
    h_{t−1}·W_hh from its own columns (q H + s U + u of gate q) on the whole
    h_{t−1} (rounded to the stream dtype, as the CTAs hand each other their
    halves of h_t), then the cell on its units' c."""
    T, B, H = _dims(x_proj, w_hh)
    if ns < 1 or H % ns:
        raise ValueError(f"H={H} does not split over {ns} CTAs")
    sd, dev, U, R = x_proj.dtype, x_proj.device, H // ns, _WAVE_ROWS
    nt = -(-B // R)
    units = [torch.arange(s * U, (s + 1) * U, device=dev) for s in range(ns)]
    cols = [torch.cat([q * H + u for q in range(4)]) for u in units]  # a CTA's gate columns
    qcols = [torch.cat([u, H + u]) for u in units]  # its columns of qf: q, then f
    w = [w_hh.float()[:, k] for k in cols]
    xp = x_proj.new_zeros(T, nt * R, 4 * H)
    xp[:, :B] = x_proj
    xp = [xp.view(T, nt, R, 4 * H)[..., k] for k in cols]
    h = torch.zeros(nt, R, H, dtype=sd, device=dev)
    c = [torch.zeros(nt, R, U, device=dev) for _ in range(ns)]
    h_all, prefac, qf = _outputs(T, B, H, sd, dev, train)
    for t in range(T):
        h_new = torch.empty_like(h)
        for s in range(ns):
            hs, c[s], pf, q = _cell(xp[s][t].float() + h.float() @ w[s], c[s], sd, train)
            h_new[..., units[s]] = hs.to(sd)
            if train:
                prefac[t][:, cols[s]] = pf.reshape(-1, 4 * U)[:B]
                qf[t][:, qcols[s]] = q.reshape(-1, 2 * U)[:B]
        h = h_new
        h_all[t] = h.reshape(-1, H)[:B]
    return (h_all, prefac, qf) if train else h_all


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
    lib.cerebra_scan_fwd_wave.argtypes = [i, i] + [vp] * 5 + [i] * 3 + [vp]
    lib.cerebra_scan_fwd_wave.restype = i
    lib.cerebra_scan_wave_clusters.argtypes = [i, i]
    lib.cerebra_scan_wave_clusters.restype = i
    lib.cerebra_scan_wave_smem.argtypes = [i, i]
    lib.cerebra_scan_wave_smem.restype = ctypes.c_longlong


def _lib():
    return load_lib("lstm_scan", _typed)


def pick_tile(B: int, H: int) -> int:
    """Batch rows per CUDA block of `scan_fwd_kernel`, K12 and K13 where
    `scan_path` takes that kernel: 8, as the
    stack's forward takes (its block time hardly grows from 1 to 8 rows, and
    8 rows keep B = 1024 to one wave), or fewer where 8 rows' carries
    overflow shared memory. K14 takes the reverse scan's `scan_tile`.
    Raises if one row's carries overflow."""
    for bt in _TILES:
        if bt <= 8 and 4 * bt * 6 * H <= _MAX_SMEM:  # (2 carries + 4H gates) × bt floats
            return bt
    raise ValueError(f"H={H}: the carries exceed one block's shared memory")


_WAVE_THREADS = 384  # threads of one CTA of the wavefront kernels, at most (kWaveThreads)


def scan_wave_smem(H: int, ns: int) -> int:
    """Bytes of shared memory of one CTA of the scan's wavefront forward
    with `ns` CTAs a tile (csrc/lstm_scan.cu scan_wave_smem): in bf16 the
    4U = 4H/ns columns of w_hh its units own, each padded to H + 8 values;
    the x_proj ring (4 slots of 16 rows x (4U + 8)); h (2, 16, H + 8); and,
    split, two 8-byte mbarriers. At H = 96: 136,704 bytes (133.5 KiB) with
    one CTA, 72,208 (70.5 KiB) with two."""
    U = H // ns
    return (2 * (4 * U * (H + 8) + _WAVE_RING * _WAVE_ROWS * (4 * U + 8) + 2 * _WAVE_ROWS * (H + 8))
            + (16 if ns > 1 else 0))


def scan_wave_fits(H: int, dtype: torch.dtype, ns: int) -> bool:
    """Whether the scan's wavefront forward runs width H with `ns` CTAs (1 or
    2) a tile: bf16 streams (its product is bf16 mma.sync; f32 keeps
    `scan_fwd_kernel`), H a multiple of 16 ns (each CTA's units in k-steps
    of 16), 4H/ns threads within 384 (8 units a warp) and a CTA's shared
    memory within a block's (`scan_wave_smem`). H = 96 with 1 or 2; H = 128
    with 2 only; not H = 384."""
    return (dtype == torch.bfloat16 and ns in (1, 2) and H % (16 * ns) == 0
            and 4 * H // ns <= _WAVE_THREADS and scan_wave_smem(H, ns) <= _MAX_SMEM)


def scan_path(B: int, H: int, dtype: torch.dtype, clusters: Sequence[int]) -> int:
    """Which kernel runs K12 and K13 at batch B, width H: 0 for
    `scan_fwd_kernel`, else the CTAs a tile (1 or 2) of the scan's wavefront
    forward. `clusters` gives the clusters the card holds at once with 1 and
    with 2 CTAs a tile (`scan_wave_clusters`; 0 where the width does not
    fit). The wavefront forward wherever `scan_wave_fits`, with the fewest
    waves of 16-row tiles, then two CTAs a tile. A tile's step is latency:
    the split halves each CTA's product and its warps (which share an SM's
    issue slots through the cell's transcendentals) for one exchange of h a
    step. On an H100 at H = 96, T = 460 (132 clusters of either size at
    once) two CTAs a tile ran K12 in 0.844 / 0.866 ms against one CTA's
    0.997 / 1.035 and K13 in 1.039 / 1.031 against 1.369 / 1.456 at B = 16 /
    1024; at B = 2048 (128 tiles: two CTAs of the split share an SM) K12 in
    0.946 against 1.017 and K13 in 1.420 against 1.413; `scan_fwd_kernel`
    took 2.27-3.92 (K12) and 2.86-4.35 (K13) (chip_smoke.py `[scan paths]`,
    PERF.md §6)."""
    best = (0, 0)
    for ns in (1, 2):
        q = clusters[ns - 1]
        if q > 0 and scan_wave_fits(H, dtype, ns):
            waves = -(-(-(-B // _WAVE_ROWS)) // q)
            if not best[1] or waves <= best[0]:
                best = (waves, ns)
    return best[1]


@functools.lru_cache(maxsize=None)
def scan_wave_clusters(H: int, ns: int) -> int:
    """Clusters of the scan's wavefront forward with `ns` CTAs a tile the
    card holds at once at width H (cudaOccupancyMaxActiveClusters, asked
    once a process)."""
    lib = _lib()
    n = lib.cerebra_scan_wave_clusters(ns, H)
    if n < 0:
        check_rc(lib, -n, "scan_fwd_wave occupancy")
    return n


def scan_ns(B: int, H: int, dtype: torch.dtype) -> int:
    """`scan_path` at batch B on this card."""
    return scan_path(B, H, dtype, [scan_wave_clusters(H, ns) if scan_wave_fits(H, dtype, ns)
                                   else 0 for ns in (1, 2)])


def _fwd_wave_cuda(x_proj, w_hh, train: bool, ns: int):
    """K12 or K13 on the scan's wavefront forward with `ns` CTAs a tile."""
    T, B, H = _dims(x_proj, w_hh)
    if not scan_wave_fits(H, x_proj.dtype, ns):
        raise ValueError(f"the scan's wavefront forward does not run H={H}, {x_proj.dtype} "
                         f"with {ns} CTAs a tile")
    _cuda_checks(1, x_proj, w_hh)
    if x_proj.data_ptr() % 16:  # the ring copies x_proj 16 bytes at a time
        x_proj = x_proj.clone()
    h_all, prefac, qf = _outputs(T, B, H, x_proj.dtype, x_proj.device, train)
    lib = _lib()
    rc = lib.cerebra_scan_fwd_wave(
        int(train), ns, x_proj.data_ptr(), w_hh.data_ptr(), h_all.data_ptr(), ptr(prefac),
        ptr(qf), T, B, H, stream_of(x_proj))
    name = "scan_fwd_wave_split" if ns == 2 else "scan_fwd_wave"
    check_rc(lib, rc, name)
    LAUNCHES[name] += 1
    return h_all, prefac, qf


def _fwd_cuda(x_proj, w_hh, train: bool, tile=None, ns=None):
    """K12 or K13 on the card: on the scan's wavefront forward with `ns`
    CTAs a tile, or on `scan_fwd_kernel` with `tile` rows a block where `ns`
    is 0; `ns` defaults to `scan_ns`'s choice."""
    T, B, H = _dims(x_proj, w_hh)
    if ns is None:
        ns = scan_ns(B, H, x_proj.dtype)
    kind = "scan_fwd_train" if train else "scan_fwd_infer"
    if ns:
        h_all, prefac, qf = _fwd_wave_cuda(x_proj, w_hh, train, ns)
    else:
        tile = tile or pick_tile(B, H)
        _cuda_checks(tile, x_proj, w_hh)
        h_all, prefac, qf = _outputs(T, B, H, x_proj.dtype, x_proj.device, train)
        lib = _lib()
        rc = lib.cerebra_scan_fwd(
            int(train), int(x_proj.dtype == torch.bfloat16), tile, x_proj.data_ptr(),
            w_hh.data_ptr(), h_all.data_ptr(), ptr(prefac), ptr(qf), T, B, H,
            stream_of(x_proj))
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
    """K12 on CUDA (on the kernel `scan_path` picks; `tile` rows a block of
    `scan_fwd_kernel` where it picks that one), its plain version on the
    CPU → h_all (T, B, H)."""
    if on_cuda(x_proj, w_hh):
        return _fwd_cuda(x_proj, w_hh, False, tile)
    return _scan_fwd_infer_ref(x_proj, w_hh)


def scan_fwd_train(x_proj: torch.Tensor, w_hh: torch.Tensor, tile=None):
    """K13 on CUDA (as `scan_fwd_infer`), its plain version on the CPU →
    (h_all, prefac, qf)."""
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
    K12 otherwise. K12 and K13 run on the scan's wavefront forward in bf16
    where `scan_wave_fits`, else on `scan_fwd_kernel` (`scan_path`). `tile`
    is the batch rows of one CUDA block of `scan_fwd_kernel` (default
    `pick_tile`) and of K14 (default `scan_tile`)."""
    impl = (functools.partial(scan_fwd_train, tile=tile), functools.partial(scan_bwd, tile=tile))
    return _scan(impl, functools.partial(scan_fwd_infer, tile=tile), x_proj, w_hh)


def lstm_scan_ref(x_proj: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """`lstm_scan` through the plain versions on any device (for timing the
    kernels against them on the card)."""
    return _scan((_scan_fwd_train_ref, _scan_bwd_ref), _scan_fwd_infer_ref, x_proj, w_hh)
