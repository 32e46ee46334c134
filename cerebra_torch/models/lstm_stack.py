"""Fused multi-layer LSTM stack: the CUDA kernels K1, K2, K3 and their plain
PyTorch versions (port of cerebra/models/pallas_lstm_stack.py).

- K1 `fwd_train`: whole-stack forward that streams, per layer, h_all
  (T, B, H), prefac (T, B, 4H) = [g·i(1−i), c_prev·f(1−f), i(1−g²),
  tanh c·o(1−o)] and qf (T, B, 2H) = [o(1−tanh²c), f] for the backward.
- K2 `bwd`: reverse-time backward on those residuals with no
  transcendentals, for a (B, H) cotangent at t = T−1 and no input gradient;
  each CUDA block sums its own f32 partial of dW_ih, dW_hh and db, and a
  second kernel adds the partials in block order (deterministic).
- K3 `fwd_infer_last`: forward with no residuals, returning the top layer's
  h[T−1] (B, H).

Layout is time-major: x (T, B, C); layers are (w_ih (in, 4H), w_hh (H, 4H),
b (4H,)) in the stream dtype (float32 or bfloat16), in = C for layer 0 and H
after; gate order [i, f, g, o]. Residuals are stacked over layers:
h_all (L, T, B, H), prefac (L, T, B, 4H), qf (L, T, B, 2H).

Dispatch: a tensor on the CPU takes the plain version (`_fwd_train_ref`,
`_bwd_ref`, `_fwd_infer_last_ref`); a CUDA tensor launches the kernel, built
at first use, or raises. `LAUNCHES` counts kernel launches so a run can show
that it went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]

LAUNCHES = {"fwd_train": 0, "bwd": 0, "fwd_infer_last": 0, "bwd_reduce": 0}

_STREAM_DTYPES = (torch.float32, torch.bfloat16)
_TILES = (16, 8, 4, 2, 1)
_MAX_SMEM = 232448  # bytes of shared memory one H100 block may use


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------------ checks
def _dims(x: torch.Tensor, layers: Layers) -> Tuple[int, int, int, int, int]:
    """(T, B, C, H, L) after checking that x and the layers form a uniform
    stack in one stream dtype on one device."""
    if x.dim() != 3:
        raise ValueError(f"x must be (T, B, C), got shape {tuple(x.shape)}")
    if x.dtype not in _STREAM_DTYPES:
        raise TypeError(f"stream dtype must be float32 or bfloat16, got {x.dtype}")
    T, B, C = x.shape
    if T < 1 or B < 1 or C < 1:
        raise ValueError(f"empty input of shape {tuple(x.shape)}")
    L = len(layers)
    if L < 1:
        raise ValueError("need at least one layer")
    H = layers[0][1].shape[0]
    for l, (w_ih, w_hh, b) in enumerate(layers):
        in_dim = C if l == 0 else H
        if (tuple(w_ih.shape) != (in_dim, 4 * H) or tuple(w_hh.shape) != (H, 4 * H)
                or tuple(b.shape) != (4 * H,)):
            raise ValueError(
                f"layer {l}: w_ih {tuple(w_ih.shape)}, w_hh {tuple(w_hh.shape)}, "
                f"b {tuple(b.shape)} do not form a uniform stack (in={in_dim}, H={H})"
            )
        for w in (w_ih, w_hh, b):
            if w.dtype != x.dtype or w.device != x.device:
                raise TypeError(
                    f"layer {l}: weights must be {x.dtype} on {x.device}, "
                    f"got {w.dtype} on {w.device}"
                )
    return T, B, C, H, L


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on anything else."""
    dev = tensors[0].device
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"no LSTM stack implementation for device {dev}")
    for t in tensors:
        if t.device != dev:
            raise RuntimeError(f"tensors on {dev} and {t.device}")
    return dev.type == "cuda"


# ---------------------------------------------------------- plain versions
def _gates(inp, h, w_ih, w_hh, b, sd):
    """x·W_ih + h·W_hh + b with stream-dtype operands and f32 accumulation
    (products of two bf16 values are exact in f32)."""
    return (inp.float() @ w_ih.float() + h.to(sd).float() @ w_hh.float()) + b.float()


def _fwd_train_ref(x: torch.Tensor, layers: Layers):
    """Plain K1: a loop over time with the kernel's rounding points."""
    T, B, C, H, L = _dims(x, layers)
    sd = x.dtype
    h = [torch.zeros(B, H, device=x.device) for _ in range(L)]
    c = [torch.zeros(B, H, device=x.device) for _ in range(L)]
    h_all = torch.empty(L, T, B, H, dtype=sd, device=x.device)
    prefac = torch.empty(L, T, B, 4 * H, dtype=sd, device=x.device)
    qf = torch.empty(L, T, B, 2 * H, dtype=sd, device=x.device)
    for t in range(T):
        inp = x[t]
        for l, (w_ih, w_hh, b) in enumerate(layers):
            gates = _gates(inp, h[l], w_ih, w_hh, b, sd)
            i = torch.sigmoid(gates[:, :H])
            f = torch.sigmoid(gates[:, H:2 * H])
            g = torch.tanh(gates[:, 2 * H:3 * H])
            o = torch.sigmoid(gates[:, 3 * H:])
            c_prev = c[l]
            ig = i * g
            c[l] = f * c_prev + ig
            tanh_c = torch.tanh(c[l])
            h[l] = o * tanh_c
            inp = h[l].to(sd)
            h_all[l, t] = inp
            prefac[l, t] = torch.cat(
                [g * (i - i * i), c_prev * (f - f * f), i - g * ig, tanh_c * (o - o * o)], -1
            ).to(sd)
            qf[l, t] = torch.cat([o - o * tanh_c * tanh_c, f], -1).to(sd)
    return h_all, prefac, qf


def _fwd_infer_last_ref(x: torch.Tensor, layers: Layers) -> torch.Tensor:
    """Plain K3: the forward without residuals; the top layer's h[T−1]."""
    T, B, C, H, L = _dims(x, layers)
    sd = x.dtype
    h = [torch.zeros(B, H, device=x.device) for _ in range(L)]
    c = [torch.zeros(B, H, device=x.device) for _ in range(L)]
    inp = None
    for t in range(T):
        inp = x[t]
        for l, (w_ih, w_hh, b) in enumerate(layers):
            gates = _gates(inp, h[l], w_ih, w_hh, b, sd)
            i, f, o = (torch.sigmoid(gates[:, k * H:(k + 1) * H]) for k in (0, 1, 3))
            g = torch.tanh(gates[:, 2 * H:3 * H])
            c[l] = f * c[l] + i * g
            h[l] = o * torch.tanh(c[l])
            inp = h[l].to(sd)
    return inp


def _bwd_ref(g, x, layers: Layers, h_all, prefac, qf) -> List[Tuple[torch.Tensor, ...]]:
    """Plain K2: consumes K1's residuals (not autograd through the loop).
    g (B, H) in the stream dtype hits the top layer at T−1 only; returns
    f32 (dW_ih, dW_hh, db) per layer."""
    T, B, C, H, L = _dims(x, layers)
    sd = x.dtype
    dev = x.device
    dh = [torch.zeros(B, H, device=dev) for _ in range(L)]
    dc = [torch.zeros(B, H, device=dev) for _ in range(L)]
    grads = [
        [torch.zeros(w_ih.shape, device=dev), torch.zeros(w_hh.shape, device=dev),
         torch.zeros(b.shape, device=dev)]
        for (w_ih, w_hh, b) in layers
    ]
    zero = torch.zeros(B, H, device=dev)
    for t in reversed(range(T)):
        g_up = g.float() if t == T - 1 else zero
        for l in reversed(range(L)):
            w_ih, w_hh, _ = layers[l]
            q = qf[l, t].float()
            d_h = dh[l] + g_up
            d_c = dc[l] + d_h * q[:, :H]
            dc_n, dh_n = d_c.to(sd).float(), d_h.to(sd).float()
            pf = prefac[l, t].float()
            dgates = torch.cat(
                [dc_n * pf[:, :H], dc_n * pf[:, H:2 * H], dc_n * pf[:, 2 * H:3 * H],
                 dh_n * pf[:, 3 * H:]], -1,
            ).to(sd).float()
            dh[l] = dgates @ w_hh.float().t()
            dc[l] = d_c * q[:, H:]
            h_prev = h_all[l, t - 1].float() if t > 0 else zero
            inp = (x[t] if l == 0 else h_all[l - 1, t]).float()
            grads[l][0] += inp.t() @ dgates
            grads[l][1] += h_prev.t() @ dgates
            grads[l][2] += dgates.sum(0)
            if l > 0:
                g_up = dgates @ w_ih.float().t()
    return [tuple(gr) for gr in grads]


# ------------------------------------------------------------ CUDA kernels
def _lib():
    from cerebra_torch.kernels import _build

    lib = _build.load("lstm_stack")
    if not getattr(lib, "_cerebra_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.cerebra_lstm_fwd.argtypes = [i, i, i] + [vp] * 9 + [i] * 5 + [vp]
        lib.cerebra_lstm_fwd.restype = i
        lib.cerebra_lstm_bwd.argtypes = [i, i] + [vp] * 8 + [i] * 5 + [vp]
        lib.cerebra_lstm_bwd.restype = i
        lib.cerebra_reduce_partials.argtypes = [vp, vp, i, ctypes.c_longlong, vp]
        lib.cerebra_reduce_partials.restype = i
        lib.cerebra_cuda_error_string.argtypes = [i]
        lib.cerebra_cuda_error_string.restype = ctypes.c_char_p
        lib._cerebra_typed = True
    return lib


def _check_rc(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.cerebra_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _smem_bytes(bwd: bool, bt: int, C: int, H: int, L: int) -> int:
    """Dynamic shared memory of one block, as the C launchers compute it."""
    if bwd:
        return 4 * bt * (2 * L * H + 4 * H + H + max(C, H) + H)
    return 4 * bt * (2 * L * H + C + 4 * H)


def pick_tile(B: int, C: int, H: int, L: int, bwd: bool) -> int:
    """Batch rows per CUDA block, from timings on an H100 at T = 460,
    C = H = 96, L = 2 (PERF.md). The forward's block time hardly grows from
    1 to 8 rows (the per-step weight reads dominate), and 8 rows keep
    B = 1024 to one wave, so it takes 8. The backward's block time grows with
    its rows while its partial-dW traffic grows with the number of blocks;
    about B/16 rows balances the two. Raises if even one row's carries
    overflow shared memory."""
    want = 8 if not bwd else max(1, B // 16)
    for bt in _TILES:
        if bt <= want and _smem_bytes(bwd, bt, C, H, L) <= _MAX_SMEM:
            return bt
    raise ValueError(f"C={C}, H={H}, L={L}: the carries exceed one block's shared memory")


def _cuda_checks(tile, *tensors):
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("the CUDA LSTM kernels take contiguous tensors only")
    if tile not in _TILES:
        raise ValueError(f"tile must be one of {_TILES}, got {tile}")


def _packed(layers: Layers, H: int):
    """(w_ih0, w_ihr (L-1, H, 4H), w_hh (L, H, 4H), b (L, 4H)) contiguous."""
    w_ih0 = layers[0][0].contiguous()
    rest = [l[0] for l in layers[1:]]
    w_ihr = torch.stack(rest) if rest else w_ih0.new_empty((0, H, 4 * H))
    w_hh = torch.stack([l[1] for l in layers])
    b = torch.stack([l[2] for l in layers])
    return w_ih0, w_ihr, w_hh, b


def _fwd_cuda(x, layers, train: bool, tile=None):
    T, B, C, H, L = _dims(x, layers)
    tile = tile or pick_tile(B, C, H, L, bwd=False)
    w_ih0, w_ihr, w_hh, b = _packed(layers, H)
    _cuda_checks(tile, x, w_ih0, w_ihr, w_hh, b)
    lib = _lib()
    if train:
        h_all = torch.empty(L, T, B, H, dtype=x.dtype, device=x.device)
        prefac = torch.empty(L, T, B, 4 * H, dtype=x.dtype, device=x.device)
        qf = torch.empty(L, T, B, 2 * H, dtype=x.dtype, device=x.device)
        outs = (h_all.data_ptr(), prefac.data_ptr(), qf.data_ptr(), None)
    else:
        h_last = torch.empty(B, H, dtype=x.dtype, device=x.device)
        outs = (None, None, None, h_last.data_ptr())
    rc = lib.cerebra_lstm_fwd(
        int(train), int(x.dtype == torch.bfloat16), tile,
        x.data_ptr(), w_ih0.data_ptr(), w_ihr.data_ptr() or None, w_hh.data_ptr(),
        b.data_ptr(), *outs, T, B, C, H, L,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _check_rc(lib, rc, "fwd_train" if train else "fwd_infer_last")
    LAUNCHES["fwd_train" if train else "fwd_infer_last"] += 1
    return (h_all, prefac, qf) if train else h_last


def _bwd_cuda(g, x, layers, h_all, prefac, qf, tile=None):
    T, B, C, H, L = _dims(x, layers)
    tile = tile or pick_tile(B, C, H, L, bwd=True)
    if (tuple(g.shape) != (B, H) or g.dtype != x.dtype
            or tuple(h_all.shape) != (L, T, B, H) or tuple(prefac.shape) != (L, T, B, 4 * H)
            or tuple(qf.shape) != (L, T, B, 2 * H)):
        raise ValueError("cotangent or residuals do not match the stack")
    w_ihT_r = (torch.stack([l[0].t() for l in layers[1:]]) if L > 1
               else x.new_empty((0, 4 * H, H)))
    w_hhT = torch.stack([l[1].t() for l in layers])
    _cuda_checks(tile, g, x, h_all, prefac, qf, w_ihT_r, w_hhT)
    n_blk = -(-B // tile)
    n_part = 4 * H * (C + (L - 1) * H + L * H + L)
    part = torch.empty(n_blk, n_part, dtype=torch.float32, device=x.device)
    lib = _lib()
    rc = lib.cerebra_lstm_bwd(
        int(x.dtype == torch.bfloat16), tile, g.data_ptr(), x.data_ptr(), h_all.data_ptr(),
        prefac.data_ptr(), qf.data_ptr(), w_ihT_r.data_ptr() or None, w_hhT.data_ptr(),
        part.data_ptr(), T, B, C, H, L, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _check_rc(lib, rc, "bwd")
    LAUNCHES["bwd"] += 1
    return _unpack_grads(reduce_partials(part), C, H, L)


def reduce_partials(part: torch.Tensor) -> torch.Tensor:
    """Sum f32 partials (n_blk, n) over blocks in block order: the
    deterministic reduction kernel on CUDA, `part.sum(0)` on the CPU."""
    if part.dim() != 2 or part.dtype != torch.float32 or not part.is_contiguous():
        raise ValueError("partials must be a contiguous f32 (n_blk, n) tensor")
    if not _on_cuda(part):
        return part.sum(0)
    out = torch.empty(part.shape[1], dtype=torch.float32, device=part.device)
    lib = _lib()
    rc = lib.cerebra_reduce_partials(
        part.data_ptr(), out.data_ptr(), part.shape[0], part.shape[1],
        torch.cuda.current_stream(part.device).cuda_stream,
    )
    _check_rc(lib, rc, "bwd_reduce")
    LAUNCHES["bwd_reduce"] += 1
    return out


def _unpack_grads(flat: torch.Tensor, C: int, H: int, L: int):
    """Split [dW_ih0 | dW_ihr | dW_hh | db] into per-layer (dW_ih, dW_hh, db)."""
    G = 4 * H
    n_ih0, n_ihr, n_hh = C * G, (L - 1) * H * G, L * H * G
    ih0 = flat[:n_ih0].view(C, G)
    ihr = flat[n_ih0:n_ih0 + n_ihr].view(L - 1, H, G)
    hh = flat[n_ih0 + n_ihr:n_ih0 + n_ihr + n_hh].view(L, H, G)
    db = flat[n_ih0 + n_ihr + n_hh:].view(L, G)
    return [((ih0 if l == 0 else ihr[l - 1]), hh[l], db[l]) for l in range(L)]


# ---------------------------------------------------------------- wrappers
def fwd_train(x: torch.Tensor, layers: Layers, tile=None):
    """K1 on CUDA, its plain version on the CPU → (h_all, prefac, qf)."""
    if _on_cuda(x, *[w for l in layers for w in l]):
        return _fwd_cuda(x, layers, True, tile)
    return _fwd_train_ref(x, layers)


def fwd_infer_last(x: torch.Tensor, layers: Layers, tile=None) -> torch.Tensor:
    """K3 on CUDA, its plain version on the CPU → h[T−1] of the top layer."""
    if _on_cuda(x, *[w for l in layers for w in l]):
        return _fwd_cuda(x, layers, False, tile)
    return _fwd_infer_last_ref(x, layers)


def bwd(g, x, layers: Layers, h_all, prefac, qf, tile=None):
    """K2 plus its deterministic reduction on CUDA, the plain version on the
    CPU → f32 (dW_ih, dW_hh, db) per layer."""
    if _on_cuda(g, x, h_all, prefac, qf, *[w for l in layers for w in l]):
        return _bwd_cuda(g, x, layers, h_all, prefac, qf, tile)
    return _bwd_ref(g, x, layers, h_all, prefac, qf)


class _StackLast(torch.autograd.Function):
    """h[T−1] of the stack, with weight gradients only (the input is data).
    `impl` is (forward-train, backward) — the dispatching wrappers, or the
    plain versions for timing them on the card."""

    @staticmethod
    def forward(ctx, impl, x, *flat):
        layers = [flat[k:k + 3] for k in range(0, len(flat), 3)]
        h_all, prefac, qf = impl[0](x, layers)
        ctx.impl = impl
        ctx.save_for_backward(x, h_all, prefac, qf, *flat)
        return h_all[-1, -1].clone()

    @staticmethod
    def backward(ctx, g):
        x, h_all, prefac, qf, *flat = ctx.saved_tensors
        layers = [flat[k:k + 3] for k in range(0, len(flat), 3)]
        grads = ctx.impl[1](g.to(x.dtype).contiguous(), x, layers, h_all, prefac, qf)
        out = []
        for w, dw in zip(flat, [d for layer in grads for d in layer]):
            out.append(dw.to(w.dtype))  # as _vjp_bwd casts dW to the weight dtype
        return (None, None, *out)


def _stack_last(impl, infer, x: torch.Tensor, layers: Layers) -> torch.Tensor:
    if x.requires_grad:
        raise NotImplementedError(
            "input gradients need the backward with a dx stream (K2 general), "
            "which is not ported yet"
        )
    flat = [w for layer in layers for w in layer]
    if torch.is_grad_enabled() and any(w.requires_grad for w in flat):
        return _StackLast.apply(impl, x, *flat)
    return infer(x, layers)


def lstm_stack_last(x: torch.Tensor, layers: Layers) -> torch.Tensor:
    """The top layer's final hidden state (B, H) of a time-major stack.

    K1 forward and K2 backward when grad is enabled and a weight requires
    grad, K3 otherwise. The input gets no gradient: x.requires_grad raises."""
    return _stack_last((fwd_train, bwd), fwd_infer_last, x, layers)


def lstm_stack_last_ref(x: torch.Tensor, layers: Layers) -> torch.Tensor:
    """`lstm_stack_last` through the plain versions on any device (for
    timing the kernels against them on the card)."""
    return _stack_last((_fwd_train_ref, _bwd_ref), _fwd_infer_last_ref, x, layers)
