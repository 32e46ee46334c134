"""Fused multi-layer LSTM stack: the CUDA kernels K1, K2/K2g, K3, K4, K10, K11
and their plain PyTorch versions (port of cerebra/models/pallas_lstm_stack.py).

- K1 `fwd_train`: whole-stack forward that streams, per layer, h_all
  (T, B, H), prefac (T, B, 4H) = [g·i(1−i), c_prev·f(1−f), i(1−g²),
  tanh c·o(1−o)] and qf (T, B, 2H) = [o(1−tanh²c), f] for the backward.
- K2 `bwd`: reverse-time backward on those residuals with no
  transcendentals. The cotangent g is (B, H) at t = T−1 or (T, B, H) at
  every t; `need_dx` adds the input gradient dx (T, B, C). The form with a
  (B, H) g and no dx is K2, every other form K2g (the general one). It runs
  layer by layer, top first (`_bwd_layerwise`): one reverse scan of the
  layer's dh/dc carries (`bwd_scan`, the kernel K14 runs too) writes its
  dgates stream, then hand-written products over all T·B rows
  (`bwd_products`) give dW_ih, dW_hh, db and the chain to the layer below
  (dx below layer 0), deterministic.
- K3 `fwd_infer_last`: forward with no residuals, returning the top layer's
  h[T−1] (B, H).
- K4 `fwd_infer`: forward with no residuals, returning the top layer's h at
  every t (T, B, H).
- K1, K3, K4 and K10 in bf16 at the widths `wave_fits` takes (the CLI's
  C = H = 96, L = 2, at every batch) run the wavefront forward
  (`_fwd_wave`, its plain composition `_fwd_wave_ref`): one launch, a
  thread-block cluster a 16-row batch tile, a CTA a layer that holds
  [W_ih; W_hh] in shared memory, the layers one step apart, each step's
  product on the tensor cores and the cell in registers. K4 and K10 where
  only half a layer's weights fit a CTA (`wave_split_fits`: the DINO-LSTM's
  C 96, H 128, L 4) run it with the split layer: two CTAs a layer, each
  holding the columns of half the units, which hand each other their half
  of h every step (`_split_step_ref` is its plain layer-step).
- K1 and K4 at the small batches `pick_fwd` takes (the recurrent
  autoencoder's B = 16) run layer by layer, bottom first
  (`_fwd_layerwise`): the layer's input product over all T·B rows
  (`fwd_in_product`, f32 P = inp·W_ih), then its recurrence over P on a
  thread-block cluster that keeps W_hh in shared memory
  (`fwd_cluster_scan`), which writes h and, for K1, the residuals. Every
  other shape runs the whole stack in one launch (`lstm_fwd_kernel`);
  `fwd_path` states the rule.
- K10 `fwd_train_rc`: the recompute variant's forward, which streams only
  h_all and c_all (T, B, H) per layer, c rounded to the stream dtype (2H a
  row and layer instead of K1's 7H).
- K11 `bwd_rc`: its backward, which recomputes the gates from h, c and the
  input at t and t−1, runs the chain with its own rounding points and always
  emits dx. It runs over time chunks, last first, and in each over the
  layers, top first (`_bwd_rc_chunked`): the chunk's gates on the tensor
  cores (`rc_gates`), the reverse scan that forms K11's residuals from them
  step by step, with the dh/dc carries handed from chunk to chunk
  (`rc_scan`), and the products (`rc_products`: dW partials per fixed group
  of rows, the chain to the layer below, dx), then one ordered sum of the
  groups a layer.
  `lstm_stack_rc` runs K10/K11 under grad and K4 without.

Layout is time-major: x (T, B, C); layers are (w_ih (in, 4H), w_hh (H, 4H),
b (4H,)) in the stream dtype (float32 or bfloat16), in = C for layer 0 and H
after; gate order [i, f, g, o]. Residuals are stacked over layers:
h_all (L, T, B, H), prefac (L, T, B, 4H), qf (L, T, B, 2H), c_all (L, T, B, H).

Dispatch: a tensor on the CPU takes the plain version (`_fwd_train_ref`,
`_bwd_ref`, `_scan_bwd_ref`, `_products_ref`, `_fwd_infer_last_ref`,
`_fwd_infer_ref`, `_in_product_ref`, `_fwd_scan_ref`, `_fwd_train_rc_ref`,
`_bwd_rc_ref`, `_rc_gates_ref`, `_rc_scan_ref`, `_rc_products_ref`); a CUDA
tensor launches the kernel, built at first use, or raises. `LAUNCHES` counts
kernel launches so a run can show that it went through the kernels
(`fwd_train`, `fwd_infer`, `bwd` for K2, `bwd_general` for K2g, `bwd_rc` for
K11, one a call; `fwd_wave` one a launch of the wavefront forward (K1, K3,
K4 or K10), `fwd_wave_split` one a launch of it with the split layer (K4 or
K10); `fwd_in_product` and `fwd_cluster_scan` one a layer of K1/K4's
layer-by-layer path; `stack_bwd_scan` and `stack_bwd_products` one
a layer of K2/K2g; `rc_gates`, `rc_scan` and `rc_products` one a chunk and
layer of K11).

The 128-lane padding and 8-row batch alignment of the Pallas wrappers
(`_pad_for_kernel`) are a TPU layout choice and are not ported: the CUDA
kernels mask a ragged batch tile themselves.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Sequence, Tuple

import torch

from cerebra_torch.kernels import (  # noqa: F401  (reset_launches is re-exported)
    LAUNCHES,
    check_rc,
    count_shape,
    load_lib,
    on_cuda,
    ptr,
    reset_launches,
    stream_of,
)

Layers = Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]

LAUNCHES.update(fwd_train=0, bwd=0, fwd_infer_last=0, fwd_infer=0, bwd_general=0,
                fwd_train_rc=0, bwd_rc=0, fwd_in_product=0, fwd_cluster_scan=0, fwd_wave=0,
                fwd_wave_split=0, stack_bwd_scan=0, stack_bwd_products=0, rc_gates=0, rc_scan=0,
                rc_products=0)
_FWD_MODES = {"fwd_infer_last": 0, "fwd_train": 1, "fwd_infer": 2, "fwd_train_rc": 3}  # FwdMode

_STREAM_DTYPES = (torch.float32, torch.bfloat16)
_TILES = (16, 8, 4, 2, 1)
_MAX_SMEM = 232448  # bytes of shared memory one H100 block may use
_SMS = 132  # streaming multiprocessors of an H100 SXM
_SM_SMEM = 233472  # bytes of shared memory of one H100 SM, for all its blocks


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


# ---------------------------------------------------------- plain versions
def _gates(inp, h, w_ih, w_hh, b, sd):
    """x·W_ih + h·W_hh + b with stream-dtype operands and f32 accumulation
    (products of two bf16 values are exact in f32)."""
    return (inp.float() @ w_ih.float() + h.to(sd).float() @ w_hh.float()) + b.float()


def _residuals(i, f, g, o, c_prev, tanh_c, sd):
    """The backward's residuals of one step in the stream dtype: prefac
    [g·i(1−i), c_prev·f(1−f), i(1−g²), tanh c·o(1−o)] and qf [o(1−tanh²c), f]."""
    prefac = torch.cat(
        [g * (i - i * i), c_prev * (f - f * f), i - g * (i * g), tanh_c * (o - o * o)], -1)
    return prefac.to(sd), torch.cat([o - o * tanh_c * tanh_c, f], -1).to(sd)


def _dgates(dc_n, dh_n, pf, sd):
    """[dc·p_i, dc·p_f, dc·p_g, dh·p_o] rounded to the stream dtype, from the
    rounded carries and the f32 view of the stored prefactors."""
    H = dc_n.shape[-1]
    return torch.cat([dc_n * pf[:, :H], dc_n * pf[:, H:2 * H], dc_n * pf[:, 2 * H:3 * H],
                      dh_n * pf[:, 3 * H:]], -1).to(sd)


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
            c[l] = f * c_prev + i * g
            tanh_c = torch.tanh(c[l])
            h[l] = o * tanh_c
            inp = h[l].to(sd)
            h_all[l, t] = inp
            prefac[l, t], qf[l, t] = _residuals(i, f, g, o, c_prev, tanh_c, sd)
    return h_all, prefac, qf


def _fwd_infer_ref(x: torch.Tensor, layers: Layers) -> torch.Tensor:
    """Plain K4: the forward without residuals; the top layer's h at every
    t (T, B, H)."""
    T, B, C, H, L = _dims(x, layers)
    sd = x.dtype
    h = [torch.zeros(B, H, device=x.device) for _ in range(L)]
    c = [torch.zeros(B, H, device=x.device) for _ in range(L)]
    out = torch.empty(T, B, H, dtype=sd, device=x.device)
    for t in range(T):
        inp = x[t]
        for l, (w_ih, w_hh, b) in enumerate(layers):
            gates = _gates(inp, h[l], w_ih, w_hh, b, sd)
            i, f, o = (torch.sigmoid(gates[:, k * H:(k + 1) * H]) for k in (0, 1, 3))
            g = torch.tanh(gates[:, 2 * H:3 * H])
            c[l] = f * c[l] + i * g
            h[l] = o * torch.tanh(c[l])
            inp = h[l].to(sd)
        out[t] = inp
    return out


def _fwd_infer_last_ref(x: torch.Tensor, layers: Layers) -> torch.Tensor:
    """Plain K3: the forward without residuals; the top layer's h[T−1]."""
    return _fwd_infer_ref(x, layers)[-1]


def _in_product_ref(inp: torch.Tensor, w_ih: torch.Tensor) -> torch.Tensor:
    """Plain input product of one layer of K1/K4's layer-by-layer path:
    P (T, B, 4H) f32 = inp·W_ih over all T·B rows of inp (T, B, in), with
    stream-dtype operands and f32 sums; no bias, nothing rounded."""
    return inp.float() @ w_ih.float()


def _fwd_scan_ref(P: torch.Tensor, w_hh: torch.Tensor, b: torch.Tensor, res: bool = False):
    """Plain recurrence of one layer over its input product P (T, B, 4H) f32:
    gates = (P_t + h_{t−1}·W_hh) + b, h rounded to the stream dtype (w_hh's)
    before W_hh, K1's cell math and rounding. → (h (T, B, H) in the stream
    dtype, and with `res` K1's prefac (T, B, 4H) and qf (T, B, 2H) of the
    layer, else None, None)."""
    T, B, G = P.shape
    H, sd = G // 4, w_hh.dtype
    h = torch.zeros(B, H, device=P.device)
    c = torch.zeros(B, H, device=P.device)
    h_seq = torch.empty(T, B, H, dtype=sd, device=P.device)
    prefac = torch.empty(T, B, G, dtype=sd, device=P.device) if res else None
    qf = torch.empty(T, B, 2 * H, dtype=sd, device=P.device) if res else None
    for t in range(T):
        gates = (P[t] + h.to(sd).float() @ w_hh.float()) + b.float()
        i = torch.sigmoid(gates[:, :H])
        f = torch.sigmoid(gates[:, H:2 * H])
        g = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:])
        c_prev = c
        c = f * c_prev + i * g
        tanh_c = torch.tanh(c)
        h = o * tanh_c
        h_seq[t] = h.to(sd)
        if res:
            prefac[t], qf[t] = _residuals(i, f, g, o, c_prev, tanh_c, sd)
    return h_seq, prefac, qf


def _fwd_layerwise(x: torch.Tensor, layers: Layers, product, scan) -> torch.Tensor:
    """K1/K4 as the layer-by-layer CUDA path composes them, bottom layer
    first: `product(inp, w_ih)` → the layer's f32 input product P, then
    `scan(l, P, w_hh, b)` → the layer's h (T, B, H), which is the next
    layer's input (the scan writes whatever else the caller keeps: K1's
    residuals). Returns the top layer's h."""
    inp = x
    for l, (w_ih, w_hh, b) in enumerate(layers):
        inp = scan(l, product(inp, w_ih), w_hh, b)
    return inp


def _fwd_layerwise_ref(x: torch.Tensor, layers: Layers, train: bool):
    """`_fwd_layerwise` through the plain pieces, on any device: K1's
    (h_all, prefac, qf) stacked over the layers when `train`, else K4's top
    h (T, B, H)."""
    _dims(x, layers)
    outs = []

    def scan(l, P, w_hh, b):
        outs.append(_fwd_scan_ref(P, w_hh, b, train))
        return outs[-1][0]

    top = _fwd_layerwise(x, layers, _in_product_ref, scan)
    if not train:
        return top
    return tuple(torch.stack([o[k] for o in outs]) for k in range(3))


_WAVE_ROWS = 16  # batch rows of one row tile (csrc/lstm_stack.cu kWaveRows)
_WAVE_RING = 4  # slots of a layer's input ring (kWaveRing)
_WAVE_SPLIT_TILES = 3  # row tiles a cluster of the split layer takes, at most (kWaveSplitTiles)


def _wave_step_ref(inp, h, c, w_ih, w_hh, b, res: bool):
    """Plain layer-step of the wavefront path over a tile's rows: gates =
    (inp·W_ih + h·W_hh) + b with stream-dtype operands and f32 sums, K1's
    f32 cell → (h_t in the stream dtype, c_t f32, and with `res` K1's
    prefac and qf of the step, else None, None). The gates' width is
    w_hh's columns, all 4H or, for a CTA of the split layer, its 4U."""
    H, sd = w_hh.shape[1] // 4, w_hh.dtype
    gates = _gates(inp, h, w_ih, w_hh, b, sd)
    i = torch.sigmoid(gates[:, :H])
    f = torch.sigmoid(gates[:, H:2 * H])
    g = torch.tanh(gates[:, 2 * H:3 * H])
    o = torch.sigmoid(gates[:, 3 * H:])
    c_new = f * c + i * g
    tanh_c = torch.tanh(c_new)
    prefac, qf = _residuals(i, f, g, o, c, tanh_c, sd) if res else (None, None)
    return (o * tanh_c).to(sd), c_new, prefac, qf


def _split_step_ref(inp, h, c, w_ih, w_hh, b, res: bool):
    """Plain layer-step of the split layer: each of the two CTAs of a layer
    owns half the units, [0, H/2) and [H/2, H), and computes their four
    gates from its own columns of W_ih, W_hh and b (columns q H + u of gate
    q for its units u) on the whole inp and h, then the cell on its half
    of c; the halves are concatenated, as the CTAs hand each other their
    half of h_t. The same values as `_wave_step_ref`'s step."""
    H = w_hh.shape[0]
    U = H // 2
    halves = []
    for s in range(2):
        cols = torch.cat([torch.arange(q * H + s * U, q * H + (s + 1) * U) for q in range(4)])
        halves.append(_wave_step_ref(inp, h, c[:, s * U:(s + 1) * U], w_ih[:, cols],
                                     w_hh[:, cols], b[cols], res))

    def merge(k, blocks):
        """Output k of the step from the halves' blocks of U units: h and c
        are one block, prefac four (a gate each), qf two (q, f)."""
        if halves[0][k] is None:
            return None
        return torch.cat([hv[k][:, j * U:(j + 1) * U] for j in range(blocks) for hv in halves], -1)

    return merge(0, 1), merge(1, 1), merge(2, 4), merge(3, 2)


_WAVE_KINDS = ("fwd_train", "fwd_infer_last", "fwd_train_rc", "fwd_infer")


def _fwd_wave(x: torch.Tensor, layers: Layers, kind: str, step, mt: int = 1):
    """K1 (`kind` fwd_train: (h_all, prefac, qf)), K3 (fwd_infer_last: the
    top layer's h at T−1, (B, H)), K10 (fwd_train_rc: (h_all, c_all), c_t
    rounded to the stream dtype from its f32 carry) or K4 (fwd_infer: the
    top layer's h at every t, (T, B, H)) as the wavefront CUDA path composes
    them, through `step(l, inp, h, c, res)` → (h_t, c_t, prefac_t, qf_t) of
    layer l (`res` for K1 only). The batch runs in tiles of 16 `mt` rows (a
    cluster's, `split_tiles`), zero rows past B. In a tile, at iteration
    s = 0 .. T + L − 2 each layer l, bottom first, runs its step t = s − l
    on the input its ring holds in slot t % 4 (x_t for layer 0; h_t of the
    layer below, put there an iteration before) and its own h_{t−1}, then
    puts h_t into the ring of the layer above."""
    if kind not in _WAVE_KINDS:
        raise ValueError(f"the wavefront forward does not run {kind}")
    T, B, C, H, L = _dims(x, layers)
    sd, dev, R = x.dtype, x.device, _WAVE_RING
    res, seqs = kind == "fwd_train", ()
    if kind in ("fwd_train", "fwd_train_rc"):
        seqs = tuple(torch.empty(L, T, B, w, dtype=sd, device=dev)
                     for w in ((H, 4 * H, 2 * H) if res else (H, H)))
    else:
        out = torch.empty((B, H) if kind == "fwd_infer_last" else (T, B, H), dtype=sd, device=dev)
    tile = _WAVE_ROWS * mt
    for b0 in range(0, B, tile):
        n = min(tile, B - b0)
        rows = slice(b0, b0 + n)
        ring = [[None] * R for _ in range(L)]
        h = [torch.zeros(tile, H, dtype=sd, device=dev) for _ in range(L)]
        c = [torch.zeros(tile, H, device=dev) for _ in range(L)]
        for s in range(T + L - 1):
            for l in range(L):
                t = s - l
                if not 0 <= t < T:
                    continue
                if l == 0:
                    ring[0][t % R] = x.new_zeros(tile, C)
                    ring[0][t % R][:n] = x[t, rows]
                h[l], c[l], pf, q = step(l, ring[l][t % R], h[l], c[l], res)
                if l + 1 < L:
                    ring[l + 1][t % R] = h[l]
                if seqs:  # K1's residuals, or K10's h and c rounded to the stream dtype
                    for seq, v in zip(seqs, (h[l], pf, q) if res else (h[l], c[l].to(sd))):
                        seq[l, t, rows] = v[:n]
                elif l == L - 1 and kind == "fwd_infer":
                    out[t, rows] = h[l][:n]
                elif l == L - 1 and t == T - 1:
                    out[rows] = h[l][:n]
    return seqs or out


def _fwd_wave_ref(x: torch.Tensor, layers: Layers, kind: str, split: bool = False, mt: int = 1):
    """`_fwd_wave` through the plain layer-step, or with `split` the split
    layer's (`_split_step_ref`), in tiles of 16 `mt` rows, on any device."""
    step = _split_step_ref if split else _wave_step_ref
    return _fwd_wave(x, layers, kind, lambda l, inp, h, c, res: step(inp, h, c, *layers[l], res),
                     mt)


def _bwd_ref(g, x, layers: Layers, h_all, prefac, qf, need_dx: bool = False):
    """Plain K2/K2g: consumes K1's residuals (not autograd through the loop).
    g in the stream dtype is (B, H), hitting the top layer at T−1 only, or
    (T, B, H), hitting it at every t. Returns (dx (T, B, C) in the stream
    dtype when `need_dx`, else None; f32 (dW_ih, dW_hh, db) per layer)."""
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
    dx = torch.empty(T, B, C, dtype=sd, device=dev) if need_dx else None
    zero = torch.zeros(B, H, device=dev)
    for t in reversed(range(T)):
        if g.dim() == 3:
            g_up = g[t].float()
        else:
            g_up = g.float() if t == T - 1 else zero
        for l in reversed(range(L)):
            w_ih, w_hh, _ = layers[l]
            q = qf[l, t].float()
            d_h = dh[l] + g_up
            d_c = dc[l] + d_h * q[:, :H]
            dc_n, dh_n = d_c.to(sd).float(), d_h.to(sd).float()
            dgates = _dgates(dc_n, dh_n, prefac[l, t].float(), sd).float()
            dh[l] = dgates @ w_hh.float().t()
            dc[l] = d_c * q[:, H:]
            h_prev = h_all[l, t - 1].float() if t > 0 else zero
            inp = (x[t] if l == 0 else h_all[l - 1, t]).float()
            grads[l][0] += inp.t() @ dgates
            grads[l][1] += h_prev.t() @ dgates
            grads[l][2] += dgates.sum(0)
            if l > 0 or need_dx:
                g_up = dgates @ w_ih.float().t()
        if need_dx:
            dx[t] = g_up.to(sd)
    return dx, [tuple(gr) for gr in grads]


def _scan_bwd_ref(g, prefac, qf, w_hh, carry=None) -> torch.Tensor:
    """Plain reverse scan of one layer (K14, each layer of K2/K2g, and each
    chunk and layer of K11, `_rc_scan_ref`): prefac (T, B, 4H) in the stream
    dtype, qf (T, B, 2H) in the stream dtype or f32 (K11's q and f), w_hh
    (H, 4H), and
    g the cotangent of the layer's h: (T, B, H), or (B, H) reaching t = T−1
    only; in the stream dtype, or f32 (the chain from the layer above, not
    rounded) → dgates (T, B, 4H) in the stream dtype. The dh/dc carries are
    f32; dc and dh are rounded to the stream dtype before the products with
    the prefactors, which are rounded too (bf16 products in bf16). `carry`:
    None (the carries start at zero), or an f32 (2, B, H) tensor [dh_acc |
    dc] read as the carries entering step T−1 and overwritten with those
    leaving step 0, so that a scan cut into chunks is the scan of the whole."""
    T, B, G = prefac.shape
    H = G // 4
    sd = prefac.dtype
    dev = prefac.device
    wT = w_hh.float().t()
    dh = torch.zeros(B, H, device=dev) if carry is None else carry[0].clone()
    dc = torch.zeros(B, H, device=dev) if carry is None else carry[1].clone()
    zero = torch.zeros(B, H, device=dev)
    dgates = torch.empty(T, B, G, dtype=sd, device=dev)
    for t in reversed(range(T)):
        if g.dim() == 3:
            g_t = g[t].float()
        else:
            g_t = g.float() if t == T - 1 else zero
        q = qf[t].float()
        d_h = dh + g_t
        d_c = dc + d_h * q[:, :H]
        dg = _dgates(d_c.to(sd).float(), d_h.to(sd).float(), prefac[t].float(), sd)
        dgates[t] = dg
        dh = dg.float() @ wT
        dc = d_c * q[:, H:]
    if carry is not None:
        carry[0].copy_(dh)
        carry[1].copy_(dc)
    return dgates


def _products_ref(dgates, inp, h, w_ih, chain=None):
    """Plain products of one layer of K2/K2g over all T·B rows of its dgates
    (T, B, 4H): f32 dW_ih = inpᵀ·dgates (in, 4H), dW_hh = h[0:T−1]ᵀ·
    dgates[1:T] (H, 4H; h_prev is zero at t = 0) and db = Σ dgates (4H), sums
    of exact products of the stream-dtype values; and the chain dgates·w_ihᵀ
    (T, B, in) to the layer below, kept f32 (`chain` "gup") or rounded to the
    stream dtype (`chain` "dx"), or None. → (dW_ih, dW_hh, db, chain)."""
    T, B, G = dgates.shape
    d = dgates.reshape(T * B, G).float()
    dw_ih = inp.reshape(T * B, -1).float().t() @ d
    dw_hh = h[:-1].reshape(-1, G // 4).float().t() @ d[B:]
    out = None
    if chain is not None:
        out = (d @ w_ih.float().t()).view(T, B, -1)
        if chain == "dx":
            out = out.to(dgates.dtype)
    return dw_ih, dw_hh, d.sum(0), out


def _bwd_layerwise(g, x, layers: Layers, h_all, prefac, qf, need_dx: bool, scan, products):
    """K2/K2g as one reverse scan and one set of products a layer, top layer
    first (the composition the CUDA path runs; `_bwd_ref`'s result but for
    the order of dW's sums). `scan(cot, prefac[l], qf[l], w_hh)` → the
    layer's dgates (T, B, 4H) from the cotangent of its h: the caller's g
    for the top layer ((B, H) at T−1 or (T, B, H)), the f32 chain from the
    layer above below it. `products(l, dgates, inp, h_all[l], w_ih, chain)`
    → (dW_ih, dW_hh, db, out), out the f32 chain to the layer below
    (`chain` "gup"), dx in the stream dtype ("dx") or None. Returns (dx or
    None, f32 (dW_ih, dW_hh, db) per layer)."""
    L = len(layers)
    grads = [None] * L
    cot = g
    for l in reversed(range(L)):
        w_ih, w_hh, _ = layers[l]
        dgates = scan(cot, prefac[l], qf[l], w_hh)
        chain = "gup" if l > 0 else ("dx" if need_dx else None)
        dw_ih, dw_hh, db, cot = products(l, dgates, x if l == 0 else h_all[l - 1], h_all[l],
                                         w_ih, chain)
        grads[l] = (dw_ih, dw_hh, db)
    return cot, grads


def _bwd_layerwise_ref(g, x, layers: Layers, h_all, prefac, qf, need_dx: bool = False):
    """`_bwd_layerwise` through the plain pieces, on any device."""
    return _bwd_layerwise(g, x, layers, h_all, prefac, qf, need_dx, _scan_bwd_ref,
                          lambda l, *args: _products_ref(*args))


def _fwd_train_rc_ref(x: torch.Tensor, layers: Layers):
    """Plain K10: the forward that streams h_all and c_all (L, T, B, H), c
    rounded to the stream dtype while its f32 carry stays unrounded."""
    T, B, C, H, L = _dims(x, layers)
    sd = x.dtype
    h = [torch.zeros(B, H, device=x.device) for _ in range(L)]
    c = [torch.zeros(B, H, device=x.device) for _ in range(L)]
    h_all = torch.empty(L, T, B, H, dtype=sd, device=x.device)
    c_all = torch.empty(L, T, B, H, dtype=sd, device=x.device)
    for t in range(T):
        inp = x[t]
        for l, (w_ih, w_hh, b) in enumerate(layers):
            gates = _gates(inp, h[l], w_ih, w_hh, b, sd)
            i, f, o = (torch.sigmoid(gates[:, k * H:(k + 1) * H]) for k in (0, 1, 3))
            g = torch.tanh(gates[:, 2 * H:3 * H])
            c[l] = f * c[l] + i * g
            h[l] = o * torch.tanh(c[l])
            inp = h[l].to(sd)
            h_all[l, t] = inp
            c_all[l, t] = c[l].to(sd)
    return h_all, c_all


def _bwd_rc_ref(g, x, layers: Layers, h_all, c_all):
    """Plain K11: consumes K10's residuals. g (T, B, H) in the stream dtype
    hits the top layer at every t. Each layer-step recomputes its gates from
    the input at t and h at t−1, then follows `_bwd_rc_kernel`'s rounding
    points: q and f stay f32, the four prefactors and dc, dh are rounded to
    the stream dtype, and so are their products. Returns (dx (T, B, C) in
    the stream dtype; f32 (dW_ih, dW_hh, db) per layer)."""
    T, B, C, H, L = _dims(x, layers)
    sd = x.dtype
    dev = x.device

    def rnd(a):
        return a.to(sd).float()

    dh = [torch.zeros(B, H, device=dev) for _ in range(L)]
    dc = [torch.zeros(B, H, device=dev) for _ in range(L)]
    grads = [
        [torch.zeros(w_ih.shape, device=dev), torch.zeros(w_hh.shape, device=dev),
         torch.zeros(b.shape, device=dev)]
        for (w_ih, w_hh, b) in layers
    ]
    dx = torch.empty(T, B, C, dtype=sd, device=dev)
    zero = torch.zeros(B, H, device=dev)
    for t in reversed(range(T)):
        g_up = g[t].float()
        for l in reversed(range(L)):
            w_ih, w_hh, b = layers[l]
            inp = (x[t] if l == 0 else h_all[l - 1, t]).float()
            h_prev = h_all[l, t - 1].float() if t > 0 else zero
            c_prev = c_all[l, t - 1].float() if t > 0 else zero
            gates = _gates(inp, h_prev, w_ih, w_hh, b, sd)
            i, f, o = (torch.sigmoid(gates[:, k * H:(k + 1) * H]) for k in (0, 1, 3))
            gg = torch.tanh(gates[:, 2 * H:3 * H])
            tanh_c = torch.tanh(c_all[l, t].float())
            d_h = dh[l] + g_up
            d_c = dc[l] + d_h * (o - o * tanh_c * tanh_c)
            dc_n, dh_n = rnd(d_c), rnd(d_h)
            dgates = rnd(torch.cat(
                [dc_n * rnd(gg * (i - i * i)), dc_n * rnd(c_prev * (f - f * f)),
                 dc_n * rnd(i - gg * (i * gg)), dh_n * rnd(tanh_c * (o - o * o))], -1,
            ))
            dh[l] = dgates @ w_hh.float().t()
            dc[l] = d_c * f
            grads[l][0] += inp.t() @ dgates
            grads[l][1] += h_prev.t() @ dgates
            grads[l][2] += dgates.sum(0)
            g_up = dgates @ w_ih.float().t()
        dx[t] = g_up.to(sd)
    return dx, [tuple(gr) for gr in grads]


def _shifted(prev: torch.Tensor, n: int) -> torch.Tensor:
    """A stream one step back over a chunk of n steps (h or c at t−1), given
    as its n steps, or as n−1 for the chunk that starts at t = 0: the n
    steps, a zero step first there (a copy; else `prev` itself)."""
    if prev.shape[0] == n:
        return prev
    return torch.cat([prev.new_zeros((1,) + tuple(prev.shape[1:])), prev])


def _rc_gates_ref(inp, h_prev, w_ih, w_hh, b):
    """Plain gate recompute of one K11 chunk: f32 gates (n, B, 4H) = inp·W_ih
    + h_prev·W_hh + b for inp (n, B, in) and the layer's h one step back,
    h_prev (n, B, H)."""
    return _gates(inp, h_prev, w_ih, w_hh, b, inp.dtype)


def _rc_residuals_ref(gates, c, c_prev):
    """Plain residuals of one K11 chunk from its f32 gates (n, B, 4H) and the
    stored c at t and t−1 (n, B, H) each: prefac, the four prefactors
    rounded to c's dtype, and qf = [q, f] (n, B, 2H), f32."""
    H = c.shape[-1]
    i, f, o = (torch.sigmoid(gates[..., k * H:(k + 1) * H]) for k in (0, 1, 3))
    gg = torch.tanh(gates[..., 2 * H:3 * H])
    cp = c_prev.float()
    tc = torch.tanh(c.float())
    prefac = torch.cat([gg * (i - i * i), cp * (f - f * f), i - gg * (i * gg), tc * (o - o * o)],
                       -1)
    return prefac.to(c.dtype), torch.cat([o - o * tc * tc, f], -1)


def _rc_scan_ref(g, gates, c, c_prev, w_hh, carry=None):
    """Plain reverse scan of one K11 chunk: `_scan_bwd_ref` on the residuals
    `_rc_residuals_ref` forms from the chunk's f32 gates and c, c_prev."""
    return _scan_bwd_ref(g, *_rc_residuals_ref(gates, c, c_prev), w_hh, carry)


def _rc_products_ref(dgates, inp, h_prev, w_ih, chain, rows: int, part=None, out=None):
    """Plain products of one K11 chunk over its n·B rows of dgates
    (n, B, 4H): for each group of `rows` rows, part[z] = [dW_ih | dW_hh |
    db] of the group flattened (f32 sums of exact products; h_prev
    (n, B, H) pairs with dgates step by step), and the chain dgates·w_ihᵀ
    (n, B, in), f32 ("gup") or rounded to the stream dtype ("dx"), written
    into `out` where given. → (part (groups, (in + H + 1)·4H), chain)."""
    n, B, G = dgates.shape
    d = dgates.reshape(n * B, G).float()
    a = inp.reshape(n * B, -1).float()
    hp = h_prev.reshape(n * B, -1).float()
    groups = -(-n * B // rows)
    if part is None:
        part = torch.empty(groups, (a.shape[1] + hp.shape[1] + 1) * G, device=d.device)
    for z in range(groups):
        r = slice(z * rows, (z + 1) * rows)
        part[z] = torch.cat([(a[r].t() @ d[r]).flatten(), (hp[r].t() @ d[r]).flatten(),
                             d[r].sum(0)])
    res = None
    if chain is not None:
        res = (d @ w_ih.float().t()).view(n, B, -1)
        if chain == "dx":
            res = res.to(dgates.dtype)
        if out is not None:
            res = out.copy_(res)
    return part, res


class _RcPieces(NamedTuple):
    """K11's pieces as `_bwd_rc_chunked` calls them: gates(inp, h_prev, w_ih,
    w_hh, b), scan(cot, gates, c, c_prev, w_hh, carry), products(dgates,
    inp, h_prev, w_ih, chain, rows, part, out) and sum(part) over the
    groups."""
    gates: Callable
    scan: Callable
    products: Callable
    sum: Callable


_RC_PLAIN = _RcPieces(_rc_gates_ref, _rc_scan_ref, _rc_products_ref, lambda part: part.sum(0))


def rc_group(B: int) -> int:
    """Steps in one of K11's dW groups: enough for 4096 rows (the longest row
    chunk of K2's products), so each f32 partial sums at most as many rows
    as there and B = 1024 takes 4 steps."""
    return max(1, -(-4096 // B))


def rc_chunk(T: int, B: int, group: int) -> int:
    """Steps in one of K11's time chunks: a multiple of `group`, about 65536
    rows, or the whole sequence where that is shorter. On an H100 (PERF.md,
    `[rc chunks]`, B = 1024, bf16) 64 steps took K11 within 9 % of one
    chunk of the whole sequence at both shapes (C = H = 96, L = 2, T = 460;
    C 96, H 128, L 4, T = 300), and 32 steps 19 % and 11 %, while the chunk
    buffers and so K11's peak grow with the chunk (405 against 1968 MiB
    above its inputs at the first shape)."""
    return min(-(-T // group), max(1, -(-65536 // (B * group)))) * group


def _bwd_rc_chunked(g, x, layers: Layers, h_all, c_all, chunk: int, group: int,
                    pieces: _RcPieces):
    """K11 as the CUDA path composes it. Time chunks of `chunk` steps (a
    multiple of `group`, or the whole sequence), last first; in each, the
    layers top first: the chunk's gates, the reverse scan forming the
    residuals from them under the cotangent of the layer's h (g for the top
    layer, the f32 chain from the layer above below it) with the layer's
    dh/dc carried from the chunk after, and the products into the chunk's
    dW groups of `group` steps and the chain (dx at layer 0). One sum of
    the groups a layer at the end. dx and dW do not depend on `chunk`.
    Returns (dx (T, B, C) in the stream dtype; f32 (dW_ih, dW_hh, db) per
    layer)."""
    T, B, C, H, L = _dims(x, layers)
    if chunk < T and chunk % group:
        raise ValueError(f"chunk {chunk} is not a multiple of the dW group {group}")
    G, dev = 4 * H, x.device
    n_groups = -(-T // group)
    sizes = [((C if l == 0 else H) + H + 1) * G for l in range(L)]
    scratch = torch.empty(n_groups * sum(sizes), dtype=torch.float32, device=dev)
    parts = list(scratch.split([n_groups * n for n in sizes]))
    parts = [p.view(n_groups, n) for p, n in zip(parts, sizes)]
    carry = torch.zeros(L, 2, B, H, dtype=torch.float32, device=dev)
    dx = torch.empty(T, B, C, dtype=x.dtype, device=dev)
    for t0 in reversed(range(0, T, chunk)):
        t1 = min(T, t0 + chunk)
        back = slice(max(t0 - 1, 0), t1 - 1)  # one step back; t = 0 has none
        z = slice(t0 // group, -(-t1 // group))
        cot = g[t0:t1]
        for l in reversed(range(L)):
            w_ih, w_hh, b = layers[l]
            inp = x[t0:t1] if l == 0 else h_all[l - 1, t0:t1]
            h_prev = _shifted(h_all[l, back], t1 - t0)
            dgates = pieces.scan(cot, pieces.gates(inp, h_prev, w_ih, w_hh, b), c_all[l, t0:t1],
                                 _shifted(c_all[l, back], t1 - t0), w_hh, carry[l])
            cot = pieces.products(dgates, inp, h_prev, w_ih, "gup" if l else "dx", group * B,
                                  parts[l][z], None if l else dx[t0:t1])[1]
    grads = []
    for l in range(L):
        in_dim = C if l == 0 else H
        flat = pieces.sum(parts[l])
        grads.append((flat[:in_dim * G].view(in_dim, G),
                      flat[in_dim * G:(in_dim + H) * G].view(H, G), flat[(in_dim + H) * G:]))
    return dx, grads


def _bwd_rc_chunked_ref(g, x, layers: Layers, h_all, c_all, chunk: int, group: int = 1):
    """`_bwd_rc_chunked` through the plain pieces, on any device."""
    return _bwd_rc_chunked(g, x, layers, h_all, c_all, chunk, group, _RC_PLAIN)


# ------------------------------------------------------------ CUDA kernels
def _typed(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.cerebra_lstm_fwd.argtypes = [i, i, i] + [vp] * 10 + [i] * 5 + [vp]
    lib.cerebra_lstm_fwd.restype = i
    lib.cerebra_fwd_in_product.argtypes = [i, vp, vp, vp, i, i, i, vp]
    lib.cerebra_fwd_in_product.restype = i
    lib.cerebra_fwd_cluster_scan.argtypes = [i, i, i] + [vp] * 6 + [i] * 3 + [vp]
    lib.cerebra_fwd_cluster_scan.restype = i
    lib.cerebra_fwd_wave.argtypes = [i, i, i] + [vp] * 10 + [i] * 5 + [vp]
    lib.cerebra_fwd_wave.restype = i
    lib.cerebra_fwd_wave_clusters.argtypes = [i] * 5
    lib.cerebra_fwd_wave_clusters.restype = i
    lib.cerebra_stack_scan_bwd.argtypes = [i] * 4 + [vp] * 5 + [i] * 3 + [vp]
    lib.cerebra_stack_scan_bwd.restype = i
    lib.cerebra_stack_bwd_products.argtypes = ([i, vp, vp, i, vp, vp, i] + [vp] * 5 + [i] * 5
                                               + [vp])
    lib.cerebra_stack_bwd_products.restype = i
    lib.cerebra_rc_gates.argtypes = [i] + [vp] * 4 + [i] * 3 + [vp]
    lib.cerebra_rc_gates.restype = i
    lib.cerebra_rc_scan.argtypes = [i] * 3 + [vp] * 7 + [i] * 3 + [vp]
    lib.cerebra_rc_scan.restype = i
    lib.cerebra_rc_products.argtypes = [i, vp, vp, i, vp, vp, i, vp, vp, vp] + [i] * 4 + [vp]
    lib.cerebra_rc_products.restype = i
    lib.cerebra_sum_partials.argtypes = [vp, vp, i, ctypes.c_longlong, vp]
    lib.cerebra_sum_partials.restype = i


def _lib():
    return load_lib("lstm_stack", _typed)


def pick_tile(B: int, C: int, H: int, L: int) -> int:
    """Batch rows per CUDA block of the forwards, from timings on an H100 at
    T = 460 (PERF.md). The forward's block time hardly grows from 1 to 8
    rows (the per-step weight reads dominate; C = H = 96, L = 2, and the
    autoencoder's C = 96, H = 384 and C = 384, H = 96), and 8 rows keep
    B = 1024 to one wave, so it takes 8, or fewer where the carries (the
    launcher's shared memory) overflow one block. Raises if even one row's
    do."""
    for bt in _TILES:
        if bt <= 8 and 4 * bt * (2 * L * H + C + 4 * H) <= _MAX_SMEM:
            return bt
    raise ValueError(f"C={C}, H={H}, L={L}: the carries exceed one block's shared memory")


_CLUSTER_ROWS = 16  # batch rows of one cluster's tile (csrc/lstm_stack.cu kClusterRows)
_CLUSTER_SIZES = (16, 8, 4, 2, 1)  # CTAs a cluster, as the scan is launched
_FWD_MAX_TILES = 4  # batch tiles of 16 rows the layer-by-layer path takes


def cluster_smem(H: int, n: int, dtype: torch.dtype) -> int:
    """Bytes of shared memory of one CTA of the cluster scan at H with n CTAs
    (csrc/lstm_stack.cu cluster_smem, cluster_tc_smem). f32: its slice of
    W_hh (H x 4H/n), h double-buffered (2, H, 16), the gates (16, 4H/n) and
    c (16, H/n), all f32. bf16 (the tensor-core step): the slice column by
    column and h (2, 16, ·) in bf16, each row padded to H + 8 values, then
    the gates and c in f32."""
    u = H // n
    if dtype == torch.bfloat16:
        return 2 * (4 * u + 2 * _CLUSTER_ROWS) * (H + 8) + 4 * _CLUSTER_ROWS * 5 * u
    return 4 * (H * 4 * u + _CLUSTER_ROWS * (2 * H + 5 * u))


def cluster_sizes(H: int, dtype: torch.dtype) -> Tuple[int, ...]:
    """The cluster sizes n the scan can run H at: n divides H, a CTA's 2H/n
    column pairs fit its 256 threads, its shared memory fits one H100 block,
    and in bf16 the tensor-core step's tiles fit (H a multiple of 16, H/n
    even). At H = 384: 16 and 8 in bf16, 16 in f32."""
    return tuple(n for n in _CLUSTER_SIZES
                 if H % n == 0 and 2 * H // n <= 256 and cluster_smem(H, n, dtype) <= _MAX_SMEM
                 and (dtype != torch.bfloat16 or (H % 16 == 0 and H // n % 2 == 0)))


def pick_fwd(B: int, C: int, H: int, L: int, dtype: torch.dtype) -> int:
    """Which forward K1 and K4 run where the wavefront forward does not
    (`fwd_path`): the cluster size n of the layer-by-layer path (input
    product, then the recurrence on clusters of n CTAs), or 0 for
    `lstm_fwd_kernel`, the whole stack in one launch.

    The layer-by-layer path takes batches of at most 4 tiles of 16 rows
    (B <= 64): its f32 input product is T·B·4H floats a layer (45 MB at the
    encoder's B = 16, 723 MB at B = 1024, H = 96), and its clusters, n SMs
    each, must fit the card's 132 SMs at once. Of the sizes H fits
    (`cluster_sizes`), from timings on an H100 at T = 460, B = 16 (PERF.md,
    `[fwd paths]`): in bf16 the tensor cores make a CTA's product short,
    and the cell, the hand-over of h and the barrier, which grow with the
    cluster, set the step, so the largest n that leaves each CTA at least
    12 hidden units (K4 at C 96, H 384: 2.22 ms at 16 CTAs, 2.74 at 8; at
    C 384, H 96: 1.06 ms at 8, 1.22 at 16, 1.34 at 4; the CLI's two H = 96
    layers 2.02 ms at 8, 2.38 at 16; `lstm_fwd_kernel` 32.96, 10.35 and
    8.74); in f32 the FMA product sets the step, so the largest n."""
    fits = [n for n in cluster_sizes(H, dtype) if dtype != torch.bfloat16 or H // n >= 12]
    tiles = -(-B // _CLUSTER_ROWS)
    if not fits or tiles > _FWD_MAX_TILES or tiles * fits[0] > _SMS:
        return 0
    return fits[0]


def _wave_cta_smem(C: int, H: int, ns: int, mt: int = 1) -> int:
    """Bytes of shared memory of one CTA of the wavefront forward with `ns`
    CTAs a layer and `mt` row tiles of 16 a cluster (csrc/lstm_stack.cu
    wave_smem)."""
    w, U, R = max(C, H), H // ns, _WAVE_ROWS * mt
    return (2 * (4 * U * (w + H + 8) + _WAVE_RING * R * (w + 8) + 2 * R * (H + 8))
            + 8 * (2 * _WAVE_RING + (2 if ns > 1 else 0)))


def wave_smem(C: int, H: int) -> int:
    """Bytes of shared memory of one CTA of the wavefront forward with a CTA
    a layer (csrc/lstm_stack.cu wave_smem): in bf16 a layer's [W_ih; W_hh]
    column by column, each of the 4H columns padded to max(C, H) + H + 8
    values, its input ring (4, 16, max(C, H) + 8) and h (2, 16, H + 8);
    then a "full" and an "empty" mbarrier (8 bytes) a ring slot."""
    return _wave_cta_smem(C, H, 1)


def wave_split_smem(C: int, H: int, mt: int = 1) -> int:
    """Bytes of shared memory of one CTA of the split layer with `mt` row
    tiles of 16 a cluster (csrc/lstm_stack.cu wave_smem): `wave_smem`'s
    buffers with the 2H columns of half the units in place of all 4H, the
    ring and h for 16 `mt` rows, and two more mbarriers, one an h buffer,
    on which the sibling's half of h lands. At the DINO-LSTM's C 96, H 128:
    157.6 KiB with one tile, 208.6 KiB with three; one CTA an SM."""
    return _wave_cta_smem(C, H, 2, mt)


def wave_fits(C: int, H: int, L: int, dtype: torch.dtype) -> bool:
    """Whether the wavefront forward can run a stack with a CTA a layer:
    bf16 streams (its products are bf16 mma.sync; f32 keeps the FMA
    kernels), C and H multiples of 16 (the products' k-steps), H/8 warps
    within the kernel's 384 threads (H <= 96), at most 8 layers (a portable
    cluster) and one layer's weights within a CTA's shared memory: 169.6
    KiB at the CLI's C = H = 96. Not the DINO-LSTM's H = 128 (289.5 KiB:
    `wave_split_fits`) or the autoencoder's widths (C 384, H 96: 421.5 KiB;
    H = 384)."""
    return (dtype == torch.bfloat16 and C % 16 == 0 and H % 16 == 0 and 4 * H <= 384
            and 1 <= L <= 8 and wave_smem(C, H) <= _MAX_SMEM)


def wave_split_fits(C: int, H: int, L: int, dtype: torch.dtype) -> bool:
    """Whether the wavefront forward can run a stack with the split layer,
    two CTAs a layer: bf16, C a multiple of 16 and H of 32 (each CTA's H/2
    units in warps of 8 and k-steps of 16), 2H threads within 384 (H <=
    192), at most 4 layers (8 CTAs, a portable cluster) and half a layer's
    weights within a CTA's shared memory (`wave_split_smem`). The
    DINO-LSTM's C 96, H 128, L 4; not the autoencoder's widths (C 384,
    H 96: 238.6 KiB; H = 384)."""
    return (dtype == torch.bfloat16 and C % 16 == 0 and H % 32 == 0 and 2 * H <= 384
            and 1 <= L <= 4 and wave_split_smem(C, H) <= _MAX_SMEM)


def split_tiles(B: int, clusters: Sequence[int]) -> int:
    """Row tiles of 16 a cluster of the split layer takes at batch B, given
    the clusters the card holds at once with 1, 2, ... tiles a cluster
    (`wave_clusters`; 0 where that many do not fit a CTA's shared memory):
    the fewest waves of clusters, then the fewest rows. A cluster's step
    costs more with more rows, but much less than in proportion: on an H100
    at the DINO-LSTM's widths (C 96, H 128, L 4, T = 300; 15 clusters of 8
    CTAs at once), one wave of K4 (B = 16) took 0.98-1.06 ms at 16 rows a
    cluster, 1.46-1.56 at 32 and 1.91-1.96 at 48, and B = 1024 (64 tiles
    of 16) 4.86-5.01 ms in 5 waves of 16 rows, 4.31-4.49 in 3 of 32 and
    3.81-3.99 in 2 of 48 (chip_smoke.py `[fwd paths]`, PERF.md §6)."""
    best = (0, 0)
    for mt, q in enumerate(clusters, 1):
        if q > 0:
            waves = -(-(-(-B // (_WAVE_ROWS * mt))) // q)
            if not best[1] or waves < best[0]:
                best = (waves, mt)
    if not best[1]:
        raise ValueError("no tile of the split layer fits the card")
    return best[1]


def fwd_path(B: int, C: int, H: int, L: int, dtype: torch.dtype, kind: str) -> str:
    """Which forward `kind` runs on the card: "wave" (the wavefront path, one
    launch, a CTA a layer), "split" (the wavefront path with two CTAs a
    layer), "cluster" (the layer-by-layer path, clusters of `pick_fwd`'s
    size) or "stack" (`lstm_fwd_kernel`). Every forward (K1 fwd_train, K3
    fwd_infer_last, K4 fwd_infer, K10 fwd_train_rc) takes the wavefront path
    where `wave_fits`, at every batch; K4 and K10 then the split layer where
    `wave_split_fits`; K1 and K4 then the layer-by-layer path where
    `pick_fwd` gives a cluster size; the rest `lstm_fwd_kernel`."""
    if kind in _WAVE_KINDS and wave_fits(C, H, L, dtype):
        return "wave"
    if kind in ("fwd_infer", "fwd_train_rc") and wave_split_fits(C, H, L, dtype):
        return "split"
    if kind in ("fwd_train", "fwd_infer") and pick_fwd(B, C, H, L, dtype):
        return "cluster"
    return "stack"


def scan_tile(B: int, H: int, dtype: torch.dtype) -> int:
    """Batch rows per CUDA block of the reverse scan (each layer of K2/K2g,
    each chunk and layer of K11, and K14). The scan sums no dW, so its rows
    per block only trade a block's step time against the number of blocks
    and the blocks the card holds at once: the fewest rows (1 to 8) whose
    blocks all fit in one wave, where a SM holds as many blocks (at most 2)
    as its shared memory takes (w_hhᵀ, 4H·H values, where it fits beside
    the carries, and 9 BT·H floats of carries). On an H100 (PERF.md, T =
    460) one row a block was fastest at B = 16, and at B = 1024, H = 96,
    four rows in bf16 (256 blocks, two a SM beside w_hhᵀ's 72 KiB) and
    eight in f32 (128 blocks, one a SM beside its 144 KiB); at H = 128 in
    bf16 (128 KiB) the rule takes eight. Raises if one row's carries
    overflow shared memory."""
    if 36 * H > _MAX_SMEM:
        raise ValueError(f"H={H}: the scan's carries exceed one block's shared memory")
    w = 4 * H * H * dtype.itemsize
    bt = 1
    for bt in (1, 2, 4, 8):
        carries = 36 * bt * H
        if carries > _MAX_SMEM:
            return bt // 2
        smem = carries + (w if carries + w <= _MAX_SMEM else 0)
        # the SM keeps 1 KiB of each block's shared memory for itself
        if -(-B // bt) <= _SMS * max(1, min(2, _SM_SMEM // (smem + 1024))):
            return bt
    return bt


def _row_splits(rows: int, cols: int, K: int) -> int:
    """Row chunks of one dW contraction over K rows into a (rows, cols)
    output of 64 x 64 tiles: enough blocks for two waves of the card's SMs,
    and chunks of at most 4096 rows, which keeps each f32 sum short; at
    least 32 rows a chunk, at most 256 chunks."""
    tiles = -(-rows // 64) * -(-cols // 64)
    want = max(-(-2 * _SMS // tiles), -(-K // 4096))
    return max(1, min(want, 256, -(-K // 32)))


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


def _fwd_cuda(x, layers, kind: str, tile=None):
    """K1 (`kind` fwd_train), K3 (fwd_infer_last), K4 (fwd_infer) or K10
    (fwd_train_rc)."""
    T, B, C, H, L = _dims(x, layers)
    tile = tile or pick_tile(B, C, H, L)
    w_ih0, w_ihr, w_hh, b = _packed(layers, H)
    _cuda_checks(tile, x, w_ih0, w_ihr, w_hh, b)
    lib = _lib()
    h_all = prefac = qf = c_all = out = None
    if kind in ("fwd_train", "fwd_train_rc"):
        h_all = torch.empty(L, T, B, H, dtype=x.dtype, device=x.device)
        if kind == "fwd_train":
            prefac = torch.empty(L, T, B, 4 * H, dtype=x.dtype, device=x.device)
            qf = torch.empty(L, T, B, 2 * H, dtype=x.dtype, device=x.device)
        else:
            c_all = torch.empty_like(h_all)
    else:
        out = torch.empty((B, H) if kind == "fwd_infer_last" else (T, B, H),
                          dtype=x.dtype, device=x.device)
    rc = lib.cerebra_lstm_fwd(
        _FWD_MODES[kind], int(x.dtype == torch.bfloat16), tile,
        x.data_ptr(), w_ih0.data_ptr(), w_ihr.data_ptr() or None, w_hh.data_ptr(),
        b.data_ptr(), ptr(h_all), ptr(prefac), ptr(qf), ptr(c_all), ptr(out), T, B, C, H, L,
        stream_of(x),
    )
    check_rc(lib, rc, kind)
    LAUNCHES[kind] += 1
    count_shape(kind, B, T)
    if kind == "fwd_train":
        return h_all, prefac, qf
    return (h_all, c_all) if kind == "fwd_train_rc" else out


def _in_product_cuda(inp, w_ih, out=None):
    """One layer's input product on the card (`fwd_in_product`): P (T, B, 4H)
    f32 into `out`, allocated when None."""
    T, B, in_dim = inp.shape
    G, sd = w_ih.shape[1], inp.dtype
    if tuple(w_ih.shape) != (in_dim, G) or w_ih.dtype != sd or sd not in _STREAM_DTYPES:
        raise ValueError("inp and w_ih do not match one layer")
    P = torch.empty(T, B, G, dtype=torch.float32, device=inp.device) if out is None else out
    _cuda_checks(1, inp, w_ih, P)
    lib = _lib()
    rc = lib.cerebra_fwd_in_product(int(sd == torch.bfloat16), inp.data_ptr(), w_ih.data_ptr(),
                                    P.data_ptr(), T * B, in_dim, G // 4, stream_of(inp))
    check_rc(lib, rc, "fwd_in_product")
    LAUNCHES["fwd_in_product"] += 1
    return P


def _cluster_scan_cuda(P, w_hh, b, n: int, h=None, prefac=None, qf=None, res: bool = False):
    """One layer's recurrence over its input product on the card
    (`fwd_cluster_scan`) in clusters of n CTAs: h (T, B, H) and, with `res`,
    prefac and qf, each written where given, else allocated. A cluster the
    card refuses raises. → (h, prefac, qf)."""
    T, B, G = P.shape
    H, sd, dev = G // 4, w_hh.dtype, P.device
    if (P.dtype != torch.float32 or tuple(w_hh.shape) != (H, G) or tuple(b.shape) != (G,)
            or b.dtype != sd or sd not in _STREAM_DTYPES):
        raise ValueError("P, w_hh or b do not match one layer")
    if n < 1 or H % n:
        raise ValueError(f"a cluster of {n} CTAs does not split H={H} units")
    h = torch.empty(T, B, H, dtype=sd, device=dev) if h is None else h
    if not res:
        prefac = qf = None
    else:
        prefac = torch.empty(T, B, G, dtype=sd, device=dev) if prefac is None else prefac
        qf = torch.empty(T, B, 2 * H, dtype=sd, device=dev) if qf is None else qf
    _cuda_checks(1, P, w_hh, b, h, prefac, qf)
    lib = _lib()
    rc = lib.cerebra_fwd_cluster_scan(
        int(sd == torch.bfloat16), int(res), n, P.data_ptr(), w_hh.data_ptr(), b.data_ptr(),
        h.data_ptr(), ptr(prefac), ptr(qf), T, B, H, stream_of(P))
    check_rc(lib, rc, "fwd_cluster_scan")
    LAUNCHES["fwd_cluster_scan"] += 1
    return h, prefac, qf


def _fwd_cluster_cuda(x, layers, kind: str, n: int):
    """K1 (`kind` fwd_train) or K4 (fwd_infer) on the card as
    `_fwd_layerwise`, with clusters of n CTAs: one f32 P buffer for every
    layer, and for K4 one scratch h for the layers below the top (stream
    order makes both safe: a layer's product has read the layer below's h
    before its scan writes)."""
    T, B, C, H, L = _dims(x, layers)
    sd, dev, G = x.dtype, x.device, 4 * H
    layers = [tuple(w.contiguous() for w in layer) for layer in layers]
    _cuda_checks(1, x)
    P = torch.empty(T, B, G, dtype=torch.float32, device=dev)
    train = kind == "fwd_train"
    if train:
        h_all = torch.empty(L, T, B, H, dtype=sd, device=dev)
        prefac = torch.empty(L, T, B, G, dtype=sd, device=dev)
        qf = torch.empty(L, T, B, 2 * H, dtype=sd, device=dev)
    else:
        out = torch.empty(T, B, H, dtype=sd, device=dev)
        below = torch.empty(T, B, H, dtype=sd, device=dev) if L > 1 else None

    def scan(l, P_, w_hh, b):
        if train:
            return _cluster_scan_cuda(P_, w_hh, b, n, h_all[l], prefac[l], qf[l], True)[0]
        return _cluster_scan_cuda(P_, w_hh, b, n, out if l == L - 1 else below)[0]

    top = _fwd_layerwise(x, layers, lambda inp, w_ih: _in_product_cuda(inp, w_ih, P), scan)
    LAUNCHES[kind] += 1
    count_shape(kind, B, T)
    return (h_all, prefac, qf) if train else top


def _fwd_wave_cuda(x, layers, kind: str, split: bool = False, mt=None):
    """K1 (`kind` fwd_train), K3 (fwd_infer_last), K10 (fwd_train_rc) or K4
    (fwd_infer) on the card on the wavefront path (`fwd_wave`), with
    `split` on its split layer (`fwd_wave_split`) in clusters of `mt` row
    tiles (default `split_tiles`'s): one launch, no input product in
    memory."""
    T, B, C, H, L = _dims(x, layers)
    fits = wave_split_fits if split else wave_fits
    if kind not in _WAVE_KINDS or not fits(C, H, L, x.dtype):
        raise ValueError(f"the wavefront forward{' (split)' if split else ''} does not run {kind} "
                         f"at C={C}, H={H}, L={L}, {x.dtype}")
    if mt is None:
        mt = wave_split_tiles(B, C, H, L) if split else 1
    if mt not in range(1, (_WAVE_SPLIT_TILES if split else 1) + 1) or (
            split and wave_split_smem(C, H, mt) > _MAX_SMEM):
        raise ValueError(f"the wavefront forward does not take {mt} row tiles a cluster here")
    w_ih0, w_ihr, w_hh, b = _packed(layers, H)
    _cuda_checks(1, x, w_ih0, w_ihr, w_hh, b)
    if x.data_ptr() % 16:  # layer 0 copies x 16 bytes at a time
        x = x.clone()
    sd, dev = x.dtype, x.device
    h_all = prefac = qf = c_all = out = None
    if kind in ("fwd_train", "fwd_train_rc"):
        h_all = torch.empty(L, T, B, H, dtype=sd, device=dev)
        if kind == "fwd_train":
            prefac = torch.empty(L, T, B, 4 * H, dtype=sd, device=dev)
            qf = torch.empty(L, T, B, 2 * H, dtype=sd, device=dev)
        else:
            c_all = torch.empty_like(h_all)
    else:
        out = torch.empty((B, H) if kind == "fwd_infer_last" else (T, B, H), dtype=sd, device=dev)
    lib = _lib()
    rc = lib.cerebra_fwd_wave(
        _FWD_MODES[kind], int(split), mt, x.data_ptr(), w_ih0.data_ptr(), w_ihr.data_ptr() or None,
        w_hh.data_ptr(), b.data_ptr(), ptr(h_all), ptr(prefac), ptr(qf), ptr(c_all), ptr(out),
        T, B, C, H, L, stream_of(x))
    name = "fwd_wave_split" if split else "fwd_wave"
    check_rc(lib, rc, name)
    LAUNCHES[name] += 1
    LAUNCHES[kind] += 1
    count_shape(kind, B, T)
    if kind == "fwd_train":
        return h_all, prefac, qf
    return (h_all, c_all) if kind == "fwd_train_rc" else out


@functools.lru_cache(maxsize=None)
def wave_clusters(C: int, H: int, L: int, split: bool = False, mt: int = 1) -> int:
    """Clusters of the wavefront forward (with `split`, its split layer, `mt`
    row tiles a cluster) the card holds at once at (C, H, L)
    (cudaOccupancyMaxActiveClusters, asked once a process): a batch of more
    tiles runs in more than one wave."""
    lib = _lib()
    n = lib.cerebra_fwd_wave_clusters(int(split), mt, C, H, L)
    if n < 0:
        check_rc(lib, -n, "fwd_wave occupancy")
    return n


def wave_split_tiles(B: int, C: int, H: int, L: int) -> int:
    """`split_tiles` at batch B on this card: the row tiles a cluster of the
    split layer takes at (C, H, L), from the clusters the card holds at
    once with each tile count whose shared memory fits."""
    return split_tiles(B, [wave_clusters(C, H, L, True, m)
                           if wave_split_smem(C, H, m) <= _MAX_SMEM else 0
                           for m in range(1, _WAVE_SPLIT_TILES + 1)])


def _fwd_dispatch(x, layers, kind: str, tile):
    """K1, K3, K4 or K10 on the card by `fwd_path`'s rule: the wavefront
    path (a CTA or two a layer), the layer-by-layer path or
    `lstm_fwd_kernel` with `tile` rows a block (default `pick_tile`)."""
    T, B, C, H, L = _dims(x, layers)
    if tile is not None and tile not in _TILES:
        raise ValueError(f"tile must be one of {_TILES}, got {tile}")
    path = fwd_path(B, C, H, L, x.dtype, kind)
    if path in ("wave", "split"):
        return _fwd_wave_cuda(x, layers, kind, path == "split")
    if path == "cluster":
        return _fwd_cluster_cuda(x, layers, kind, pick_fwd(B, C, H, L, x.dtype))
    return _fwd_cuda(x, layers, kind, tile)


def _scan_cuda(g, prefac, qf, w_hh, tile=None, out=None):
    """The reverse scan of one layer on the card (`bwd_scan`); `out` is the
    (T, B, 4H) dgates buffer to write, allocated when None."""
    T, B, G = prefac.shape
    H = G // 4
    sd = prefac.dtype
    if (tuple(g.shape) not in ((T, B, H), (B, H)) or g.dtype not in (sd, torch.float32)
            or tuple(qf.shape) != (T, B, 2 * H) or tuple(w_hh.shape) != (H, G)
            or qf.dtype != sd or w_hh.dtype != sd):
        raise ValueError("cotangent, residuals or w_hh do not match one layer")
    tile = tile or scan_tile(B, H, sd)
    w_hhT = w_hh.t().contiguous()
    dgates = torch.empty(T, B, G, dtype=sd, device=prefac.device) if out is None else out
    _cuda_checks(tile, g, prefac, qf, dgates)
    lib = _lib()
    rc = lib.cerebra_stack_scan_bwd(
        int(sd == torch.bfloat16), int(g.dtype == torch.float32), int(g.dim() == 2), tile,
        prefac.data_ptr(), qf.data_ptr(), g.data_ptr(), w_hhT.data_ptr(), dgates.data_ptr(),
        T, B, H, stream_of(prefac),
    )
    check_rc(lib, rc, "stack_bwd_scan")
    LAUNCHES["stack_bwd_scan"] += 1
    return dgates


def _scratch_floats(in_dim: int, H: int, T: int, B: int) -> int:
    """f32 scratch of one layer's products: the larger dW's split partials,
    or the 32 chunks of db."""
    G = 4 * H
    return G * max(_row_splits(in_dim, G, T * B) * in_dim,
                   _row_splits(H, G, (T - 1) * B) * H, 32)


def _products_cuda(dgates, inp, h, w_ih, chain=None, dws=None, out=None, scratch=None):
    """One layer's products on the card (`bwd_products`). `dws` (dW_ih,
    dW_hh, db), `out` (the chain's output) and `scratch` are the f32
    buffers to write, allocated when None."""
    T, B, G = dgates.shape
    H = G // 4
    in_dim = inp.shape[-1]
    sd, dev = dgates.dtype, dgates.device
    if (tuple(inp.shape) != (T, B, in_dim) or tuple(h.shape) != (T, B, H)
            or tuple(w_ih.shape) != (in_dim, G)
            or any(t.dtype != sd for t in (inp, h, w_ih)) or chain not in (None, "gup", "dx")):
        raise ValueError("dgates, inputs or w_ih do not match one layer")
    if dws is None:
        dws = (torch.empty(in_dim, G, device=dev), torch.empty(H, G, device=dev),
               torch.empty(G, device=dev))
    if out is None and chain is not None:
        out = torch.empty(T, B, in_dim, dtype=torch.float32 if chain == "gup" else sd,
                          device=dev)
    if scratch is None:
        scratch = torch.empty(_scratch_floats(in_dim, H, T, B), device=dev)
    _cuda_checks(1, dgates, inp, h, w_ih, out, *dws)
    lib = _lib()
    rc = lib.cerebra_stack_bwd_products(
        int(sd == torch.bfloat16), dgates.data_ptr(), inp.data_ptr(), in_dim, h.data_ptr(),
        w_ih.data_ptr(), {None: 0, "gup": 1, "dx": 2}[chain], ptr(out), dws[0].data_ptr(),
        dws[1].data_ptr(), dws[2].data_ptr(), scratch.data_ptr(),
        _row_splits(in_dim, G, T * B), _row_splits(H, G, (T - 1) * B), T, B, H,
        stream_of(dgates),
    )
    check_rc(lib, rc, "stack_bwd_products")
    LAUNCHES["stack_bwd_products"] += 1
    return (*dws, out)


def _bwd_cuda(g, x, layers, h_all, prefac, qf, need_dx: bool, tile=None):
    """K2/K2g on the card: `_bwd_layerwise` with the CUDA scan and products,
    writing dW and db straight into one flat f32 buffer laid out as
    [dW_ih0 | dW_ihr | dW_hh | db], and reusing one dgates and one f32 chain
    buffer from layer to layer (stream order makes that safe: a layer's
    scan starts after the products of the layer above have read dgates)."""
    T, B, C, H, L = _dims(x, layers)
    g_full = g.dim() == 3
    if (tuple(g.shape) != ((T, B, H) if g_full else (B, H)) or g.dtype != x.dtype
            or tuple(h_all.shape) != (L, T, B, H) or tuple(prefac.shape) != (L, T, B, 4 * H)
            or tuple(qf.shape) != (L, T, B, 2 * H)):
        raise ValueError("cotangent or residuals do not match the stack")
    tile = tile or scan_tile(B, H, x.dtype)
    _cuda_checks(tile, g, x, h_all, prefac, qf)
    G, dev = 4 * H, x.device
    flat = torch.empty(G * (C + (L - 1) * H + L * H + L), dtype=torch.float32, device=dev)
    dws = _unpack_grads(flat, C, H, L)
    dgates = torch.empty(T, B, G, dtype=x.dtype, device=dev)
    outs = {"gup": torch.empty(T, B, H, dtype=torch.float32, device=dev) if L > 1 else None,
            "dx": torch.empty(T, B, C, dtype=x.dtype, device=dev) if need_dx else None}
    scratch = torch.empty(max(_scratch_floats(C, H, T, B), _scratch_floats(H, H, T, B)),
                          dtype=torch.float32, device=dev)

    def scan(cot, prefac_l, qf_l, w_hh):
        return _scan_cuda(cot, prefac_l, qf_l, w_hh, tile, dgates)

    def products(l, dg, inp, h, w_ih, chain):
        return _products_cuda(dg, inp, h, w_ih.contiguous(), chain, dws[l], outs.get(chain),
                              scratch)

    result = _bwd_layerwise(g, x, layers, h_all, prefac, qf, need_dx, scan, products)
    kind = "bwd_general" if g_full or need_dx else "bwd"
    LAUNCHES[kind] += 1
    count_shape(kind, B, T)
    return result


def _rc_gates_cuda(inp, h_prev, w_ih, w_hh, b, out=None, cat=None):
    """One chunk's gate recompute on the card (`rc_gates`): one product of
    [inp | h_prev] (copied into `cat`, (n, B, in + H), allocated when None)
    and [W_ih; W_hh], into `out` (n, B, 4H) f32, allocated when None."""
    n, B, in_dim = inp.shape
    H = w_hh.shape[0]
    G, sd = 4 * H, inp.dtype
    if (tuple(h_prev.shape) != (n, B, H) or tuple(w_ih.shape) != (in_dim, G)
            or tuple(w_hh.shape) != (H, G) or tuple(b.shape) != (G,)
            or any(t.dtype != sd for t in (h_prev, w_ih, w_hh, b)) or sd not in _STREAM_DTYPES):
        raise ValueError("inputs, h_prev or weights do not match one chunk of a layer")
    out = torch.empty(n, B, G, dtype=torch.float32, device=inp.device) if out is None else out
    cat = torch.cat([inp, h_prev], -1, out=cat)
    w = torch.cat([w_ih, w_hh])
    _cuda_checks(1, cat, w, b, out)
    lib = _lib()
    rc = lib.cerebra_rc_gates(int(sd == torch.bfloat16), cat.data_ptr(), w.data_ptr(),
                              b.data_ptr(), out.data_ptr(), n * B, in_dim + H, H, stream_of(inp))
    check_rc(lib, rc, "rc_gates")
    LAUNCHES["rc_gates"] += 1
    return out


def _rc_scan_cuda(g, gates, c, c_prev, w_hh, carry, tile=None, out=None):
    """One chunk's reverse scan on the card (`rc_scan`), forming K11's
    residuals from the f32 gates (n, B, 4H) and c, c_prev (n, B, H) as it
    goes, with the layer's f32 (2, B, H) carry read and overwritten; into
    `out` (n, B, 4H) dgates, allocated when None."""
    n, B, H = c.shape
    G, sd, f32 = 4 * H, c.dtype, torch.float32
    if (tuple(g.shape) != (n, B, H) or g.dtype not in (sd, f32)
            or tuple(gates.shape) != (n, B, G) or gates.dtype != f32
            or c_prev.shape != c.shape or c_prev.dtype != sd or sd not in _STREAM_DTYPES
            or tuple(w_hh.shape) != (H, G) or w_hh.dtype != sd
            or tuple(carry.shape) != (2, B, H) or carry.dtype != f32):
        raise ValueError("cotangent, gates, c, w_hh or carry do not match one chunk of a layer")
    tile = tile or scan_tile(B, H, sd)
    w_hhT = w_hh.t().contiguous()
    dgates = torch.empty(n, B, G, dtype=sd, device=c.device) if out is None else out
    _cuda_checks(tile, g, gates, c, c_prev, carry, dgates)
    lib = _lib()
    rc = lib.cerebra_rc_scan(
        int(sd == torch.bfloat16), int(g.dtype == f32), tile, gates.data_ptr(), c.data_ptr(),
        c_prev.data_ptr(), g.data_ptr(), w_hhT.data_ptr(), carry.data_ptr(), dgates.data_ptr(),
        n, B, H, stream_of(c),
    )
    check_rc(lib, rc, "rc_scan")
    LAUNCHES["rc_scan"] += 1
    return dgates


def _sub_rows(rows: int) -> int:
    """Rows of one block's share of a dW group: the fewest of at least 512
    (16 of the products' 32-row steps) that divide the group, so a chunk of
    32 steps at B = 1024 gives each dW contraction 64 row blocks, several
    on each SM; the whole group where it is shorter."""
    k = max(1, rows // 512)
    while rows % k:
        k -= 1
    return rows // k


def _rc_products_cuda(dgates, inp, h_prev, w_ih, chain, rows: int, part=None, out=None,
                      sub=None):
    """One chunk's products on the card (`rc_products`): dW partials per
    group of `rows` rows into `part`, the chain into `out`, by way of the
    f32 scratch `sub` (the sub-groups' partials); each allocated when None.
    → (part, chain)."""
    n, B, G = dgates.shape
    H, in_dim, sd = G // 4, inp.shape[-1], dgates.dtype
    width, r_sub = (in_dim + H + 1) * G, _sub_rows(rows)
    groups = -(-n * B // rows)
    if (tuple(inp.shape) != (n, B, in_dim) or tuple(h_prev.shape) != (n, B, H)
            or tuple(w_ih.shape) != (in_dim, G) or any(t.dtype != sd for t in (inp, h_prev, w_ih))
            or chain not in (None, "gup", "dx")):
        raise ValueError("dgates, inputs or w_ih do not match one chunk of a layer")
    dev = dgates.device
    if part is None:
        part = torch.empty(groups, width, dtype=torch.float32, device=dev)
    if sub is None:
        sub = torch.empty(-(-n * B // r_sub) * width, dtype=torch.float32, device=dev)
    if tuple(part.shape) != (groups, width) or sub.numel() < -(-n * B // r_sub) * width:
        raise ValueError(f"part must be ({groups}, {width}) for this chunk, with room in sub")
    if out is None and chain is not None:
        out = torch.empty(n, B, in_dim, dtype=torch.float32 if chain == "gup" else sd,
                          device=dev)
    _cuda_checks(1, dgates, inp, h_prev, w_ih, part, sub, out)
    lib = _lib()
    rc = lib.cerebra_rc_products(
        int(sd == torch.bfloat16), dgates.data_ptr(), inp.data_ptr(), in_dim, h_prev.data_ptr(),
        w_ih.data_ptr(), {None: 0, "gup": 1, "dx": 2}[chain], ptr(out), part.data_ptr(),
        sub.data_ptr(), n * B, rows, r_sub, H, stream_of(dgates),
    )
    check_rc(lib, rc, "rc_products")
    LAUNCHES["rc_products"] += 1
    return part, out


def _sum_partials_cuda(part):
    """part (groups, n) f32 summed over the groups in order, on the card."""
    out = torch.empty(part.shape[1], dtype=torch.float32, device=part.device)
    lib = _lib()
    rc = lib.cerebra_sum_partials(part.data_ptr(), out.data_ptr(), part.shape[0], part.shape[1],
                                  stream_of(part))
    check_rc(lib, rc, "bwd_rc")
    return out


def _bwd_rc_cuda(g, x, layers, h_all, c_all, tile=None, chunk=None, group=None):
    """K11 on the card: `_bwd_rc_chunked` with the CUDA pieces, reusing one
    chunk's buffers from chunk to chunk and layer to layer (stream order
    makes that safe), the dgates in the f32 gates' memory (the residual
    pass has read the gates before the scan writes dgates). `tile` is the
    scan's rows per block (default `scan_tile`), `chunk` and `group` the
    steps of a time chunk and of a dW group (default `rc_chunk`,
    `rc_group`)."""
    T, B, C, H, L = _dims(x, layers)
    sd, dev, G = x.dtype, x.device, 4 * H
    if (tuple(g.shape) != (T, B, H) or g.dtype != sd
            or any(tuple(r.shape) != (L, T, B, H) or r.dtype != sd for r in (h_all, c_all))):
        raise ValueError("cotangent or residuals do not match the stack")
    tile = tile or scan_tile(B, H, sd)
    _cuda_checks(tile, g, x, h_all, c_all)
    group = group or rc_group(B)
    chunk = chunk or rc_chunk(T, B, group)
    n = min(chunk, T)
    gates = torch.empty(n, B, G, dtype=torch.float32, device=dev)
    dgates = torch.empty(n, B, G, dtype=sd, device=dev)
    gup = torch.empty(n, B, H, dtype=torch.float32, device=dev) if L > 1 else None
    cat = torch.empty(n * B * (max(C, H) + H), dtype=sd, device=dev)
    sub = torch.empty(-(-n * B // _sub_rows(group * B)) * (max(C, H) + H + 1) * G,
                      dtype=torch.float32, device=dev)

    def gates_of(inp, h_prev, w_ih, w_hh, b):
        k, width = inp.shape[0], inp.shape[-1] + H
        return _rc_gates_cuda(inp, h_prev, w_ih, w_hh, b, gates[:k],
                              cat[:k * B * width].view(k, B, width))

    def products(dg, inp, h_prev, w_ih, chain, rows, part, out):
        k = dg.shape[0]
        return _rc_products_cuda(dg, inp, h_prev, w_ih, chain, rows, part,
                                 gup[:k] if out is None else out, sub)

    pieces = _RcPieces(
        gates_of,
        lambda cot, gt, c, c_prev, w_hh, carry: _rc_scan_cuda(cot, gt, c, c_prev, w_hh, carry,
                                                              tile, dgates[:c.shape[0]]),
        products, _sum_partials_cuda)
    layers = [tuple(w.contiguous() for w in layer) for layer in layers]
    result = _bwd_rc_chunked(g, x, layers, h_all, c_all, chunk, group, pieces)
    LAUNCHES["bwd_rc"] += 1
    return result


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
def _weights(layers: Layers):
    return [w for layer in layers for w in layer]


def fwd_train(x: torch.Tensor, layers: Layers, tile=None):
    """K1 on CUDA, its plain version on the CPU → (h_all, prefac, qf). On the
    card `fwd_path` chooses the path; `tile` is `lstm_fwd_kernel`'s rows a
    block where that path runs."""
    if on_cuda(x, *_weights(layers)):
        return _fwd_dispatch(x, layers, "fwd_train", tile)
    return _fwd_train_ref(x, layers)


def fwd_infer_last(x: torch.Tensor, layers: Layers, tile=None) -> torch.Tensor:
    """K3 on CUDA, its plain version on the CPU → h[T−1] of the top layer.
    On the card `fwd_path` chooses the path, as for `fwd_train`."""
    if on_cuda(x, *_weights(layers)):
        return _fwd_dispatch(x, layers, "fwd_infer_last", tile)
    return _fwd_infer_last_ref(x, layers)


def fwd_infer(x: torch.Tensor, layers: Layers, tile=None) -> torch.Tensor:
    """K4 on CUDA, its plain version on the CPU → the top layer's h (T, B, H).
    On the card `fwd_path` chooses the path, as for `fwd_train`."""
    if on_cuda(x, *_weights(layers)):
        return _fwd_dispatch(x, layers, "fwd_infer", tile)
    return _fwd_infer_ref(x, layers)


def fwd_in_product(inp: torch.Tensor, w_ih: torch.Tensor) -> torch.Tensor:
    """One layer's input product of K1/K4's layer-by-layer path on CUDA, its
    plain version on the CPU → P (T, B, 4H) f32 = inp·W_ih."""
    if on_cuda(inp, w_ih):
        return _in_product_cuda(inp, w_ih)
    return _in_product_ref(inp, w_ih)


def fwd_cluster_scan(P: torch.Tensor, w_hh: torch.Tensor, b: torch.Tensor, res: bool = False,
                     n=None):
    """One layer's recurrence over its input product P (T, B, 4H) f32 on CUDA,
    in clusters of n CTAs (default: `pick_fwd`'s at this B and H), its plain
    version on the CPU → (h (T, B, H), and with `res` K1's prefac and qf,
    else None, None)."""
    if on_cuda(P, w_hh, b):
        T, B, G = P.shape
        n = n or pick_fwd(B, G // 4, G // 4, 1, w_hh.dtype)
        if not n:
            raise ValueError(f"B={B}, H={G // 4}: no cluster of the scan takes this shape")
        return _cluster_scan_cuda(P, w_hh, b, n, res=res)
    return _fwd_scan_ref(P, w_hh, b, res)


def bwd(g, x, layers: Layers, h_all, prefac, qf, need_dx: bool = False, tile=None):
    """K2/K2g on CUDA (a reverse scan and the products per layer; `tile` is
    the scan's rows per block, default `scan_tile`), the plain version on
    the CPU → (dx or None, f32 (dW_ih, dW_hh, db) per layer); g is (B, H)
    at T−1 or (T, B, H)."""
    if on_cuda(g, x, h_all, prefac, qf, *_weights(layers)):
        return _bwd_cuda(g, x, layers, h_all, prefac, qf, need_dx, tile)
    return _bwd_ref(g, x, layers, h_all, prefac, qf, need_dx)


def bwd_scan(g, prefac, qf, w_hh, tile=None) -> torch.Tensor:
    """One layer's reverse scan, K2/K2g's serial part, on CUDA; its plain
    version on the CPU → dgates (T, B, 4H); g is the cotangent of the
    layer's h, (B, H) at T−1 or (T, B, H), in the stream dtype or f32."""
    if on_cuda(g, prefac, qf, w_hh):
        return _scan_cuda(g, prefac, qf, w_hh, tile)
    return _scan_bwd_ref(g, prefac, qf, w_hh)


def bwd_products(dgates, inp, h, w_ih, chain=None):
    """One layer's products of K2/K2g over all T·B rows on CUDA, the plain
    version on the CPU → (dW_ih, dW_hh, db, the chain to the layer below:
    f32 for `chain` "gup", in the stream dtype for "dx", or None)."""
    if on_cuda(dgates, inp, h, w_ih):
        return _products_cuda(dgates, inp, h, w_ih, chain)
    return _products_ref(dgates, inp, h, w_ih, chain)


def fwd_train_rc(x: torch.Tensor, layers: Layers, tile=None):
    """K10 on CUDA, its plain version on the CPU → (h_all, c_all). On the
    card `fwd_path` chooses the path, as for `fwd_train`."""
    if on_cuda(x, *_weights(layers)):
        return _fwd_dispatch(x, layers, "fwd_train_rc", tile)
    return _fwd_train_rc_ref(x, layers)


def bwd_rc(g, x, layers: Layers, h_all, c_all, tile=None):
    """K11 on CUDA (gate products, a reverse scan and products per
    time chunk and layer; `tile` is the scan's rows per block, default
    `scan_tile`), the plain version on the CPU → (dx, f32 (dW_ih, dW_hh, db)
    per layer); g is (T, B, H)."""
    if on_cuda(g, x, h_all, c_all, *_weights(layers)):
        return _bwd_rc_cuda(g, x, layers, h_all, c_all, tile)
    return _bwd_rc_ref(g, x, layers, h_all, c_all)


def rc_gates(inp, h_prev, w_ih, w_hh, b):
    """K11's gate recompute of one time chunk on CUDA, the plain version on
    the CPU → f32 gates (n, B, 4H); h_prev as `_rc_gates_ref`."""
    if on_cuda(inp, h_prev, w_ih, w_hh, b):
        return _rc_gates_cuda(inp, h_prev, w_ih, w_hh, b)
    return _rc_gates_ref(inp, h_prev, w_ih, w_hh, b)


def rc_scan(g, gates, c, c_prev, w_hh, carry, tile=None):
    """K11's reverse scan of one time chunk on CUDA, the plain version on the
    CPU → dgates (n, B, 4H); `carry` the layer's f32 (2, B, H) carries, read
    and overwritten."""
    if on_cuda(g, gates, c, c_prev, w_hh, carry):
        return _rc_scan_cuda(g, gates, c, c_prev, w_hh, carry, tile)
    return _rc_scan_ref(g, gates, c, c_prev, w_hh, carry)


def rc_products(dgates, inp, h_prev, w_ih, chain, rows: int, part=None, out=None):
    """K11's products of one time chunk on CUDA, the plain version on the CPU
    → (dW partials per group of `rows` rows, the chain or None)."""
    if on_cuda(dgates, inp, h_prev, w_ih, part, out):
        return _rc_products_cuda(dgates, inp, h_prev, w_ih, chain, rows, part, out)
    return _rc_products_ref(dgates, inp, h_prev, w_ih, chain, rows, part, out)


class _Stack(torch.autograd.Function):
    """The stack's top-layer h at every t (T, B, H), or at T−1 only (B, H)
    when `last`, with gradients for the weights and, when it requires grad,
    for x: the backward takes `need_dx` from whether x needs a gradient (the
    weight gradients are the same either way).
    `impl` is (forward-train, backward) — the dispatching wrappers, or the
    plain versions for timing them on the card; the forward's first
    residual is h_all, and the backward takes every residual and `need_dx`."""

    @staticmethod
    def forward(ctx, impl, last, x, *flat):
        layers = [flat[k:k + 3] for k in range(0, len(flat), 3)]
        res = impl[0](x, layers)
        ctx.impl, ctx.n_res = impl, len(res)
        ctx.save_for_backward(x, *res, *flat)
        # a copy: a view would hand out the saved residual
        return (res[0][-1, -1] if last else res[0][-1]).clone()

    @staticmethod
    def backward(ctx, g):
        x, *saved = ctx.saved_tensors
        res, flat = saved[:ctx.n_res], saved[ctx.n_res:]
        layers = [flat[k:k + 3] for k in range(0, len(flat), 3)]
        need_dx = ctx.needs_input_grad[2]
        dx, grads = ctx.impl[1](g.to(x.dtype).contiguous(), x, layers, *res, need_dx)
        # as _vjp_bwd casts dW to the weight dtype
        dws = [dw.to(w.dtype) for w, dw in zip(flat, [d for layer in grads for d in layer])]
        return (None, None, dx if need_dx else None, *dws)


def _stack(impl, infer, last: bool, x: torch.Tensor, layers: Layers) -> torch.Tensor:
    if torch.is_grad_enabled() and (x.requires_grad
                                    or any(w.requires_grad for w in _weights(layers))):
        return _Stack.apply(impl, last, x, *_weights(layers))
    return infer(x, layers)


def _rc(fwd, bwd_fn):
    """`_Stack`'s impl for the recompute pair: K11 emits dx whatever
    `need_dx` says, and `_Stack` drops it when x needs no gradient."""
    return fwd, lambda g, x, layers, h_all, c_all, need_dx: bwd_fn(g, x, layers, h_all, c_all)


def lstm_stack(x: torch.Tensor, layers: Layers) -> torch.Tensor:
    """The top layer's hidden states (T, B, H) of a time-major stack, in x's
    dtype (the contract of the Pallas `lstm_stack`).

    K1 forward and K2g backward when grad is enabled and x or a weight
    requires grad, K4 otherwise. An x that needs no gradient (data, or
    detached) drops dx from the backward, as the Pallas
    `lstm_stack_pallas_ndx` does."""
    return _stack((fwd_train, bwd), fwd_infer, False, x, layers)


def lstm_stack_last(x: torch.Tensor, layers: Layers) -> torch.Tensor:
    """The top layer's final hidden state (B, H) of a time-major stack.

    K1 forward and K2 backward (K2g when x requires grad) when grad is
    enabled and x or a weight requires grad, K3 otherwise."""
    return _stack((fwd_train, bwd), fwd_infer_last, True, x, layers)


def lstm_stack_rc(x: torch.Tensor, layers: Layers) -> torch.Tensor:
    """`lstm_stack` with the recompute backward (the Pallas
    `lstm_stack_pallas_rc`): K10 forward, which keeps only h and c per layer
    (2H a row instead of K1's 7H), and K11 backward, which recomputes the
    gates, when grad is enabled and x or a weight requires grad; K4
    otherwise. K11 always computes dx; x gets it only when it requires
    grad."""
    return _stack(_rc(fwd_train_rc, bwd_rc), fwd_infer, False, x, layers)


def lstm_stack_ref(x: torch.Tensor, layers: Layers) -> torch.Tensor:
    """`lstm_stack` through the plain versions on any device (for timing
    the kernels against them on the card)."""
    return _stack((_fwd_train_ref, _bwd_ref), _fwd_infer_ref, False, x, layers)


def lstm_stack_last_ref(x: torch.Tensor, layers: Layers) -> torch.Tensor:
    """`lstm_stack_last` through the plain versions on any device."""
    return _stack((_fwd_train_ref, _bwd_ref), _fwd_infer_last_ref, True, x, layers)


def lstm_stack_rc_ref(x: torch.Tensor, layers: Layers) -> torch.Tensor:
    """`lstm_stack_rc` through the plain versions on any device."""
    return _stack(_rc(_fwd_train_rc_ref, _bwd_rc_ref), _fwd_infer_ref, False, x, layers)
