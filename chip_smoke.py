"""Smoke run of the PyTorch/CUDA port on one GPU: build every kernel, hold
each against its plain PyTorch version, drive the ported trainers at full
width through the kernels, and time kernels and training steps.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device      nvidia-smi name and power limit, torch.version.cuda
  2. build       nvcc of cerebra_torch/csrc/{lstm_stack,lstm_scan,vit_attn,
                 vit_mlp}.cu, all started together, seconds each
  3. parity      K3, K1, K2 and K2's two pieces (each layer's reverse scan
                 and its products) against their plain versions, f32 and
                 bf16, at B = 1024, 16 and 13 (T = 460, C = H = 96, L = 2),
                 K3 at B = 960 in bf16, and K2 on K1's own residuals; in
                 bf16 K1 and K3 run the wavefront forward (`fwd_wave`
                 launches counted)
  4. main        `cerebra_torch.cli.lstm_distill_from_dinov2_train.main` on
                 the synthetic corpus (40 classes x 30 trials of (96, 512)),
                 bf16, batch 16, 6 epochs; launch counts cover every step,
                 K1 and the validation's K3 through the wavefront forward
  5. timing      each LSTM kernel against its plain version and the cuDNN
                 call that computes the same function at the main path's
                 shapes (K2 also split into its scans and its products; K1
                 and K3 beside `lstm_fwd_kernel` at the same shape), the
                 reverse scan's rows per block, and bench.py's step (filter,
                 crop, LSTM fwd/bwd, RMSprop) at B = 1024, kernels and plain
                 versions
  6. vit parity  K5/K6 (attention) and K7/K8 (MLP) against their plain
                 versions at the main_dino shapes (B = 16, N = 785; B = 32,
                 N = 145) and a ragged N = 37, f32 and f32-stream/bf16-compute,
                 with and without the drop-path scale (one sample dropped);
                 the value and every gradient
  7. main_dino   `cerebra_torch.cli.main_dino.main` at the full-width
                 defaults (ViT-S/8, out_dim 65536, 2 x 224 + 4 x 96 views,
                 batch 8, drop path 0.1, bf16) on 40 classes x 2 trials for
                 2 epochs (10 steps each); finite losses, log.txt, and every
                 step through K5-K8 in all 12 blocks
  8. vit timing  each ViT kernel against its plain version at the globals'
                 and the locals' shapes; `[mlp pieces]`: K7 and K8 split by
                 launch (torch.profiler) with their launches a call, each
                 product's device ms against its bound and cuBLAS torch.mm
                 on the same operands (a yardstick), K8's fused dh kernel
                 alone against its plain piece; `[vit pieces]`: K5 and K6 split by
                 launch (torch.profiler), each attention core alone (K5's
                 forward core, K6's dq and dk/dv cores) against its plain
                 piece (parity, time, bound), the dk/dv core's scores against
                 the forward's bit for bit, and SDPA's flash kernels on the
                 same q, k, v as a yardstick; ms/step and views/s of the
                 main_dino step through the kernels and the plain versions
                 (median of three windows), and `[dino profile]`: its device
                 time by half-block, the attention cores apart, the idle
                 share and the host's time by op
  9. ae parity   K4 and K2g (cotangent at T-1 or at every t, with and
                 without dx) against their plain versions at the recurrent
                 autoencoder's encoder (C 96, H 384) and decoder (C 384,
                 H 96) widths, B = 16 and 13, f32 and bf16; and every
                 gradient of RecurrentAutoencoder(460, 96, 384) for a loss on
                 both outputs, through the kernels and the plain versions
 10. ae train    10 RMSprop steps of `feature_distill_step` on that model
                 with `feature_matching_loss`, bf16, batch 16, on synthetic
                 (96, 512) trials cropped to [20, 480) against 384-d teacher
                 features, then one no-grad forward: finite losses, K1 twice
                 a step and K2g once (the loss reads only the encoded latent,
                 so only the encoder's backward runs: a cotangent at every
                 t, no dx), K4 twice in the forward, each K1 and K4 as one
                 input product and one cluster scan; ms/step, and K1, K4 and
                 K2g (its scan and products apart) against their plain
                 versions and cuDNN at both widths
 11. fwd paths   K1/K4's layer-by-layer path (the input product, then the
                 recurrence on a thread-block cluster) at the autoencoder's
                 widths, B = 16 and 13, f32 and bf16: K1 against its plain
                 version, and each piece alone at every cluster size the
                 width fits; `[fwd paths]`: K1, K3, K4 and K10 through
                 `lstm_fwd_kernel`, K1 and K4 through the layer-by-layer
                 path at each cluster size, and all four through the
                 wavefront forward and its split layer where they fit (K1
                 and K3 on the split: a record, not routed), at the shapes
                 that set `fwd_path` (both autoencoder widths and the CLI's
                 B = 16, bf16 and f32, the bench step's B = 1024 and the
                 validation's B = 960, bf16, and the DINO-LSTM's widths at
                 B = 1024 and 16, T = 300); the two pieces
                 alone against plain and the
                 library call at the encoder's width
 12. rc          K10/K11 (`lstm_stack_rc`, the recompute backward) and K4
                 against their plain versions, f32 and bf16, every output,
                 at C = H = 96, L = 2, T = 460 (B = 1024 and 13; in bf16
                 K10 and K4 on the wavefront forward) and the DINO-LSTM
                 backbone's C 96, H 128, L 4, T = 300 (B = 1024, 16 and 13;
                 in bf16 K10 and K4 on its split layer); K11's three
                 pieces (gate products, scans that form the residuals and
                 hand on carries, products) alone against their plain
                 versions over every
                 time chunk and layer at B = 1024; the lab's rcstack at
                 B = 1024, bf16, both shapes: ms and peak memory of the
                 gradient of sum h_top[T-1]^2 in x and the weights through
                 the shipped stack (K1 + K2g, K2g's scans and products
                 apart), the recompute stack and cuDNN; K10, K11 and K11's
                 pieces alone against plain and cuDNN; K11's ms and peak at
                 each time chunk (`[rc chunks]`); K10 and K4 beside
                 `lstm_fwd_kernel`; at both widths one grad call launches
                 K10 and K11 once (each piece once a chunk and layer), a
                 no-grad call K4, K10 and K4 on the wavefront forward
                 (`fwd_wave`, headline) or its split layer
                 (`fwd_wave_split`, DINO)
 13. scan        K12-K14 (`lstm_scan`, one layer over a precomputed x_proj)
                 and its two gradients against the plain versions at T =
                 460, H = 96, B = 1024, 16 and 13, f32 and bf16 (in bf16 K12
                 and K13 on the scan's wavefront forward, in f32 on
                 scan_fwd_kernel), and the library call (cuDNN nn.LSTM(4H,
                 H) with weight_ih = I over x_proj) against them in f32; in
                 bf16 the wavefront forward with one and with two CTAs a
                 tile against its plain composition (`_scan_wave_ref`) and
                 the plain versions, and K14 on its residuals; the lab's
                 baseline (forward, forward + backward of sum h_all) through
                 kernels and plain versions; each kernel alone against plain
                 and cuDNN; `[scan paths]`: K12 and K13 through
                 scan_fwd_kernel and the wavefront forward with one and two
                 CTAs a tile at B = 1024, 16 and 2048, bf16; in bf16 and in f32
                 one grad call launches K13 and K14 once, a no-grad call
                 K12, in bf16 both on the wavefront forward
                 (`scan_fwd_wave` or `scan_fwd_wave_split`)
Every timing line gives the kernel's ms, its plain version's, its bound (the
larger of its matrix-product operations over the H100's peak and its bytes,
each input read and each output written once, over 3.35 TB/s) and the ms of
the one PyTorch call that computes the same function, or none (the cuDNN
calls: the median of five windows, each logged with its spread). A `[phases]`
line after each phase gives its seconds. The line before the last is a JSON
object of per-kernel results; the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
T_RAW, T_LO, T_HI, C, H, L, F, N_CLASSES = 512, 20, 480, 96, 96, 2, 384, 40
T = T_HI - T_LO
SOURCE = "cerebra_torch/csrc/lstm_stack.cu"
REPLACES = {
    "fwd_train": "cerebra/models/pallas_lstm_stack.py:121",
    "bwd": "cerebra/models/pallas_lstm_stack.py:239",
    "fwd_infer_last": "cerebra/models/pallas_lstm_stack.py:755",
    "stack_bwd_scan": "cerebra/models/pallas_lstm_stack.py:282",
    "stack_bwd_products": "cerebra/models/pallas_lstm_stack.py:305",
}
# Tolerances of the LSTM kernels. f32 values by max-abs: both sides run the
# same f32 algebra and differ only in the order of the dot products. f32
# weight gradients and dx by relative Frobenius: sums of T*B terms in another
# order. Every bf16 output by relative Frobenius: a sum that lands the other
# side of a bf16 rounding moves that element by an ulp (2^-8 relative) and
# the recurrence carries it on. First set at 1e-4, 1e-4 and 2e-2, then
# tightened to 20x over what K1-K3 showed on an H100 (C = H = 96, L = 2: at
# most 2.4e-7, 4.3e-7, 1.5e-4). K4 and K2g at the autoencoder's widths show
# more (at most 1.2e-6, K4 at C 384 / H 96; 6.8e-7 and 1.3e-3, K2g's dx at
# C 96 / H 384): margins of 8x, 15x and 3.9x.
TOL_F32_ABS = 1e-5
TOL_F32_GRAD_REL = 1e-5
TOL_BF16_REL = 5e-3

VIT_SOURCES = {"vit_attn_fwd": "cerebra_torch/csrc/vit_attn.cu",
               "vit_attn_bwd": "cerebra_torch/csrc/vit_attn.cu",
               "vit_mlp_fwd": "cerebra_torch/csrc/vit_mlp.cu",
               "vit_mlp_bwd": "cerebra_torch/csrc/vit_mlp.cu"}
REPLACES.update({
    "vit_attn_fwd": "cerebra/models/pallas_vit_attn.py:80",
    "vit_attn_bwd": "cerebra/models/pallas_vit_attn.py:106",
    "vit_mlp_fwd": "cerebra/models/pallas_vit_mlp.py:118",
    "vit_mlp_bwd": "cerebra/models/pallas_vit_mlp.py:135",
})
D_VIT, H_VIT, F_VIT = 384, 6, 1536  # ViT-S
VIT_SHAPES = ((16, 785), (32, 145), (3, 37))  # (sequences, tokens): globals, locals, ragged
# Tolerances of the ViT kernels, for the reasons of the LSTM limits above: the
# same formulas and rounding points on both sides, sums in another order (dW
# sums over up to 12,560 rows; the bf16 products on the tensor cores), and a
# bf16 rounding that can land on the other side for one element. First set
# at 1e-4 / 1e-4 / 2e-2; an H100 showed at most 1.5e-5 (f32 values, K7,
# whose outputs reach ~10), 1.1e-6 (f32 gradients) and 6.3e-4 (bf16, K6
# dWqkv). f32 values keep 1e-4 (6.8x); the others were tightened to ~20x.
# With K5/K6's attention cores on mma.sync (ex2 and a per-row 1/l in the
# softmax) the worst case read 1.2e-6 (f32 values, K5), 1.1e-6 (f32
# gradients, K6 dg) and 6.3e-4 (bf16, K6 dWqkv); the cores alone at most
# 1.1e-4 (bf16, relative).
TOL_VIT = (1e-4, 2e-5, 1.5e-2)

# The recurrent autoencoder: 1-layer LSTMs at its encoder and decoder widths
# (C, H), L = 1, over T = 460; the LSTM tolerances hold for K4 and K2g.
AE_SHAPES = {"encoder": (96, 384), "decoder": (384, 96)}
E_AE, B_AE = 384, 16
# Tolerances of the full-width RecurrentAutoencoder(460, 96, 384), every
# gradient of a loss on both outputs, kernels against plain. Its bf16 chain
# (the decoder's dx over 460 repeated latents, summed, then 460 encoder
# steps) carries flipped roundings further than one kernel. On an H100 over
# five seeds the sound run read at most 6.7e-7 (f32) and 3.4e-3 (bf16);
# planted faults read, in bf16: one step of the decoder's dx dropped
# 2.7e-2, one batch row's dx dropped 0.23, the cotangent's first step
# dropped 2.3e-2; a half-ulp low bias on dx 7.2e-3, on dW_ih 5.2e-3;
# against the f32 plain versions (a precision control) 6.7e-3. In f32 every
# fault read 3.9e-3 or more. 5e-3 lies between the sound bf16 drift and the
# faults; the f32 check is the sharp one.
TOL_AE = (TOL_F32_ABS, 1e-5, 5e-3)
REPLACES.update({
    "fwd_infer": "cerebra/models/pallas_lstm_stack.py:196",
    "bwd_general": "cerebra/models/pallas_lstm_stack.py:239",
    # K1/K4's layer-by-layer path: the input's product and the recurrence
    # (h·W_hh and the cell) of the bodies at :121 and :196
    "fwd_in_product": "cerebra/models/pallas_lstm_stack.py:140",
    "fwd_cluster_scan": "cerebra/models/pallas_lstm_stack.py:141",
    # the wavefront forward: K1's body (:121) and, without residuals, K3's
    # (:755, the fwd_infer_last entry)
    "fwd_wave": "cerebra/models/pallas_lstm_stack.py:121",
})
# The shapes whose timings set fwd_path, (B, C, H, L, T): both autoencoder
# widths, the LSTM CLI's step, bench.py's step and the CLI's validation, and
# the DINO-LSTM backbone's widths (C 96, H 128, L 4) over its 300-sample
# crops at the bench batch and the CLI's 16.
FWD_SHAPES = ((B_AE, *AE_SHAPES["encoder"], 1, T), (B_AE, *AE_SHAPES["decoder"], 1, T),
              (16, C, H, L, T), (1024, C, H, L, T), (960, C, H, L, T), (1024, 96, 128, 4, 300),
              (16, 96, 128, 4, 300))

# The recompute-backward stack (K10, K11) at the headline Perils widths and
# at the DINO-LSTM backbone's depth and width (lstm_distillation's
# Model(96, 128, 4) over 300-sample global crops): (T, C, H, L).
RC_SHAPES = {"headline": (460, 96, 96, 2), "dino": (300, 96, 128, 4)}
# The per-layer scan (K12-K14) at the Perils width, T = 460, B = 1024.
H_SCAN, B_BIG = 96, 1024
SCAN_SOURCE = "cerebra_torch/csrc/lstm_scan.cu"
# Limits for holding the scan's library call (nn.LSTM(4H, H) with weight_ih =
# I) against the plain versions in f32: it only has to show that the call
# computes the same function, and cuDNN sums in its own order, so they are
# ten times the kernels' f32 limits.
TOL_CUDNN_SCAN = (1e-4, 1e-4, TOL_BF16_REL)
REPLACES.update({
    "fwd_train_rc": "cerebra/models/pallas_lstm_stack.py:154",
    # K10 and K4 on the wavefront forward (K4 at the headline widths) and
    # its split layer (both at the DINO widths)
    "fwd_infer_wave": "cerebra/models/pallas_lstm_stack.py:196",
    "fwd_train_rc_split": "cerebra/models/pallas_lstm_stack.py:154",
    "fwd_infer_split": "cerebra/models/pallas_lstm_stack.py:196",
    "bwd_rc": "cerebra/models/pallas_lstm_stack.py:318",
    "rc_gates": "cerebra/models/pallas_lstm_stack.py:361",
    "rc_scan": "cerebra/models/pallas_lstm_stack.py:366",
    "rc_products": "cerebra/models/pallas_lstm_stack.py:392",
    "scan_fwd_infer": "cerebra/models/pallas_lstm.py:99",
    "scan_fwd_train": "cerebra/models/pallas_lstm.py:126",
    "scan_bwd": "cerebra/models/pallas_lstm.py:167",
    # K12 and K13 on the scan's wavefront forward (bf16); the rows above are
    # scan_fwd_kernel's (f32)
    "scan_fwd_infer_wave": "cerebra/models/pallas_lstm.py:99",
    "scan_fwd_train_wave": "cerebra/models/pallas_lstm.py:126",
})
SCAN_KERNELS = ("scan_fwd_infer", "scan_fwd_train", "scan_bwd", "scan_fwd_infer_wave",
                "scan_fwd_train_wave")

# The least time the card could take for a kernel's work: the larger of its
# operations over the H100 SXM's published peak (989 TFLOP/s on the bf16
# tensor cores, 67 TFLOP/s in f32 outside them) and its bytes (each input
# read once, each output written once) over 3.35 TB/s.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(gpu)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()} ({torch.cuda.get_device_name(0)})")
    return gpu


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from cerebra_torch.kernels import _build

    names = ("lstm_stack", "lstm_scan", "vit_attn", "vit_mlp")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, all at once
        built = list(pool.map(_build.build, names))
    for so, seconds in built:
        log(f"[build] {os.path.relpath(so, ROOT)} in {seconds:.2f} s")
    log(f"[build] all in {time.perf_counter() - t0:.2f} s")


def make_stack(B: int, dtype: torch.dtype, seed: int, C: int = C, H: int = H, L: int = L,
               T: int = T):
    gen = torch.Generator().manual_seed(seed)
    bound = 1.0 / math.sqrt(H)

    def u(*shape):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * bound).to("cuda", dtype)

    x = torch.randn(T, B, C, generator=gen).to("cuda", dtype)
    layers = [(u(C if l == 0 else H, 4 * H), u(H, 4 * H), u(4 * H)) for l in range(L)]
    g = torch.randn(B, H, generator=gen).to("cuda", dtype)
    return x, layers, g


def compare(what: str, got: torch.Tensor, want: torch.Tensor, dtype, grad: bool,
            tols=(TOL_F32_ABS, TOL_F32_GRAD_REL, TOL_BF16_REL), quiet: bool = False) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    max_abs = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
    f32_abs, f32_grad_rel, bf16_rel = tols
    if dtype == torch.float32 and not grad:
        ok, limit = max_abs <= f32_abs, f"max_abs <= {f32_abs}"
    elif dtype == torch.float32:
        ok, limit = rel <= f32_grad_rel, f"rel_frob <= {f32_grad_rel}"
    else:
        ok, limit = rel <= bf16_rel, f"rel_frob <= {bf16_rel}"
    if not (quiet and ok):
        log(f"[parity] {what}: max_abs {max_abs:.3e} rel_frob {rel:.3e} ({limit}) "
            f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version ({limit})")
    return max_abs


def check_bwd_pieces(g, x, layers, res, tag: str, dtype) -> tuple:
    """K2's two pieces alone against their plain versions, each layer on
    the plain pieces' inputs: the reverse scan (the top layer under g at
    T-1, the one below under the f32 chain) and the products (the chain
    `gup` above layer 0, dx at layer 0). → (scan error, products error)."""
    from cerebra_torch.models import lstm_stack as ls

    h_all, prefac, qf = res
    cot, es, ep = g, 0.0, 0.0
    for l in reversed(range(len(layers))):
        w_ih, w_hh, _ = layers[l]
        dg = ls._scan_bwd_ref(cot, prefac[l], qf[l], w_hh)
        es = max(es, compare(f"K2 scan[{l}] {tag}", ls.bwd_scan(cot, prefac[l], qf[l], w_hh), dg,
                             dtype, True))
        chain = "gup" if l > 0 else "dx"
        args = (dg, x if l == 0 else h_all[l - 1], h_all[l], w_ih, chain)
        want = ls._products_ref(*args)
        ep = max(ep, max(compare(f"K2 products[{l}] {n} {tag}", a, b, dtype, True)
                         for n, a, b in zip(("dW_ih", "dW_hh", "db", chain),
                                            ls.bwd_products(*args), want)))
        cot = want[3]
    return es, ep


def phase_parity() -> dict:
    from cerebra_torch.models import lstm_stack as ls

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[parity] allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    errs, e_wave = {}, 0.0
    ls.reset_launches()
    for dtype in (torch.float32, torch.bfloat16):
        for B in (1024, 16, 13):
            tag = f"{str(dtype).split('.')[-1]} B={B}"
            x, layers, g = make_stack(B, dtype, seed=B)
            e3 = compare(f"K3 h[T-1] {tag}", ls.fwd_infer_last(x, layers),
                         ls._fwd_infer_last_ref(x, layers), dtype, False)
            want = ls._fwd_train_ref(x, layers)
            got = ls.fwd_train(x, layers)
            torch.cuda.synchronize()
            e1 = max(compare(f"K1 {name} {tag}", a, b, dtype, False)
                     for name, a, b in zip(("h_all", "prefac", "qf"), got, want))
            # K2 on the plain forward's residuals, so it is checked alone
            _, got_g = ls.bwd(g, x, layers, *want)
            _, want_g = ls._bwd_ref(g, x, layers, *want)
            e2 = max(compare(f"K2 {name}[{l}] {tag}", a, b, dtype, True)
                     for l in range(L)
                     for name, a, b in zip(("dW_ih", "dW_hh", "db"), got_g[l], want_g[l]))
            # and on K1's own residuals, against the plain K2 on the plain ones
            _, own_g = ls.bwd(g, x, layers, *got)
            for l in range(L):
                for name, a, b in zip(("dW_ih", "dW_hh", "db"), own_g[l], want_g[l]):
                    compare(f"K2 on K1's residuals {name}[{l}] {tag}", a, b, dtype, True)
            es, ep = check_bwd_pieces(g, x, layers, want, tag, dtype)
            if dtype == torch.bfloat16:
                e_wave = max(e_wave, e1, e3)
            if dtype == torch.bfloat16 and B == 16:
                errs = {"fwd_train": e1, "bwd": e2, "fwd_infer_last": e3,
                        "stack_bwd_scan": es, "stack_bwd_products": ep}
            del x, layers, g, want, got, got_g, want_g, own_g
    x, layers, _ = make_stack(960, torch.bfloat16, seed=960)
    e_wave = max(e_wave, compare("K3 h[T-1] bfloat16 B=960", ls.fwd_infer_last(x, layers),
                                 ls._fwd_infer_last_ref(x, layers), torch.bfloat16, False))
    torch.cuda.synchronize()
    # the bf16 K1 and K3 calls above (3 batches, and K3 at 960) run the
    # wavefront forward, one launch each; f32 keeps lstm_fwd_kernel
    want_wave = sum(2 for B in (1024, 16, 13)
                    if ls.fwd_path(B, C, H, L, torch.bfloat16, "fwd_train") == "wave") + 1
    log(f"[parity] fwd_wave launches {ls.LAUNCHES['fwd_wave']} (expected {want_wave}); "
        f"wavefront clusters the card holds at once at C = H = {H}, L = {L}: "
        f"{ls.wave_clusters(C, H, L)}")
    if ls.LAUNCHES["fwd_wave"] != want_wave:
        raise AssertionError(f"bf16 K1/K3 bypassed the wavefront forward: {ls.LAUNCHES}")
    errs["fwd_wave"] = e_wave
    return errs


def phase_main() -> dict:
    from cerebra_torch.cli.lstm_distill_from_dinov2_train import main
    from cerebra_torch.models import Model
    from cerebra_torch.models import lstm_stack as ls

    log_dir = os.path.join(ROOT, "build", "chip_smoke", "cli")
    pth = os.path.join(log_dir, "lstm_dinov2_best_loss.pth")
    if os.path.exists(pth):
        os.remove(pth)
    argv = ["--synthetic", "--synthetic_classes", "40", "--synthetic_per_class", "30",
            "--feature_dim", "384", "--num_epochs", "6", "--batch_size", "16",
            "--device", "cuda", "--log_dir", log_dir]
    ls.reset_launches()
    t0 = time.perf_counter()
    _, hist = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ls.LAUNCHES)
    n_train = int(40 * 30 * 0.8)
    steps = 6 * -(-n_train // 16)
    log(f"[main] {seconds:.1f} s, {steps} train steps, launches {launches}")
    losses = hist["train_loss"]
    if len(losses) != 6 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train losses not all finite: {losses}")
    if [e for e, _ in hist["recall"]] != [5] or [e for e, _ in hist["precision"]] != [5]:
        raise AssertionError(f"no epoch-5 validation: {hist['recall']}")
    log(f"[main] epoch-5 R {hist['recall'][0][1]:.2f} P {hist['precision'][0][1]:.2f}; "
        f"windows/s per epoch {[round(w, 1) for w in hist['windows_per_s']]}")
    model = Model(C, H, L, F, n_classes=N_CLASSES)
    model.load_state_dict(torch.load(pth, map_location="cpu"), strict=True)
    log(f"[main] {os.path.relpath(pth, ROOT)} reloads with strict=True")
    if (launches["fwd_train"] < steps or launches["bwd"] < steps
            or min(launches["stack_bwd_scan"], launches["stack_bwd_products"]) < L * steps):
        raise AssertionError(f"train steps bypassed the kernels: {launches} for {steps} steps")
    if launches["fwd_infer_last"] == 0:
        raise AssertionError("kernel fwd_infer_last never launched on the main path")
    path = ls.fwd_path(16, C, H, L, torch.bfloat16, "fwd_train")
    if path == "cluster" and min(
            launches["fwd_in_product"], launches["fwd_cluster_scan"]) < L * steps:
        raise AssertionError(f"K1 bypassed its layer-by-layer pieces: {launches}")
    # K1 at every step and K3 at every validation run the wavefront forward
    if (path == "wave" and ls.fwd_path(960, C, H, L, torch.bfloat16, "fwd_infer_last") == "wave"
            and launches["fwd_wave"] < launches["fwd_train"] + launches["fwd_infer_last"]):
        raise AssertionError(f"K1/K3 bypassed the wavefront forward: {launches}")
    return launches


def time_windows(fn, reps: int, windows: int, warmup: int) -> tuple:
    """(median, least, most) ms per call over `windows` windows of `reps`
    calls each, by CUDA events, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    per_call.sort()
    return per_call[len(per_call) // 2], per_call[0], per_call[-1]


def time_ms(fn, reps: int) -> float:
    """ms per call over one window of `reps` calls after one warm-up call."""
    return time_windows(fn, reps, 1, 1)[0]


def nbytes(*tensors) -> int:
    """Bytes of the tensors in possibly nested tuples and lists (None: 0)."""
    total = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif t is not None:
            total += t.numel() * t.element_size()
    return total


def stack_flops(T: int, B: int, C: int, H: int, L: int, fwd: bool = True, bwd: bool = False,
                need_dx: bool = False) -> int:
    """Matrix-product operations of an LSTM stack over (T, B): the forward's
    x·W_ih + h·W_hh; the backward's dW_ih and dW_hh, dh = dgates·W_hhᵀ and
    the chain dgates·W_ihᵀ to each layer below (and to dx). The cell math is
    a few elementwise operations a value and is not counted."""
    G = 4 * H
    ins = [C] + [H] * (L - 1)
    gates = 2 * T * B * sum((n + H) * G for n in ins)
    flops = gates if fwd else 0
    if bwd:
        flops += gates + 2 * T * B * G * (H * L + H * (L - 1) + (C if need_dx else 0))
    return flops


def timing_row(kern, plain, inputs, flops: int, dtype, reps: int = 5, plain_reps: int = 2,
               library=None) -> dict:
    """ms of the kernel's wrapper and of its plain version (CUDA events after a
    warm-up call), the bound from `flops` and the bytes of `inputs` and of
    the kernel's outputs, and `library`, the ms of one PyTorch call that
    computes the same function, or None where there is none."""
    out = kern()
    moved = nbytes(inputs) + nbytes(out)
    del out
    t_ops, t_mem = flops / PEAK_FLOPS[dtype], moved / HBM_BYTES_PER_S
    return {"ms": time_ms(kern, reps), "plain_ms": time_ms(plain, plain_reps),
            "bound_ms": max(t_ops, t_mem) * 1e3,
            "bound_by": "operations" if t_ops > t_mem else "bytes", "library_ms": library}


def bwd_pieces(g, x, layers, res, need_dx: bool) -> dict:
    """K2/K2g's two sides as `bwd` runs them, each over every layer: the
    reverse scans (each under the cotangent it gets there: g at the top,
    the f32 chain below) and the products, with those cotangents and dgates
    computed once beforehand. → {"scan" | "products": (kernel call, plain
    call, inputs, matrix-product operations)}."""
    from cerebra_torch.models import lstm_stack as ls

    h_all, prefac, qf = res
    T_, B, C_ = x.shape
    L_, H_ = len(layers), layers[0][1].shape[0]
    cots, dgs, chains = [None] * L_, [None] * L_, [None] * L_
    cot = g
    for l in reversed(range(L_)):
        cots[l] = cot
        dgs[l] = ls.bwd_scan(cot, prefac[l], qf[l], layers[l][1])
        chains[l] = "gup" if l > 0 else ("dx" if need_dx else None)
        cot = ls.bwd_products(dgs[l], x if l == 0 else h_all[l - 1], h_all[l], layers[l][0],
                              chains[l])[3]

    def scans(fn):
        return lambda: [fn(cots[l], prefac[l], qf[l], layers[l][1]) for l in range(L_)]

    def products(fn):
        return lambda: [fn(dgs[l], x if l == 0 else h_all[l - 1], h_all[l], layers[l][0],
                           chains[l]) for l in range(L_)]

    G, ins = 4 * H_, [C_] + [H_] * (L_ - 1)
    # the scan's dh = dgates·W_hhᵀ; the products' dW_ih, dW_hh and chain
    scan_ops = 2 * T_ * B * G * H_ * L_
    prod_ops = sum(2 * T_ * B * G * (n + H_ + (n if chains[l] else 0)) for l, n in enumerate(ins))
    return {"scan": (scans(ls.bwd_scan), scans(ls._scan_bwd_ref),
                     (cots, prefac, qf, [w[1] for w in layers]), scan_ops),
            "products": (products(ls.bwd_products), products(ls._products_ref),
                         (dgs, x, h_all, [w[0] for w in layers]), prod_ops)}


def bwd_piece_rows(g, x, layers, res, need_dx: bool, reps: int = 5,
                   plain_reps: int = 2) -> dict:
    """Timing rows of `bwd_pieces`' two sides; library none: no one
    PyTorch call computes L scans chained through the products, or the
    products."""
    return {k: timing_row(kern, plain, inputs, ops, x.dtype, reps, plain_reps)
            for k, (kern, plain, inputs, ops) in bwd_pieces(g, x, layers, res, need_dx).items()}


def fmt_row(row: dict) -> str:
    lib = "none" if row["library_ms"] is None else f"{row['library_ms']:.3f} ms"
    return (f"kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), library {lib}")


@functools.lru_cache(maxsize=None)
def cudnn_dtype() -> torch.dtype:
    """bf16 where torch.nn.LSTM runs cuDNN (aten::_cudnn_rnn) in bf16, else
    fp16: PyTorch's RNN takes the cuDNN path only for dtypes cuDNN accepts,
    and otherwise loops over time itself."""
    from torch.profiler import ProfilerActivity, profile

    lstm = torch.nn.LSTM(8, 8).to("cuda", torch.bfloat16)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        lstm(torch.zeros(3, 2, 8, device="cuda", dtype=torch.bfloat16))
    bf16 = any("cudnn_rnn" in e.key for e in prof.key_averages())
    dt = torch.bfloat16 if bf16 else torch.float16
    log(f"[cudnn] torch.nn.LSTM in bf16 runs cuDNN: {bf16}; the library column times "
        f"{str(dt).split('.')[-1]} (cuDNN {torch.backends.cudnn.version()})")
    return dt


def cudnn_lstm(C: int, H: int, L: int, dtype: torch.dtype, scan: bool) -> torch.nn.LSTM:
    """torch.nn.LSTM(C, H, L) on the card. scan: one layer whose input is
    lstm_scan's x_proj (C = 4H) itself, weight_ih = I (4H x 4H) and zero
    biases, so that its output is lstm_scan's h_all, its input gradient the
    dgates stream and its weight_hh gradient dW_hh transposed (gate order
    [i, f, g, o] in both; phase_scan holds it against the plain versions)."""
    lstm = torch.nn.LSTM(C, H, num_layers=L).to("cuda", dtype)
    if scan:
        with torch.no_grad():
            lstm.weight_ih_l0.copy_(torch.eye(4 * H))
            lstm.bias_ih_l0.zero_()
            lstm.bias_hh_l0.zero_()
    return lstm


def cudnn_ms(T: int, B: int, C: int, H: int, L: int, which: str, reps: int = 5,
             scan: bool = False, dtype=None) -> float:
    """ms of the one PyTorch call that computes what an LSTM kernel computes:
    torch.nn.LSTM (cuDNN) at the same T, B, C, H, L, in `dtype` (default
    `cudnn_dtype()`); `scan` as `cudnn_lstm`. which: "infer" the no-grad
    forward (K3 reads h_n, K4 and K12 the output, one call gives both);
    "train" the forward under grad (K1, K10, K13); "bwd_last" the backward of
    a loss on h_n (K2); "bwd_seq" the backward of a loss on the output, with
    dx (K2g, K11, K14; cuDNN computes dx in every backward). The median of
    five windows of `reps` calls after three warm-up calls, with cuDNN's
    autotuner off (one plan for a shape in every run); the spread is logged."""
    dt = dtype or cudnn_dtype()
    torch.backends.cudnn.benchmark = False
    gen = torch.Generator().manual_seed(T + B + H)
    lstm = cudnn_lstm(C, H, L, dt, scan)
    x = torch.randn(T, B, C, generator=gen).to("cuda", dt).requires_grad_(which == "bwd_seq")
    params = list(lstm.parameters())
    if which == "infer":
        def call():
            with torch.no_grad():
                return lstm(x)
    elif which == "train":
        def call():
            return lstm(x)
    else:
        y, (h_n, _) = lstm(x)
        out, inputs = (h_n[-1], params) if which == "bwd_last" else (y, [x] + params)
        g = torch.randn(out.shape, generator=gen).to("cuda", dt)

        def call():
            return torch.autograd.grad(out, inputs, g, retain_graph=True)
    ms, least, most = time_windows(call, reps, 5, 3)
    log(f"[cudnn] {which}{' scan' if scan else ''} T={T} B={B} C={C} H={H} L={L} "
        f"{str(dt).split('.')[-1]}: {ms:.3f} ms, the median of 5 windows of {reps} "
        f"(spread {least:.3f}-{most:.3f} ms)")
    return ms


def phase_kernel_timing() -> dict:
    from cerebra_torch.models import lstm_stack as ls

    out = {}
    bf16 = torch.bfloat16
    for B_train, B_val in ((16, 960), (1024, 1024)):
        x, layers, g = make_stack(B_train, bf16, seed=1)
        res = ls._fwd_train_ref(x, layers)
        xv, layers_v, _ = make_stack(B_val, bf16, seed=2)
        # name: (kernel, plain, inputs, operations, their dtype, library call ms, B)
        rows = {
            "fwd_train": (lambda: ls.fwd_train(x, layers), lambda: ls._fwd_train_ref(x, layers),
                          (x, layers), stack_flops(T, B_train, C, H, L), bf16,
                          cudnn_ms(T, B_train, C, H, L, "train"), B_train),
            "bwd": (lambda: ls.bwd(g, x, layers, *res), lambda: ls._bwd_ref(g, x, layers, *res),
                    (g, x, layers, res), stack_flops(T, B_train, C, H, L, fwd=False, bwd=True),
                    bf16, cudnn_ms(T, B_train, C, H, L, "bwd_last"), B_train),
            "fwd_infer_last": (lambda: ls.fwd_infer_last(xv, layers_v),
                               lambda: ls._fwd_infer_last_ref(xv, layers_v), (xv, layers_v),
                               stack_flops(T, B_val, C, H, L), bf16,
                               cudnn_ms(T, B_val, C, H, L, "infer"), B_val),
        }
        pieces = bwd_piece_rows(g, x, layers, res, False)
        for name, (kern, plain, inputs, flops, dt, lib, B) in rows.items():
            row = timing_row(kern, plain, inputs, flops, dt, 5, 2, lib)
            split = (f"; its {L} scans {pieces['scan']['ms']:.3f} ms, its products "
                     f"{pieces['products']['ms']:.3f} ms" if name == "bwd" else "")
            if name != "bwd":  # K1 and K3: the path taken, and lstm_fwd_kernel alone
                xs, ws = (x, layers) if name == "fwd_train" else (xv, layers_v)
                old = time_ms(lambda: ls._fwd_cuda(xs, ws, name), 5)
                split = (f"; path {ls.fwd_path(B, C, H, L, bf16, name)}, lstm_fwd_kernel "
                         f"{old:.3f} ms")
            log(f"[timing] {name} B={B} T={T} bf16: {fmt_row(row)}{split}")
            if B_train == 16:  # the CLI's shapes (train batch 16, gallery 960)
                out[name] = row
            elif name == "fwd_train":  # the bench step's K1 on the wavefront forward
                out["fwd_wave"] = row
        for side, row in pieces.items():
            log(f"[timing] stack_bwd_{side} B={B_train} T={T} bf16 (K2's {L} layers): "
                f"{fmt_row(row)}")
            if B_train == 16:
                out[f"stack_bwd_{side}"] = row
        del x, layers, g, res, xv, layers_v, pieces
    scan_tile_sweep()
    return out


def scan_tile_sweep() -> None:
    """ms of one reverse scan (`bwd_scan`, T = 460, a cotangent at every t)
    at each rows-per-block, at the shapes K2, K2g and K14 give it and at the
    DINO-LSTM's H = 128 (K2g's and K11's there), beside the tile
    `scan_tile` picks."""
    from cerebra_torch.models import lstm_scan as sc
    from cerebra_torch.models import lstm_stack as ls

    for B, h, dtype in ((16, H, torch.bfloat16), (1024, H, torch.bfloat16),
                        (1024, H, torch.float32), (16, 384, torch.bfloat16),
                        (1024, 128, torch.bfloat16)):
        gen = torch.Generator().manual_seed(B + h)
        x_proj = (torch.randn(T, B, 4 * h, generator=gen) * 0.5).to("cuda", dtype)
        w_hh = ((torch.rand(h, 4 * h, generator=gen) * 2 - 1) / math.sqrt(h)).to("cuda", dtype)
        g = torch.randn(T, B, h, generator=gen).to("cuda", dtype)
        _, prefac, qf = sc.scan_fwd_train(x_proj, w_hh)
        ms = {bt: round(time_ms(lambda: ls.bwd_scan(g, prefac, qf, w_hh, tile=bt), 3), 3)
              for bt in (1, 2, 4, 8, 16)}
        log(f"[scan tiles] B={B} H={h} T={T} {str(dtype).split('.')[-1]}: ms by rows per block "
            f"{ms}; scan_tile picks {ls.scan_tile(B, h, dtype)}")
        del x_proj, w_hh, g, prefac, qf


# kernel name fragments → the part of a step they belong to, for the
# profiler's split (first match wins)
KERNEL_PARTS = (("scan_bwd_kernel", "K2/K2g scans"), ("cluster_scan", "K1/K4 cluster scans"),
                ("gemm_tc<false, false, vit::EpiF32>", "K1/K4 input products"),
                ("gemm", "K2/K2g products"),
                ("sum_partials", "K2/K2g products"), ("col_sum_part", "K2/K2g products"),
                ("lstm_fwd_kernel", "K1 forward"), ("wave_fwd_kernel", "K1 wavefront forward"))


def device_kernels(call, n: int, check=None) -> tuple:
    """The CUDA kernels of `n` calls of `call` in launch order, each (name,
    device ms) from torch.profiler, and the host-clock ms per call to a
    synchronise (the profiler's own overhead inside it). A trace can lose
    its first kernels, so 64 small kernels and one call run ahead of the
    `n`, then a marker kernel (torch.cuda._sleep's `spin_kernel`); only the
    kernels after the marker are kept. Also the host's ops, (name, self CPU ms per call) from
    the largest, over all n + 1 calls. A trace that lost its marker, or
    whose kernel names `check` rejects (AssertionError), is taken again, up
    to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pad = torch.empty(1, device="cuda")
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(64):  # kernels for the trace to lose first
                pad.zero_()
            call()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(kernels) if "spin_kernel" in e.name]
        try:
            if not marks:
                raise AssertionError(f"the trace holds no marker kernel among its {len(kernels)}"
                                     f" kernels, first {[e.name[:30] for e in kernels[:3]]}")
            kernels = [(e.name, e.time_range.elapsed_us() / 1e3) for e in kernels[marks[-1] + 1:]]
            if check is not None:
                check([k for k, _ in kernels])
        except AssertionError as e:
            if attempt == 2:
                raise
            log(f"[profile] trace {attempt + 1} rejected ({str(e)[:200]}); tracing again")
            continue
        host = sorted(((e.key, e.self_cpu_time_total / 1e3 / (n + 1))
                       for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                      key=lambda kv: -kv[1])
        return kernels, wall_ms, host


def profile_steps(step, n: int, what: str, gpu: str) -> None:
    """Device time of `n` calls of `step` by kernel (`device_kernels`),
    grouped by KERNEL_PARTS, and the device's idle share of the profiled
    wall time (host clock to a synchronise; the profiler's own overhead is
    inside it)."""
    kernels, wall_ms, _ = device_kernels(step, n)
    parts, names = {}, {}
    for name, ms in kernels:
        part = next((p for frag, p in KERNEL_PARTS if frag in name), "other")
        parts[part] = parts.get(part, 0.0) + ms / n
        names[name[:60]] = names.get(name[:60], 0.0) + ms / n
    busy = sum(parts.values())
    top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
    log(f"[profile] {what}: {wall_ms:.2f} ms/step under the profiler, device busy "
        f"{busy:.2f} ms (idle {max(0.0, 1 - busy / wall_ms) * 100:.1f} %); by part "
        f"{ {k: round(v, 3) for k, v in sorted(parts.items(), key=lambda kv: -kv[1])} }; "
        f"top kernels {[(k, round(v, 3)) for k, v in top]} on {gpu}")


def phase_step_timing(gpu: str) -> None:
    from cerebra_torch.losses import feature_distribution_loss_v1
    from cerebra_torch.models import Model
    from cerebra_torch.models.lstm_stack import lstm_stack_last_ref
    from cerebra_torch.signal.filters import design_bandpass, filtfilt_matmul, zero_phase_matrix
    from cerebra_torch.train.optim import make_optimizer

    B = 1024
    dev = torch.device("cuda")
    fir = zero_phase_matrix(design_bandpass(14.0, 71.0, fs=1000.0, order=4), T_RAW,
                            num_taps=257, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(rng.normal(size=(B, C, T_RAW)).astype(np.float32)).to(dev)
    teacher = torch.from_numpy(rng.normal(size=(B, F)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, N_CLASSES, size=B)).to(dev)

    profiled = False
    for kind in ("kernels", "plain", "kernels"):
        model = Model(C, H, L, F, n_classes=N_CLASSES, dtype=torch.bfloat16, device=dev,
                      generator=torch.Generator().manual_seed(0))
        opt = make_optimizer("rmsprop", model.parameters(), 1e-3)

        def step():
            filtered = filtfilt_matmul(fir, raw, out_dtype=torch.bfloat16)  # (B, C, T_RAW)
            eeg = filtered.transpose(1, 2)[:, T_LO:T_HI, :]
            opt.zero_grad(set_to_none=True)
            if kind == "kernels":
                feats, cls = model(eeg)
            else:
                feats, cls = model.top(lstm_stack_last_ref(*model.lstm.prepare(eeg)))
            loss = feature_distribution_loss_v1(feats.float(), teacher, labels, cls.float(), 0.5)
            loss.backward()
            opt.step()
            return loss

        n = 5 if kind == "kernels" else 2
        loss = step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            loss = step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n
        if not math.isfinite(loss.item()):
            raise AssertionError(f"{kind} step loss is {loss.item()}")
        log(f"[step] {kind}: {dt * 1e3:.2f} ms/step, {B / dt:.1f} windows/s at B={B} "
            f"(filter + crop + LSTM fwd/bwd + RMSprop, bf16) on {gpu}")
        if kind == "kernels" and not profiled:
            profile_steps(step, 3, f"bench step B={B}", gpu)
            profiled = True


def vit_inputs(B: int, N: int, cdt, scaled: bool, seed: int):
    """f32-stream inputs of one ViT-S half-block: x and dout (B, N, D), the
    attention and MLP parameters prepared in `cdt`, and the drop-path scale
    per sequence and per row (sample 0 dropped) or None."""
    from cerebra_torch.models import vit_attn as va
    from cerebra_torch.models import vit_mlp as vm

    gen = torch.Generator().manual_seed(seed)
    D, F = D_VIT, F_VIT

    def r(*shape, sc=0.05, base=0.0):
        return (torch.randn(*shape, generator=gen) * sc + base).to("cuda")

    x, dout = r(B, N, D, sc=1.0), r(B, N, D, sc=1.0)
    pa = va._prep(r(D, base=1.0), r(D), r(D, 3 * D), r(3 * D), r(D, D), r(D), H_VIT, cdt)
    pm = vm._prep(r(D, base=1.0), r(D), r(D, F), r(F), r(F, D), r(D), cdt)
    s_seq = s_rows = None
    if scaled:
        s_seq = torch.full((B,), 1 / 0.9, device="cuda")
        s_seq[0] = 0.0
        s_rows = s_seq.repeat_interleave(N).contiguous()
    return x, dout, pa, pm, s_seq, s_rows


def phase_vit_parity() -> dict:
    from cerebra_torch.models import vit_attn as va
    from cerebra_torch.models import vit_mlp as vm

    errs = {}
    for cdt in (torch.float32, torch.bfloat16):
        for B, N in VIT_SHAPES:
            for scaled in (False, True):
                tag = f"f32/{str(cdt).split('.')[-1]} B={B} N={N}{' s' if scaled else ''}"
                x, dout, pa, pm, s_seq, s_rows = vit_inputs(B, N, cdt, scaled, seed=N)
                out, saved = va.attn_fwd(x, s_seq, pa, H_VIT)
                e5 = compare(f"K5 out {tag}", out, va._attn_fwd_ref(x, s_seq, pa, H_VIT)[0],
                             cdt, False, TOL_VIT)
                got = va.attn_bwd(dout, x, s_seq, pa, H_VIT, saved)
                want = va._attn_bwd_ref(dout, x, s_seq, pa, H_VIT)
                e6 = max(compare(f"K6 {name} {tag}", a, b, cdt, True, TOL_VIT) for name, a, b in
                         zip(("dx", "dg", "db", "dWqkv", "dbqkv", "dWp", "dbp"), got, want))
                xm, dm = x.reshape(B * N, D_VIT), dout.reshape(B * N, D_VIT)
                out, saved = vm.mlp_fwd(xm, s_rows, pm)
                e7 = compare(f"K7 out {tag}", out, vm._mlp_fwd_ref(xm, s_rows, pm)[0], cdt,
                             False, TOL_VIT)
                got = vm.mlp_bwd(dm, xm, s_rows, pm, saved)
                want = vm._mlp_bwd_ref(dm, xm, s_rows, pm)
                e8 = max(compare(f"K8 {name} {tag}", a, b, cdt, True, TOL_VIT) for name, a, b in
                         zip(("dx", "dg", "db", "dW1", "db1", "dW2", "db2"), got, want))
                if cdt == torch.bfloat16 and (B, N) == VIT_SHAPES[0] and scaled:
                    errs = {"vit_attn_fwd": e5, "vit_attn_bwd": e6, "vit_mlp_fwd": e7,
                            "vit_mlp_bwd": e8}
                del x, dout, pa, pm, out, saved, got, want
    torch.cuda.synchronize()
    return errs


def phase_main_dino() -> dict:
    from cerebra_torch.cli.main_dino import main
    from cerebra_torch.kernels import LAUNCHES, reset_launches

    log_dir = os.path.join(ROOT, "build", "chip_smoke", "main_dino")
    log_txt = os.path.join(log_dir, "log.txt")
    if os.path.exists(log_txt):
        os.remove(log_txt)
    epochs, steps_per_epoch = 2, 10  # 40 classes x 2 trials at batch 8
    argv = ["--synthetic", "--synthetic_classes", "40", "--synthetic_per_class", "2",
            "--epochs", str(epochs), "--warmup_epochs", "1", "--device", "cuda",
            "--log_dir", log_dir]
    reset_launches()
    t0 = time.perf_counter()
    state, hist = main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    steps = epochs * steps_per_epoch
    log(f"[main_dino] {seconds:.1f} s, {steps} steps, launches {launches}")
    losses = hist["loss"]
    if len(losses) != epochs or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"main_dino losses not all finite: {losses}")
    with open(log_txt) as f:
        lines = [json.loads(line) for line in f]
    if [row["epoch"] for row in lines] != list(range(epochs)):
        raise AssertionError(f"log.txt holds {lines}")
    if state.step != steps or tuple(state.center.shape) != (1, 65536):
        raise AssertionError(f"state after {state.step} steps, center {tuple(state.center.shape)}")
    if not torch.isfinite(state.center).all() or not all(
            torch.isfinite(p).all() for p in state.student.parameters()):
        raise AssertionError("non-finite center or student parameters")
    log(f"[main_dino] losses {[round(v, 4) for v in losses]}; windows/s per epoch "
        f"{[round(w, 2) for w in hist['windows_per_s']]}")
    # 12 blocks x (2 student view groups + 1 teacher group) forwards, 12 x 2 backwards
    for name, per_step in (("vit_attn_fwd", 36), ("vit_mlp_fwd", 36),
                           ("vit_attn_bwd", 24), ("vit_mlp_bwd", 24)):
        if launches[name] < per_step * steps:
            raise AssertionError(f"{name} launched {launches[name]} times in {steps} steps, "
                                 f"fewer than {per_step} per step")
    del state
    torch.cuda.empty_cache()
    return launches


def label_vit(names) -> list:
    """(half-block, piece) of each kernel of the ViT half-blocks, by name in
    launch order, None for the others. K5 launches LN, the qkv product
    (`EpiBiasRound`), its attention core and the proj (`EpiResidual`); K6
    from `scale_round` to `ln_bwd_rows`, its two attention cores in the
    middle; K7 LN, fc1 (`EpiGelu`) and fc2 (`EpiResidual`); K8 from
    `mlp_bwd_dn` to `ln_bwd_rows`: dn/db2, the fused dh kernel, the dW
    contractions (`EpiPartial`), dy (`EpiF32`), the LN column partials, the
    sums of partials (`sum_jobs`) and the LN rows."""
    labels = [None] * len(names)

    def expect(i: int, frag: str) -> None:
        if not (0 <= i < len(names) and frag in names[i]):
            raise AssertionError(f"launch {i} of a ViT half-block is not {frag}: {names}")

    def nearest(i: int, frag: str, step: int) -> int:
        while 0 <= i < len(names) and frag not in names[i]:
            i += step
        expect(i, frag)
        return i

    for i, name in enumerate(names):
        if "attn_fwd" in name:
            expect(i - 2, "ln_fwd_rows")
            expect(i - 1, "EpiBiasRound")
            expect(i + 1, "EpiResidual")
            labels[i - 2:i + 2] = [("K5", "LN"), ("K5", "qkv product"),
                                   ("K5", "attention core"), ("K5", "proj")]
        elif "attn_bwd_dq" in name:
            expect(i + 1, "attn_bwd_dkdv")
            piece = "scale/dbp"
            for j in range(nearest(i, "scale_round", -1), nearest(i, "ln_bwd_rows", 1) + 1):
                for frag, p in (("attn_bwd_dq", "dq core"), ("attn_bwd_dkdv", "dk/dv core"),
                                ("EpiPartial", "dWp" if j < i else "dWqkv/dbqkv"),
                                ("EpiBiasRound", "do product"), ("EpiF32", "dy product"),
                                ("ln_bwd", "LN backward")):
                    if frag in names[j]:
                        piece = p
                        break
                labels[j] = ("K6", piece)
        elif "EpiGelu" in name and i + 1 < len(names) and "EpiResidual" in names[i + 1]:
            expect(i - 1, "ln_fwd_rows")
            labels[i - 1:i + 2] = [("K7", "LN"), ("K7", "fc1"), ("K7", "fc2")]
        elif "mlp_bwd_dn" in name:
            end = nearest(i, "ln_bwd_rows", 1)
            for j in range(i, end + 1):
                piece = next((p for frag, p in K8_PIECES if frag in names[j]), None)
                if piece is None:
                    raise AssertionError(f"launch {j} of K8 is none of its pieces: {names}")
                labels[j] = ("K8", piece)
    return labels


# K8's launches by kernel name fragment, in launch order
K8_PIECES = (("mlp_bwd_dn", "dn/db2"), ("mlp_bwd_dh", "dh"), ("EpiPartial", "dW1/dW2"),
             ("EpiF32", "dy"), ("ln_bwd_cols", "LN columns"), ("sum_jobs", "sums"),
             ("ln_bwd_rows", "LN rows"))


def split_ms(kernels, labels, n: int, key) -> dict:
    """Device ms per call of `kernels` summed by key(label)."""
    out = {}
    for (_, ms), lab in zip(kernels, labels):
        k = key(lab)
        out[k] = out.get(k, 0.0) + ms / n
    return out


def sdpa_ms(qkv, dob, B: int, N: int) -> tuple:
    """The yardstick: F.scaled_dot_product_attention at (B, H, N, dh) bf16,
    scale 1 (q carries the scale), on the flash backend, forward and forward
    + backward under the cotangent do; ms, median of three windows. The port
    never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from cerebra_torch.models import vit_attn as va

    q, k, v = (t.contiguous() for t in va._qkv_heads(qkv, B, N, H_VIT))
    do = va._heads(dob.reshape(B, N, D_VIT), B, N, H_VIT).contiguous()
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

    def fwd_bwd():
        torch.autograd.grad(sdpa(qg, kg, vg, scale=1.0), (qg, kg, vg), do)

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        fwd = time_windows(lambda: sdpa(q, k, v, scale=1.0), 10, 3, 2)[0]
        both = time_windows(fwd_bwd, 10, 3, 2)[0]
    return fwd, both


def vit_pieces(B: int, N: int, x, dout, s_seq, pa, sa, gpu: str) -> dict:
    """`[vit pieces]`: K5 and K6 split by launch, each attention core alone
    against its plain piece (parity, time, bound) and the SDPA yardstick.
    → the cores' ms for the kernels line."""
    from cerebra_torch.models import vit_attn as va

    n, D = 5, D_VIT
    for what, call in (("K5", lambda: va.attn_fwd(x, s_seq, pa, H_VIT)),
                       ("K6", lambda: va.attn_bwd(dout, x, s_seq, pa, H_VIT, sa))):
        kernels, _, _ = device_kernels(call, n, label_vit)
        parts = split_ms(kernels, label_vit([k for k, _ in kernels]), n,
                         lambda lab: lab[1] if lab else "not a half-block's")
        log(f"[vit pieces] {what} B={B} N={N} device ms per call by piece: "
            f"{ {k: round(v, 4) for k, v in parts.items()} } (sum {sum(parts.values()):.4f}) "
            f"on {gpu}")
    qkv, stats = sa[3], sa[5]
    dob = (dout.reshape(B * N, D) @ pa[4].float().t()).to(torch.bfloat16)
    tag = f"B={B} N={N} bf16"
    o_k, st_k = va.attn_core_fwd(qkv, B, N, H_VIT)
    o_r, st_r = va.attn_core_fwd_ref(qkv, B, N, H_VIT)
    err_f = max(compare(f"core fwd {name} {tag}", a, b, torch.bfloat16, False, TOL_VIT)
                for name, a, b in (("o", o_k, o_r), ("m", st_k[..., 0], st_r[..., 0]),
                                   ("l", st_k[..., 1], st_r[..., 1])))
    got = va.attn_core_bwd(qkv, dob, st_k, B, N, H_VIT)
    want = va.attn_core_bwd_ref(qkv, dob, st_k, B, N, H_VIT)
    err_b = max(compare(f"core bwd {name} {tag}", a, b, torch.bfloat16, True, TOL_VIT)
                for name, a, b in zip(("dqkv32", "dqkvn", "delta"), got, want))
    # dk/dv forms S^T = K Q^T with the key rows as the A operand; p there is
    # the forward's only if every score equals the forward's bit for bit
    S, St = va.attn_scores_cuda(qkv, B, N, H_VIT)
    if not torch.equal(S, St.transpose(-1, -2)) or not torch.equal(st_k[..., 0], S.amax(-1)):
        raise AssertionError(f"dk/dv's scores differ from the forward's at {tag}")
    log(f"[parity] scores {tag}: dk/dv's S^T equals the forward's S bit for bit, and the "
        f"forward's row max is their max")
    del S, St
    sdpa_f, sdpa_fb = sdpa_ms(qkv, dob, B, N)
    rows = {
        "fwd": timing_row(lambda: va.attn_core_fwd(qkv, B, N, H_VIT),
                          lambda: va.attn_core_fwd_ref(qkv, B, N, H_VIT), (qkv,),
                          4 * B * N * N * D, torch.bfloat16, 10, 3),
        "bwd": timing_row(lambda: va.attn_core_bwd(qkv, dob, st_k, B, N, H_VIT),
                          lambda: va.attn_core_bwd_ref(qkv, dob, st_k, B, N, H_VIT),
                          (qkv, dob, st_k), 10 * B * N * N * D, torch.bfloat16, 10, 3),
    }
    kernels, _, _ = device_kernels(lambda: va.attn_core_bwd(qkv, dob, st_k, B, N, H_VIT), n)
    split = {core: sum(ms for k, ms in kernels if frag in k) / n
             for core, frag in (("dq core", "attn_bwd_dq"), ("dk/dv core", "attn_bwd_dkdv"))}
    log(f"[vit pieces] core fwd {tag}: {fmt_row(rows['fwd'])}; max_abs {err_f:.3e}; SDPA "
        f"flash forward {sdpa_f:.4f} ms (kernel / SDPA {rows['fwd']['ms'] / sdpa_f:.2f}) on {gpu}")
    log(f"[vit pieces] core bwd {tag}: {fmt_row(rows['bwd'])}; dq {split['dq core']:.4f} ms, "
        f"dk/dv {split['dk/dv core']:.4f} ms (device); max_abs {err_b:.3e}; SDPA flash forward "
        f"+ backward {sdpa_fb:.4f} ms, backward {sdpa_fb - sdpa_f:.4f} ms (kernel / SDPA "
        f"backward {rows['bwd']['ms'] / (sdpa_fb - sdpa_f):.2f}) on {gpu}")
    return {"fwd_core_ms": rows["fwd"]["ms"], "fwd_core_bound_ms": rows["fwd"]["bound_ms"],
            "sdpa_fwd_ms": sdpa_f, "bwd_core_ms": rows["bwd"]["ms"],
            "bwd_core_bound_ms": rows["bwd"]["bound_ms"], "dq_core_ms": split["dq core"],
            "dkdv_core_ms": split["dk/dv core"], "sdpa_bwd_ms": sdpa_fb - sdpa_f}


def mlp_pieces(B: int, N: int, xm, dm, s_rows, pm, sm, gpu: str) -> dict:
    """`[mlp pieces]`: K7 and K8 split by launch (torch.profiler), their
    launches a call, each product's device ms against its bound and against
    cuBLAS `torch.mm` on the same bf16 operands (a yardstick the port never
    calls), and K8's fused dh kernel alone against its plain piece (parity,
    time, bound). → the pieces' numbers for the kernels line."""
    from cerebra_torch.models import vit_mlp as vm

    n, M, D, F = 5, B * N, D_VIT, F_VIT
    bf = torch.bfloat16
    parts, launches = {}, {}
    for what, call in (("K7", lambda: vm.mlp_fwd(xm, s_rows, pm)),
                       ("K8", lambda: vm.mlp_bwd(dm, xm, s_rows, pm, sm))):
        kernels, _, _ = device_kernels(call, n, label_vit)
        labels = label_vit([k for k, _ in kernels])
        mine = [lab for lab in labels if lab and lab[0] == what]
        if len(mine) % n:
            raise AssertionError(f"{what}: {len(mine)} launches in {n} calls")
        launches[what] = len(mine) // n
        parts[what] = split_ms(kernels, labels, n,
                               lambda lab: lab[1] if lab and lab[0] == what else "other")
        parts[what].pop("other", None)
        log(f"[mlp pieces] {what} B={B} N={N} device ms per call by piece: "
            f"{ {k: round(v, 4) for k, v in parts[what].items()} } (sum "
            f"{sum(parts[what].values()):.4f}); {launches[what]} launches a call on {gpu}")
    g, b, w1, b1, w2, b2 = pm
    y = sm[0]
    dn = (dm * s_rows[:, None]).to(bf)
    tag = f"B={B} N={N} bf16"
    got = vm.mlp_dh(y, dn, w1, b1, w2)
    want = vm.mlp_dh_ref(y, dn, w1, b1, w2)
    err = max(compare(f"dh {name} {tag}", a, c, dt, True, TOL_VIT)
              for name, a, c, dt in zip(("gh", "dhn", "db1 partials"), got, want,
                                        (bf, bf, torch.float32)))
    gh, dhn, dparts = got
    splits = vm.contraction_splits(M, D, F)
    row = timing_row(lambda: vm.mlp_dh(y, dn, w1, b1, w2), lambda: vm.mlp_dh_ref(y, dn, w1, b1, w2),
                     (y, dn, w1, b1, w2), 4 * M * D * F, bf, 10, 3)
    log(f"[mlp pieces] dh kernel alone {tag}: {fmt_row(row)}; max_abs {err:.3e} on {gpu}")
    mmd = 2 * M * D * F
    f32 = 4
    # (half-block, piece) → (operations, bytes each input read and each
    # output written once, the cuBLAS yardstick)
    products = {
        ("K7", "fc1"): (mmd, nbytes(y, w1, b1) + M * F * 2, lambda: torch.mm(y, w1)),
        ("K7", "fc2"): (mmd, nbytes(gh, w2, b2, xm, s_rows) + M * D * f32,
                        lambda: torch.mm(gh, w2)),
        ("K8", "dh"): (2 * mmd, nbytes(y, dn, w1, b1, w2, gh, dhn, dparts),
                       lambda: (torch.mm(y, w1), torch.mm(dn, w2.t()))),
        ("K8", "dW1/dW2"): (2 * mmd, nbytes(gh, dn, y, dhn) + 2 * D * F * f32,
                            lambda: (torch.mm(gh.t(), dn), torch.mm(y.t(), dhn))),
        ("K8", "dy"): (mmd, nbytes(dhn, w1) + M * D * f32, lambda: torch.mm(dhn, w1.t())),
    }
    out = {"vit_mlp_fwd": {"launches_per_call": launches["K7"]},
           "vit_mlp_bwd": {"launches_per_call": launches["K8"], "dh_alone_ms": row["ms"],
                           "dh_plain_ms": row["plain_ms"], "contraction_splits": splits}}
    for (what, piece), (ops, moved, mm_call) in products.items():
        ms = parts[what][piece]
        bound = max(ops / PEAK_FLOPS[bf], moved / HBM_BYTES_PER_S) * 1e3
        mm_ms = time_windows(mm_call, 10, 3, 2)[0]
        log(f"[mlp pieces] {what} {piece} {tag}: device {ms:.4f} ms ({ops / ms / 1e9:.0f} "
            f"TFLOP/s), bound {bound:.4f} ms, torch.mm {mm_ms:.4f} ms (kernel / mm "
            f"{ms / mm_ms:.2f}) on {gpu}")
        key = "vit_mlp_fwd" if what == "K7" else "vit_mlp_bwd"
        name = piece.replace("/", "_")
        out[key].update({f"{name}_ms": ms, f"{name}_bound_ms": bound, f"{name}_mm_ms": mm_ms})
    return out


def phase_vit_timing(gpu: str) -> dict:
    from cerebra_torch.models import vit_attn as va
    from cerebra_torch.models import vit_mlp as vm

    out = {}
    for B, N in VIT_SHAPES[:2]:
        x, dout, pa, pm, s_seq, s_rows = vit_inputs(B, N, torch.bfloat16, True, seed=1)
        xm, dm = x.reshape(B * N, D_VIT), dout.reshape(B * N, D_VIT)
        _, sa = va.attn_fwd(x, s_seq, pa, H_VIT)
        _, sm = vm.mlp_fwd(xm, s_rows, pm)
        # operations of the products on the bf16 tensor cores, M = B·N rows:
        # K5 qkv, proj and two attention products (QKᵀ, PV) over all heads;
        # K6 from the saved qkv: dWp and do, five attention products (S again,
        # dV, dP, dQ, dK), dWqkv and dy; K7 fc1 and fc2; K8 fc1 again, dW2,
        # dgh, dW1 and dy
        M, D, Fv = B * N, D_VIT, F_VIT
        rows = {
            "vit_attn_fwd": (lambda: va.attn_fwd(x, s_seq, pa, H_VIT),
                             lambda: va._attn_fwd_ref(x, s_seq, pa, H_VIT), (x, s_seq, pa),
                             8 * M * D * D + 4 * B * N * N * D),
            "vit_attn_bwd": (lambda: va.attn_bwd(dout, x, s_seq, pa, H_VIT, sa),
                             lambda: va._attn_bwd_ref(dout, x, s_seq, pa, H_VIT),
                             (dout, x, s_seq, pa, sa), 16 * M * D * D + 10 * B * N * N * D),
            "vit_mlp_fwd": (lambda: vm.mlp_fwd(xm, s_rows, pm),
                            lambda: vm._mlp_fwd_ref(xm, s_rows, pm), (xm, s_rows, pm),
                            4 * M * D * Fv),
            "vit_mlp_bwd": (lambda: vm.mlp_bwd(dm, xm, s_rows, pm, sm),
                            lambda: vm._mlp_bwd_ref(dm, xm, s_rows, pm), (dm, xm, s_rows, pm, sm),
                            10 * M * D * Fv),
        }
        for name, (kern, plain, inputs, flops) in rows.items():
            # no one PyTorch call computes LN + products + attention or GELU +
            # residual as one fused half-block: library none
            row = timing_row(kern, plain, inputs, flops, torch.bfloat16, 5, 5)
            log(f"[vit timing] {name} B={B} N={N} f32 stream/bf16: {fmt_row(row)}")
            if (B, N) == VIT_SHAPES[0]:
                out[name] = row
        cores = vit_pieces(B, N, x, dout, s_seq, pa, sa, gpu)
        mlp = mlp_pieces(B, N, xm, dm, s_rows, pm, sm, gpu)
        if (B, N) == VIT_SHAPES[0]:
            out["vit_attn_fwd"].update({k: v for k, v in cores.items() if "fwd" in k})
            out["vit_attn_bwd"].update({k: v for k, v in cores.items() if "fwd" not in k})
            for k, v in mlp.items():
                out[k].update(v)
        del x, dout, pa, pm, sa, sm, xm, dm
    return out


def phase_dino_step_timing(gpu: str) -> None:
    from contextlib import ExitStack
    from unittest import mock

    from cerebra_torch.models import vit, vit_attn, vit_mlp
    from cerebra_torch.train.dino_vit import DinoVitConfig, make_dino_vit

    cfg = DinoVitConfig(dtype=torch.bfloat16, epochs=2, warmup_epochs=1)
    B, views = cfg.batch_size_per_device, 2 + cfg.local_crops_number
    rng = np.random.default_rng(0)
    eeg = torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32)).to("cuda")
    profiled = False
    for kind in ("kernels", "plain", "kernels"):
        state, step, gen, _ = make_dino_vit(cfg, 80, torch.device("cuda"))
        with ExitStack() as stack:
            if kind == "plain":  # the blocks' fused calls through the plain versions
                stack.enter_context(mock.patch.object(
                    vit, "fused_attn_residual", vit_attn.fused_attn_residual_ref))
                stack.enter_context(mock.patch.object(
                    vit, "fused_mlp_residual", vit_mlp.fused_mlp_residual_ref))
            state, metrics = step(state, eeg, gen)
            torch.cuda.synchronize()
            # host clock over windows of 3 steps, each ended by reading the loss
            windows = []
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(3):
                    state, metrics = step(state, eeg, gen)
                loss = metrics["loss"].item()
                windows.append((time.perf_counter() - t0) / 3)
                if not math.isfinite(loss):
                    raise AssertionError(f"{kind} main_dino step loss is {loss}")
            if kind == "kernels" and not profiled:
                box = [state]

                def one_step():
                    box[0], _ = step(box[0], eeg, gen)

                profile_dino(one_step, 3, gpu)
                profiled = True
        windows.sort()
        dt = windows[1]
        log(f"[dino step] {kind}: {dt * 1e3:.2f} ms/step (median of 3 windows of 3 steps; "
            f"{windows[0] * 1e3:.2f}-{windows[-1] * 1e3:.2f}), {B / dt:.2f} samples/s, "
            f"{B * views / dt:.2f} views/s (ViT-S/8, 2x224 + 4x96, batch {B}, bf16) on {gpu}")
        del state, step
        torch.cuda.empty_cache()


def profile_dino(step, n: int, gpu: str) -> None:
    """`[dino profile]`: device ms per main_dino step of K5 and K6 (their
    attention cores apart), K7, K8 and the rest, and the device's idle share
    of the profiled wall time."""
    kernels, wall_ms, host = device_kernels(step, n, label_vit)

    def key(lab):
        if lab is None:
            return "rest"
        if lab[0] in ("K7", "K8"):
            return lab[0]
        return f"{lab[0]} {lab[1]}" if "core" in lab[1] else f"{lab[0]} other"

    parts = split_ms(kernels, label_vit([k for k, _ in kernels]), n, key)
    busy = sum(parts.values())
    log(f"[dino profile] {wall_ms:.2f} ms/step under the profiler, device busy {busy:.2f} ms "
        f"(idle {max(0.0, 1 - busy / wall_ms) * 100:.1f} %); by part "
        f"{ {k: round(v, 3) for k, v in sorted(parts.items(), key=lambda kv: -kv[1])} } on {gpu}")
    log(f"[dino profile] host ms per step by op, self time under the profiler (top 10 of "
        f"{sum(ms for _, ms in host):.1f}): {[(k[:40], round(ms, 2)) for k, ms in host[:10]]}")


def phase_ae_parity() -> dict:
    from unittest import mock

    from cerebra_torch.models import RecurrentAutoencoder
    from cerebra_torch.models import lstm as lstm_mod
    from cerebra_torch.models import lstm_stack as ls

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, (c, h) in AE_SHAPES.items():
            for B in (16, 13):
                tag = f"{str(dtype).split('.')[-1]} {name} B={B}"
                x, layers, g_last = make_stack(B, dtype, seed=B, C=c, H=h, L=1)
                g_full = torch.randn(T, B, h, generator=torch.Generator().manual_seed(B))
                e4 = compare(f"K4 h {tag}", ls.fwd_infer(x, layers), ls._fwd_infer_ref(x, layers),
                             dtype, False)
                res = ls._fwd_train_ref(x, layers)
                e2 = 0.0  # over the K2g forms; K2's (g at T-1, no dx) is checked, not counted
                for g, g_name in ((g_last, "g T-1"), (g_full.to("cuda", dtype), "g all t")):
                    for need_dx in (False, True):
                        form = f"{g_name}{' dx' if need_dx else ''}"
                        dx, got = ls.bwd(g, x, layers, *res, need_dx=need_dx)
                        want_dx, want = ls._bwd_ref(g, x, layers, *res, need_dx=need_dx)
                        pairs = list(zip(("dW_ih", "dW_hh", "db"), got[0], want[0]))
                        if need_dx:
                            pairs.append(("dx", dx, want_dx))
                        e = max(compare(f"K2 {form} {n} {tag}", a, b, dtype, True)
                                for n, a, b in pairs)
                        if g is not g_last or need_dx:
                            e2 = max(e2, e)
                if dtype == torch.bfloat16 and name == "encoder" and B == B_AE:
                    errs = {"fwd_infer": e4, "bwd_general": e2}
                del x, layers, g_last, g_full, res
        # the full-width model: every gradient of a loss on both outputs
        tag = f"{str(dtype).split('.')[-1]} RecurrentAutoencoder(460, 96, 384) B={B_AE}"
        gen = torch.Generator().manual_seed(3)
        eeg = torch.randn(B_AE, T, C, generator=gen).cuda()
        w_enc = torch.randn(B_AE, E_AE, generator=gen).cuda()
        w_dec = torch.randn(B_AE, T, C, generator=gen).cuda()
        outs = []
        for stack_fn in (ls.lstm_stack, ls.lstm_stack_ref):
            model = RecurrentAutoencoder(T, C, E_AE, dtype=dtype, device="cuda",
                                         generator=torch.Generator().manual_seed(0))
            with mock.patch.object(lstm_mod, "lstm_stack", stack_fn):
                enc, dec = model(eeg)
                ((enc.float() * w_enc).sum() + (dec.float() * w_dec).sum()).backward()
            outs.append([enc, dec] + [p.grad for p in model.parameters()])
        names = ["encoded", "decoded"] + [n for n, _ in model.named_parameters()]
        for n, a, b in zip(names, *outs):
            compare(f"AE {n} {tag}", a, b, dtype, n not in ("encoded", "decoded"), TOL_AE)
        del model, outs, eeg
    torch.cuda.synchronize()
    return errs


def phase_ae_train(gpu: str) -> tuple:
    from unittest import mock

    from cerebra_torch.data import make_synthetic_corpus
    from cerebra_torch.kernels import LAUNCHES, reset_launches
    from cerebra_torch.models import RecurrentAutoencoder, feature_matching_loss
    from cerebra_torch.models import lstm as lstm_mod
    from cerebra_torch.models import lstm_stack as ls
    from cerebra_torch.train.optim import make_optimizer
    from cerebra_torch.train.steps import feature_distill_step

    steps = 10
    corpus = make_synthetic_corpus(seed=0, n_per_class=4, n_classes=N_CLASSES, n_channels=C,
                                   n_samples=T_RAW, feature_dim=E_AE).window(T_LO, T_HI)
    dev = torch.device("cuda")
    eeg = torch.from_numpy(corpus.eeg).to(dev)  # (N, T, C)
    feats = torch.from_numpy(corpus.image_features).to(dev)
    labels = torch.from_numpy(corpus.labels).to(dev)
    order = np.random.default_rng(0).permutation(len(labels))

    def loss_fn(f, c, t, y, e):
        return feature_matching_loss(f.float(), t)

    def make():
        model = RecurrentAutoencoder(T, C, E_AE, dtype=torch.bfloat16, device=dev,
                                     generator=torch.Generator().manual_seed(0))
        return model, make_optimizer("rmsprop", model.parameters(), 1e-3)

    model, opt = make()
    reset_launches()
    t0 = time.perf_counter()
    losses = []
    for i in range(steps):
        idx = torch.from_numpy(order[i * B_AE:(i + 1) * B_AE]).to(dev)
        losses.append(feature_distill_step(model, opt, loss_fn, eeg[idx], feats[idx],
                                           labels[idx], 0))
    with torch.no_grad():
        enc, dec = model(eeg[:B_AE])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    losses = [v.item() for v in losses]
    log(f"[ae train] {steps} steps + 1 forward in {seconds:.2f} s, losses "
        f"{[round(v, 5) for v in losses]}, launches {launches}")
    if not all(math.isfinite(v) for v in losses) or not torch.isfinite(dec.float()).all():
        raise AssertionError(f"non-finite losses or reconstruction: {losses}")
    if tuple(enc.shape) != (B_AE, E_AE) or tuple(dec.shape) != (B_AE, T, C):
        raise AssertionError(f"encoded {tuple(enc.shape)}, decoded {tuple(dec.shape)}")
    # every K1 and K4 of the model (1 layer each) is one input product and
    # one cluster scan (pick_fwd takes both widths at B = 16)
    want = {"fwd_train": 2 * steps, "bwd_general": steps, "stack_bwd_scan": steps,
            "stack_bwd_products": steps, "fwd_infer": 2, "bwd": 0, "fwd_infer_last": 0,
            "bwd_rc": 0, "rc_scan": 0, "fwd_in_product": 2 * steps + 2,
            "fwd_cluster_scan": 2 * steps + 2, "fwd_wave": 0, "fwd_wave_split": 0}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"launches {launches}, expected {want}")

    batch = (eeg[:B_AE], feats[:B_AE], labels[:B_AE], 0)
    profiled = False
    for kind in ("kernels", "plain", "kernels"):
        model, opt = make()
        with mock.patch.object(lstm_mod, "lstm_stack",
                               ls.lstm_stack if kind == "kernels" else ls.lstm_stack_ref):
            loss = feature_distill_step(model, opt, loss_fn, *batch)
            torch.cuda.synchronize()
            n = 5 if kind == "kernels" else 2
            t0 = time.perf_counter()
            for _ in range(n):
                loss = feature_distill_step(model, opt, loss_fn, *batch)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / n
            if kind == "kernels" and not profiled:
                profile_steps(lambda: feature_distill_step(model, opt, loss_fn, *batch), 3,
                              f"ae step B={B_AE}", gpu)
                profiled = True
        if not math.isfinite(loss.item()):
            raise AssertionError(f"{kind} ae step loss is {loss.item()}")
        log(f"[ae step] {kind}: {dt * 1e3:.2f} ms/step, {B_AE / dt:.1f} trials/s "
            f"(RecurrentAutoencoder(460, 96, 384) fwd/bwd + RMSprop, bf16, batch {B_AE}) on {gpu}")

    times = {}
    for name, (c, h) in AE_SHAPES.items():
        x, layers, _ = make_stack(B_AE, torch.bfloat16, seed=5, C=c, H=h, L=1)
        res = ls.fwd_train(x, layers)
        g = torch.randn(T, B_AE, h, device=dev).to(torch.bfloat16)
        dx = name == "decoder"  # the decoder's input (the repeated latent) needs dx
        rows = {
            "fwd_train": (lambda: ls.fwd_train(x, layers), lambda: ls._fwd_train_ref(x, layers),
                          (x, layers), stack_flops(T, B_AE, c, h, 1),
                          cudnn_ms(T, B_AE, c, h, 1, "train")),
            "fwd_infer": (lambda: ls.fwd_infer(x, layers), lambda: ls._fwd_infer_ref(x, layers),
                          (x, layers), stack_flops(T, B_AE, c, h, 1),
                          cudnn_ms(T, B_AE, c, h, 1, "infer")),
            "bwd_general": (lambda: ls.bwd(g, x, layers, *res, need_dx=dx),
                            lambda: ls._bwd_ref(g, x, layers, *res, need_dx=dx),
                            (g, x, layers, res),
                            stack_flops(T, B_AE, c, h, 1, fwd=False, bwd=True, need_dx=dx),
                            cudnn_ms(T, B_AE, c, h, 1, "bwd_seq")),
        }
        pieces = {k: time_ms(v[0], 5) for k, v in bwd_pieces(g, x, layers, res, dx).items()}
        for kname, (kern, plain, inputs, flops, lib) in rows.items():
            row = timing_row(kern, plain, inputs, flops, torch.bfloat16, 5, 2, lib)
            split = (f"; its scan {pieces['scan']:.3f} ms, its products "
                     f"{pieces['products']:.3f} ms" if kname == "bwd_general" else "")
            n = ls.pick_fwd(B_AE, c, h, 1, torch.bfloat16) if kname.startswith("fwd") else 0
            log(f"[ae timing] {kname} {name} C={c} H={h} B={B_AE} T={T} bf16"
                f"{' (g all t, dx)' if kname == 'bwd_general' and dx else ''}"
                f"{' (g all t)' if kname == 'bwd_general' and not dx else ''}"
                f"{f' (clusters of {n})' if n else ''}: {fmt_row(row)}{split}")
            if name == "encoder" and kname != "fwd_train":  # K1's row is the CLI's
                times[kname] = row
        del x, layers, res, g
    return launches, times


def phase_fwd_paths(gpu: str) -> tuple:
    """Phase 11: K1 at the autoencoder's widths (K4's parity is phase 9's)
    and the layer-by-layer path's two pieces alone against their plain
    versions; the `[fwd paths]` sweep; the pieces' timing rows."""
    from cerebra_torch.models import lstm_stack as ls

    errs = {"fwd_in_product": 0.0, "fwd_cluster_scan": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for name, (c, h) in AE_SHAPES.items():
            for B in (16, 13):
                tag = f"{str(dtype).split('.')[-1]} {name} B={B}"
                x, layers, _ = make_stack(B, dtype, seed=B + 1, C=c, H=h, L=1)
                n = ls.pick_fwd(B, c, h, 1, dtype)
                if not n:
                    raise AssertionError(f"pick_fwd leaves the autoencoder's {tag} to lstm_fwd_kernel")
                want = ls._fwd_train_ref(x, layers)
                for k, a, b in zip(("h_all", "prefac", "qf"), ls.fwd_train(x, layers), want):
                    compare(f"K1 {k} {tag} (clusters of {n})", a, b, dtype, False)
                w_ih, w_hh, bias = layers[0]
                P = ls._in_product_ref(x, w_ih)
                ep = compare(f"K1/K4 input product {tag}", ls.fwd_in_product(x, w_ih), P,
                             torch.float32, True)  # f32 sums of exact products
                es = 0.0
                for m in ls.cluster_sizes(h, dtype):
                    for res in (False, True):
                        for k, a, b in zip(("h", "prefac", "qf"),
                                           ls.fwd_cluster_scan(P, w_hh, bias, res, m),
                                           ls._fwd_scan_ref(P, w_hh, bias, res)):
                            if b is not None:
                                es = max(es, compare(f"K1/K4 cluster scan {k} {tag} n={m}"
                                                     f"{' res' if res else ''}", a, b, dtype,
                                                     False, quiet=True))
                log(f"[parity] K1/K4 cluster scan {tag}: every cluster size "
                    f"{ls.cluster_sizes(h, dtype)}, with and without residuals, within its "
                    f"limit; max_abs at most {es:.3e}")
                if dtype == torch.bfloat16 and name == "encoder" and B == B_AE:
                    errs = {"fwd_in_product": ep, "fwd_cluster_scan": es}
                del x, layers, want, P
    torch.cuda.synchronize()

    bf16 = torch.bfloat16
    kinds = ("fwd_train", "fwd_infer", "fwd_infer_last", "fwd_train_rc")
    # the cluster sizes' order differs between the bf16 (tensor-core) and
    # the f32 (FMA) step, so the small batches run in both; every forward
    # through every path it can take, the split layer also for K1 and K3
    # (which fwd_path does not send there: a record)
    for (B, c, h, l_, t_), dtype in [(s, d) for s in FWD_SHAPES for d in (bf16, torch.float32)
                                     if d == bf16 or s[0] <= B_AE]:
        x, layers, _ = make_stack(B, dtype, seed=6, C=c, H=h, L=l_, T=t_)
        ms = {}
        for kind in kinds:
            ms[f"{kind} lstm_fwd_kernel"] = round(time_ms(lambda: ls._fwd_cuda(x, layers, kind), 3), 3)
            if kind in ("fwd_train", "fwd_infer"):
                for n in ls.cluster_sizes(h, dtype):
                    ms[f"{kind} n={n}"] = round(
                        time_ms(lambda: ls._fwd_cluster_cuda(x, layers, kind, n), 3), 3)
            if ls.wave_fits(c, h, l_, dtype):
                ms[f"{kind} wave"] = round(
                    time_ms(lambda: ls._fwd_wave_cuda(x, layers, kind), 3), 3)
            if ls.wave_split_fits(c, h, l_, dtype):  # at each tile that fits
                for mt in range(1, ls._WAVE_SPLIT_TILES + 1):
                    if ls.wave_split_smem(c, h, mt) <= ls._MAX_SMEM:
                        ms[f"{kind} split mt={mt}"] = round(
                            time_ms(lambda: ls._fwd_wave_cuda(x, layers, kind, True, mt), 3), 3)
        paths = {k: ls.fwd_path(B, c, h, l_, dtype, k) for k in kinds}
        tiles = ""
        if ls.wave_split_fits(c, h, l_, dtype):
            q = [ls.wave_clusters(c, h, l_, True, mt) for mt in range(1, ls._WAVE_SPLIT_TILES + 1)
                 if ls.wave_split_smem(c, h, mt) <= ls._MAX_SMEM]
            tiles = (f", split clusters at once by row tiles {q}, split_tiles picks "
                     f"{ls.wave_split_tiles(B, c, h, l_)}")
        log(f"[fwd paths] B={B} C={c} H={h} L={l_} T={t_} {str(dtype).split('.')[-1]}: ms {ms}; "
            f"fwd_path takes {paths} (clusters of {ls.pick_fwd(B, c, h, l_, dtype)}{tiles}) on {gpu}")
        del x, layers

    # the pieces alone at the encoder's width, as the AE step runs them (K1's
    # scan, with residuals)
    c, h = AE_SHAPES["encoder"]
    x, layers, _ = make_stack(B_AE, bf16, seed=7, C=c, H=h, L=1)
    w_ih, w_hh, bias = layers[0]
    P = ls.fwd_in_product(x, w_ih)
    n = ls.pick_fwd(B_AE, c, h, 1, bf16)
    x2 = x.view(T * B_AE, c)
    lib_product = time_windows(lambda: torch.mm(x2, w_ih, out_dtype=torch.float32), 5, 5, 3)[0]
    rows = {
        "fwd_in_product": (lambda: ls.fwd_in_product(x, w_ih), lambda: ls._in_product_ref(x, w_ih),
                           (x, w_ih), 2 * T * B_AE * c * 4 * h, lib_product),
        "fwd_cluster_scan": (lambda: ls.fwd_cluster_scan(P, w_hh, bias, True, n),
                             lambda: ls._fwd_scan_ref(P, w_hh, bias, True), (P, w_hh, bias),
                             2 * T * B_AE * h * 4 * h,
                             cudnn_ms(T, B_AE, 4 * h, h, 1, "train", scan=True)),
    }
    times = {}
    for name, (kern, plain, inputs, flops, lib) in rows.items():
        times[name] = timing_row(kern, plain, inputs, flops, bf16, 5, 2, lib)
        log(f"[fwd timing] {name} encoder C={c} H={h} B={B_AE} T={T} bf16 (clusters of {n}; "
            f"library: {'torch.mm to f32' if name == 'fwd_in_product' else 'cuDNN LSTM(4H, H) with weight_ih = I'}): "
            f"{fmt_row(times[name])}")
    del x, layers, P
    return errs, times


def stack_grad_call(fn, x: torch.Tensor, layers):
    """The lab's rcstack step: the gradient of Σ h_top[T−1]² through `fn` in
    x and every weight, all requiring grad."""
    xs = x.detach().requires_grad_(True)
    ws = [tuple(w.detach().requires_grad_(True) for w in layer) for layer in layers]
    flat = [xs] + [w for layer in ws for w in layer]

    def call():
        return torch.autograd.grad((fn(xs, ws)[-1].float() ** 2).sum(), flat)
    return call


def cudnn_grad_call(T_: int, B: int, C_: int, H_: int, L_: int):
    """The same gradient through torch.nn.LSTM (cuDNN) in `cudnn_dtype()`."""
    dt = cudnn_dtype()
    lstm = cudnn_lstm(C_, H_, L_, dt, False)
    xs = torch.randn(T_, B, C_, generator=torch.Generator().manual_seed(9)).to(
        "cuda", dt).requires_grad_(True)
    flat = [xs] + list(lstm.parameters())

    def call():
        return torch.autograd.grad((lstm(xs)[0][-1].float() ** 2).sum(), flat)
    return call


def peak_mib(call) -> tuple:
    """(peak device memory of one call above what was allocated before it,
    the peak in all), MiB, from reset_peak_memory_stats and
    max_memory_allocated."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    return (peak - base) / 2**20, peak / 2**20


RC_PIECES = ("rc_gates", "rc_scan", "rc_products")


def rc_piece_calls(g, x, layers, res) -> dict:
    """K11's three pieces as `bwd_rc` runs them, over every time chunk and
    layer, each on the inputs it gets there: one run of the chunked
    composition through the pieces' dispatching wrappers (fresh outputs, so
    every recorded input stays), recorded. → {name: (kernel wrapper, plain
    version, [argument lists])}; a scan's carry is recorded as it was read."""
    from cerebra_torch.models import lstm_stack as ls

    T_, B, _ = x.shape
    calls = {name: [] for name in RC_PIECES}

    def rec(name, fn):
        def call(*args):
            args = list(args)
            if name == "rc_scan":
                args[5] = args[5].clone()
            calls[name].append(args)
            return fn(*args)
        return call

    pieces = ls._RcPieces(rec("rc_gates", ls.rc_gates), rec("rc_scan", ls.rc_scan),
                          rec("rc_products", ls.rc_products),
                          lambda part: part.sum(0))  # not timed
    group = ls.rc_group(B)
    ls._bwd_rc_chunked(g, x, layers, *res, ls.rc_chunk(T_, B, group), group, pieces)
    plain = {"rc_gates": ls._rc_gates_ref, "rc_scan": ls._rc_scan_ref,
             "rc_products": ls._rc_products_ref}
    kern = {"rc_gates": ls.rc_gates, "rc_scan": ls.rc_scan, "rc_products": ls.rc_products}
    return {name: (kern[name], plain[name], calls[name]) for name in RC_PIECES}


def check_rc_pieces(calls: dict, tag: str, dtype) -> dict:
    """Each recorded call of K11's pieces through the kernel and the plain
    version on the same inputs (fresh outputs, a copy of the scan's carry,
    both carries compared after), one line a piece: the largest error of
    each piece."""
    errs = dict.fromkeys(RC_PIECES, 0.0)
    for name, (kern, plain, arg_lists) in calls.items():
        for k, args in enumerate(arg_lists):
            args = list(args)
            if name == "rc_products":
                args[6:] = [None, None]  # fresh partials and chain
            got_args, want_args = list(args), list(args)
            if name == "rc_scan":
                got_args[5], want_args[5] = args[5].clone(), args[5].clone()
            got, want = kern(*got_args), plain(*want_args)
            if name == "rc_gates":
                pairs = [("gates", got, want, torch.float32, True)]
            elif name == "rc_scan":
                # the f32 carries sum products of the rounded dgates: the
                # stream dtype's limit
                pairs = [("dgates", got, want, dtype, True),
                         ("carry", got_args[5], want_args[5], dtype, True)]
            else:
                pairs = [("dW partials", got[0], want[0], dtype, True),
                         (args[4], got[1], want[1], dtype, True)]
            for what, a, b, dt, grad in pairs:
                e = compare(f"K11 {name}[{k}] {what} {tag}", a, b, dt, grad, quiet=True)
                errs[name] = max(errs[name], e)
        log(f"[parity] K11 {name} {tag}: {len(arg_lists)} calls (every chunk and layer) "
            f"within their limits, max_abs at most {errs[name]:.3e}")
    torch.cuda.synchronize()
    return errs


def rc_piece_rows(calls: dict, dtype, plain_reps: int = 1) -> dict:
    """Timing rows of K11's pieces, each over all its recorded calls: the
    operations of their matrix products (the gates' inp·W_ih and h·W_hh,
    the scans' dgates·W_hhᵀ, the products' dW_ih, dW_hh and chain) and the
    tensors they read and write; library none (no one PyTorch call computes
    a piece over the chunks)."""
    rows = {}
    for name, (kern, plain, arg_lists) in calls.items():
        ops = 0
        for args in arg_lists:
            if name == "rc_gates":
                (n_, B_, in_), (n_h, _, H_) = args[0].shape, args[1].shape
                ops += 2 * B_ * 4 * H_ * (n_ * in_ + n_h * H_)
            elif name == "rc_scan":
                n_, B_, G_ = args[1].shape  # the gates
                ops += 2 * n_ * B_ * G_ * (G_ // 4)
            elif name == "rc_products":
                n_, B_, G_ = args[0].shape
                ops += 2 * n_ * B_ * G_ * (2 * args[1].shape[-1] + G_ // 4)
        inputs = [[a for a in (args[:6] if name == "rc_products" else args)
                   if isinstance(a, torch.Tensor)] for args in arg_lists]
        rows[name] = timing_row(lambda: [kern(*a) for a in arg_lists],
                                lambda: [plain(*a) for a in arg_lists], inputs, ops, dtype, 3,
                                plain_reps)
    return rows


def phase_rc(gpu: str) -> tuple:
    """Phase 12: K10/K11 and K4 against their plain versions (in bf16 K10
    and K4 on the wavefront forward at the headline widths, on its split
    layer at the DINO widths); K11's pieces alone against theirs; the lab's
    rcstack comparison (ms and peak memory of the shipped stack, the
    recompute stack and cuDNN); each kernel and piece alone; K11 at each
    time chunk; the launch checks at both widths."""
    from cerebra_torch.kernels import LAUNCHES, reset_launches
    from cerebra_torch.models import lstm_stack as ls

    bf16 = torch.bfloat16
    errs = {}
    # the JSON line's name of K10's and K4's row at each width (bf16, B_BIG)
    rows_of = {"headline": ("fwd_train_rc", "fwd_infer_wave"),
               "dino": ("fwd_train_rc_split", "fwd_infer_split")}
    for dtype in (torch.float32, bf16):
        for shape, B in (("headline", B_BIG), ("headline", 13), ("dino", B_BIG), ("dino", 16),
                         ("dino", 13)):
            T_, C_, H_, L_ = RC_SHAPES[shape]
            tag = f"{str(dtype).split('.')[-1]} {shape} C={C_} H={H_} L={L_} T={T_} B={B}"
            x, layers, _ = make_stack(B, dtype, seed=B, C=C_, H=H_, L=L_, T=T_)
            g = torch.randn(T_, B, H_, generator=torch.Generator().manual_seed(B)).to(
                "cuda", dtype)
            want = ls._fwd_train_rc_ref(x, layers)
            path = {k: ls.fwd_path(B, C_, H_, L_, dtype, k) for k in ("fwd_train_rc", "fwd_infer")}
            e10 = max(compare(f"K10 {n} {tag} ({path['fwd_train_rc']})", a, b, dtype, False)
                      for n, a, b in zip(("h_all", "c_all"), ls.fwd_train_rc(x, layers), want))
            e4 = compare(f"K4 h {tag} ({path['fwd_infer']})", ls.fwd_infer(x, layers),
                         ls._fwd_infer_ref(x, layers), dtype, False)
            dx, got = ls.bwd_rc(g, x, layers, *want)  # on the plain residuals: K11 alone
            want_dx, want_g = ls._bwd_rc_ref(g, x, layers, *want)
            pairs = [("dx", dx, want_dx)] + [
                (f"{n}[{l}]", a, b) for l in range(L_)
                for n, a, b in zip(("dW_ih", "dW_hh", "db"), got[l], want_g[l])]
            e11 = max(compare(f"K11 {n} {tag}", a, b, dtype, True) for n, a, b in pairs)
            if B == B_BIG and shape == "headline":
                pieces = check_rc_pieces(rc_piece_calls(g, x, layers, want), tag, dtype)
            if dtype == bf16 and B == B_BIG:
                errs.update(dict(zip(rows_of[shape], (e10, e4))))
                if shape == "headline":
                    errs.update({"bwd_rc": e11, **pieces})
            del x, layers, g, want, dx, got, want_dx, want_g, pairs
    torch.cuda.synchronize()
    log(f"[rc] clusters the card holds at once: the wavefront forward at the headline widths "
        f"{ls.wave_clusters(96, 96, 2)}, its split layer at the DINO widths "
        f"{ls.wave_clusters(96, 128, 4, split=True)}")

    times = {}
    for shape, (T_, C_, H_, L_) in RC_SHAPES.items():
        tag = f"{shape} C={C_} H={H_} L={L_} T={T_} B={B_BIG} bf16"
        x, layers, _ = make_stack(B_BIG, bf16, seed=7, C=C_, H=H_, L=L_, T=T_)
        for name, call in (("shipped K1+K2g", stack_grad_call(ls.lstm_stack, x, layers)),
                           ("recompute K10+K11", stack_grad_call(ls.lstm_stack_rc, x, layers)),
                           (f"cuDNN {str(cudnn_dtype()).split('.')[-1]}",
                            cudnn_grad_call(T_, B_BIG, C_, H_, L_))):
            ms = time_ms(call, 3)
            own, total = peak_mib(call)
            log(f"[rcstack] {tag} {name}: {ms:.3f} ms, peak {own:.1f} MiB above the inputs "
                f"({total:.1f} MiB in all) on {gpu}")
            del call
        res = ls.fwd_train_rc(x, layers)
        g = torch.randn(T_, B_BIG, H_, generator=torch.Generator().manual_seed(8)).to(
            "cuda", bf16)
        rows = {
            "fwd_train_rc": (lambda: ls.fwd_train_rc(x, layers),
                             lambda: ls._fwd_train_rc_ref(x, layers), (x, layers),
                             stack_flops(T_, B_BIG, C_, H_, L_),
                             cudnn_ms(T_, B_BIG, C_, H_, L_, "train", 3)),
            "fwd_infer": (lambda: ls.fwd_infer(x, layers), lambda: ls._fwd_infer_ref(x, layers),
                          (x, layers), stack_flops(T_, B_BIG, C_, H_, L_),
                          cudnn_ms(T_, B_BIG, C_, H_, L_, "infer", 3)),
            "bwd_rc": (lambda: ls.bwd_rc(g, x, layers, *res),
                       lambda: ls._bwd_rc_ref(g, x, layers, *res), (g, x, layers, res),
                       stack_flops(T_, B_BIG, C_, H_, L_, fwd=True, bwd=True, need_dx=True),
                       cudnn_ms(T_, B_BIG, C_, H_, L_, "bwd_seq", 3)),
        }
        group = ls.rc_group(B_BIG)
        chunk = ls.rc_chunk(T_, B_BIG, group)
        setting = (f"scan tile {ls.scan_tile(B_BIG, H_, bf16)}, chunk {chunk}, dW group {group}")
        names = dict(zip(("fwd_train_rc", "fwd_infer"), rows_of[shape]))
        for name, (kern, plain, inputs, flops, lib) in rows.items():
            row = timing_row(kern, plain, inputs, flops, bf16, 3, 1, lib)
            split = ""
            if name in names:  # K10 and K4: the path taken, and lstm_fwd_kernel alone
                old = time_ms(lambda: ls._fwd_cuda(x, layers, name), 3)
                path = ls.fwd_path(B_BIG, C_, H_, L_, bf16, name)
                if path == "split":
                    path += f" ({ls.wave_split_tiles(B_BIG, C_, H_, L_)} row tiles a cluster)"
                split = (f"; path {path}, lstm_fwd_kernel {old:.3f} ms (tile "
                         f"{ls.pick_tile(B_BIG, C_, H_, L_)})")
            log(f"[rc timing] {name} {tag} ({setting}): {fmt_row(row)}{split}")
            if name in names:
                times[names[name]] = row
            elif shape == "headline":
                times[name] = row
        piece_rows = rc_piece_rows(rc_piece_calls(g, x, layers, res), bf16)
        for name, row in piece_rows.items():
            log(f"[rc timing] {name} {tag} (over {-(-T_ // chunk)} chunks x {L_} layers): "
                f"{fmt_row(row)}")
            if shape == "headline":
                times[name] = row
        sweep = {}
        for c in sorted({8, 16, 32, 48, 64, 96, 128, chunk, T_}):
            c = -(-c // group) * group
            call = functools.partial(ls._bwd_rc_cuda, g, x, layers, *res, chunk=c)
            sweep[c] = (round(time_ms(call, 3), 3), round(peak_mib(call)[0], 1))
        log(f"[rc chunks] {tag}: chunk steps -> (K11 ms, K11 peak MiB above its inputs) "
            f"{sweep}; rc_chunk picks {chunk} on {gpu}")
        # the shipped pair beside them, with the gradients' cotangent (at T-1
        # only) for both backwards
        g[:-1] = 0
        res1 = ls.fwd_train(x, layers)
        pieces = {k: time_ms(v[0], 3)
                  for k, v in bwd_pieces(g, x, layers, res1, True).items()}
        # K2g as lstm_stack's gradient runs it here, beside the cuDNN backward
        # of a loss on the output with dx at the same shape (the bwd_rc row's)
        k2g = timing_row(lambda: ls.bwd(g, x, layers, *res1, need_dx=True),
                         lambda: ls._bwd_ref(g, x, layers, *res1, need_dx=True),
                         (g, x, layers, res1),
                         stack_flops(T_, B_BIG, C_, H_, L_, fwd=False, bwd=True, need_dx=True),
                         bf16, 3, 1, rows["bwd_rc"][4])
        log(f"[rc timing] {tag}: K1 {time_ms(lambda: ls.fwd_train(x, layers), 3):.3f} ms "
            f"({ls.fwd_path(B_BIG, C_, H_, L_, bf16, 'fwd_train')}), "
            f"K10 {time_ms(lambda: ls.fwd_train_rc(x, layers), 3):.3f} ms; g at T-1 only: "
            f"K2g with dx {fmt_row(k2g)} (its {L_} scans {pieces['scan']:.3f} ms, its "
            f"products {pieces['products']:.3f} ms), K11 "
            f"{time_ms(lambda: ls.bwd_rc(g, x, layers, *res), 3):.3f} ms")
        del x, layers, res, res1, g, piece_rows

    # the main path at both widths: one grad and one no-grad call, K10 and K4
    # on the wavefront forward (headline) or its split layer (DINO)
    launches = {}
    for shape, wave in (("headline", "fwd_wave"), ("dino", "fwd_wave_split")):
        T_, C_, H_, L_ = RC_SHAPES[shape]
        x, layers, _ = make_stack(B_BIG, bf16, seed=11, C=C_, H=H_, L=L_, T=T_)
        call = stack_grad_call(ls.lstm_stack_rc, x, layers)
        reset_launches()
        grads = call()
        with torch.no_grad():
            h = ls.lstm_stack_rc(x, layers)
        torch.cuda.synchronize()
        n = dict(LAUNCHES)
        log(f"[rc] one grad and one no-grad call of lstm_stack_rc, {shape} B={B_BIG}: "
            f"launches {n}")
        per_piece = -(-T_ // ls.rc_chunk(T_, B_BIG, ls.rc_group(B_BIG))) * L_
        want = {"fwd_train_rc": 1, "bwd_rc": 1, "fwd_infer": 1, "fwd_train": 0, "bwd_general": 0,
                "stack_bwd_scan": 0, "fwd_cluster_scan": 0, "fwd_wave": 0, "fwd_wave_split": 0,
                wave: 2, **dict.fromkeys(RC_PIECES, per_piece)}
        if {k: n[k] for k in want} != want:
            raise AssertionError(f"launches {n}, expected {want}")
        if tuple(h.shape) != (T_, B_BIG, H_) or not all(torch.isfinite(t).all()
                                                        for t in (h, *grads)):
            raise AssertionError("lstm_stack_rc gave a wrong shape or non-finite values")
        k10, k4 = rows_of[shape]
        launches.update({k10: n["fwd_train_rc"], k4: n["fwd_infer"]})
        if shape == "headline":
            launches.update({k: n[k] for k in ("bwd_rc", *RC_PIECES)})
        del x, layers, call, grads, h
    return errs, times, launches


def phase_scan(gpu: str) -> tuple:
    """Phase 13: K12-K14 and lstm_scan's two gradients against the plain
    versions; in bf16 K12 and K13 on the scan's wavefront forward with one
    and with two CTAs a tile against its plain composition and the plain
    versions, and K14 on its residuals; the lab's baseline (forward alone,
    forward + backward of Σ h_all) through the kernels and the plain
    versions; each kernel alone; `[scan paths]`: K12 and K13 through
    scan_fwd_kernel and the wavefront forward at each CTA count; the launch
    check in bf16 (the wavefront forward) and in f32 (scan_fwd_kernel)."""
    from cerebra_torch.kernels import LAUNCHES, reset_launches
    from cerebra_torch.models import lstm_scan as sc
    from cerebra_torch.models import lstm_stack as ls

    bf16 = torch.bfloat16

    def case(B, dtype, seed):
        gen = torch.Generator().manual_seed(seed)
        x_proj = (torch.randn(T, B, 4 * H_SCAN, generator=gen) * 0.5).to("cuda", dtype)
        w_hh = ((torch.rand(H_SCAN, 4 * H_SCAN, generator=gen) * 2 - 1)
                / math.sqrt(H_SCAN)).to("cuda", dtype)
        g = torch.randn(T, B, H_SCAN, generator=gen).to("cuda", dtype)
        return x_proj, w_hh, g

    def grads(fn, x_proj, w_hh, g=None):
        xs, ws = x_proj.detach().requires_grad_(True), w_hh.detach().requires_grad_(True)
        h = fn(xs, ws)
        return torch.autograd.grad(h.float().sum() if g is None else (h * g).sum(), (xs, ws))

    errs = {}
    for dtype in (torch.float32, bf16):
        for B in (B_BIG, 16, 13):
            tag = f"{str(dtype).split('.')[-1]} H={H_SCAN} T={T} B={B}"
            x_proj, w_hh, g = case(B, dtype, B)
            route = f"ns {sc.scan_ns(B, H_SCAN, dtype)}"
            e12 = compare(f"K12 h_all {tag} ({route})", sc.scan_fwd_infer(x_proj, w_hh),
                          sc._scan_fwd_infer_ref(x_proj, w_hh), dtype, False)
            want = sc._scan_fwd_train_ref(x_proj, w_hh)
            e13 = max(compare(f"K13 {n} {tag} ({route})", a, b, dtype, False) for n, a, b in
                      zip(("h_all", "prefac", "qf"), sc.scan_fwd_train(x_proj, w_hh), want))
            e14 = compare(f"K14 dgates {tag}", sc.scan_bwd(g, *want[1:], w_hh),
                          sc._scan_bwd_ref(g, *want[1:], w_hh), dtype, True)
            want_d = grads(sc.lstm_scan_ref, x_proj, w_hh, g)
            for n, a, b in zip(("d x_proj", "d w_hh"), grads(sc.lstm_scan, x_proj, w_hh, g),
                               want_d):
                compare(f"lstm_scan {n} {tag}", a, b, dtype, True)
            if dtype == bf16:
                # the wavefront forward at each CTA count: against its plain
                # composition and the plain versions, and K14 on its residuals
                for ns in (1, 2):
                    wtag = f"{tag} (wavefront, {ns} CTA{'s' if ns > 1 else ''} a tile)"
                    comp = sc._scan_wave_ref(x_proj, w_hh, True, ns)
                    got = sc._fwd_cuda(x_proj, w_hh, False, ns=ns)
                    for ref, against in ((comp[0], "its composition"), (want[0], "plain")):
                        compare(f"K12 h_all {wtag} vs {against}", got, ref, dtype, False)
                    got = sc._fwd_cuda(x_proj, w_hh, True, ns=ns)
                    for ref, against in ((comp, "its composition"), (want, "plain")):
                        for n, a, b in zip(("h_all", "prefac", "qf"), got, ref):
                            compare(f"K13 {n} {wtag} vs {against}", a, b, dtype, False)
                    compare(f"K14 dgates on K13's residuals, {wtag}", sc.scan_bwd(g, *got[1:], w_hh),
                            sc._scan_bwd_ref(g, *got[1:], w_hh), dtype, True)
                    del comp, got
            if dtype == torch.float32 and B == 13:
                # the library column's call computes lstm_scan's function
                lstm = cudnn_lstm(4 * H_SCAN, H_SCAN, 1, dtype, scan=True)
                with torch.no_grad():
                    lstm.weight_hh_l0.copy_(w_hh.t())
                xs = x_proj.detach().requires_grad_(True)
                h = lstm(xs)[0]
                d_x, d_wT = torch.autograd.grad(h, (xs, lstm.weight_hh_l0), g)
                for n, a, b in (("h_all", h, sc._scan_fwd_infer_ref(x_proj, w_hh)),
                                ("d x_proj", d_x, want_d[0]), ("d w_hh", d_wT.t(), want_d[1])):
                    compare(f"cuDNN LSTM(4H, H) with weight_ih = I: {n} {tag}", a, b, dtype,
                            n != "h_all", TOL_CUDNN_SCAN)
                del lstm, xs, h, d_x, d_wT
            if B == B_BIG:  # bf16: the wavefront forward's rows; f32: scan_fwd_kernel's
                wave = "_wave" if dtype == bf16 else ""
                errs.update({f"scan_fwd_infer{wave}": e12, f"scan_fwd_train{wave}": e13})
                if dtype == bf16:
                    errs["scan_bwd"] = e14
            del x_proj, w_hh, g, want, want_d
    torch.cuda.synchronize()

    times = {}
    cudnn_call = {"scan_fwd_infer": "infer", "scan_fwd_train": "train", "scan_bwd": "bwd_seq"}
    for dtype in (torch.float32, bf16):
        tag = f"{str(dtype).split('.')[-1]} H={H_SCAN} T={T} B={B_BIG}"
        x_proj, w_hh, g = case(B_BIG, dtype, 5)
        for what, kern, plain in (
                ("fwd", lambda: sc.lstm_scan(x_proj, w_hh), lambda: sc.lstm_scan_ref(x_proj, w_hh)),
                ("fwd+bwd", lambda: grads(sc.lstm_scan, x_proj, w_hh),
                 lambda: grads(sc.lstm_scan_ref, x_proj, w_hh))):
            with torch.no_grad() if what == "fwd" else contextlib.nullcontext():
                ms, plain_ms = time_ms(kern, 5), time_ms(plain, 2)
            log(f"[scan baseline] {what} {tag}: kernels {ms:.3f} ms ({ms / T * 1e3:.2f} us/step),"
                f" plain {plain_ms:.3f} ms on {gpu}")
        res = sc.scan_fwd_train(x_proj, w_hh)
        mm = 2 * T * B_BIG * H_SCAN * 4 * H_SCAN  # h·W_hh (K12, K13), dgates·W_hhᵀ (K14)
        rows = {
            "scan_fwd_infer": (lambda: sc.scan_fwd_infer(x_proj, w_hh),
                               lambda: sc._scan_fwd_infer_ref(x_proj, w_hh), (x_proj, w_hh)),
            "scan_fwd_train": (lambda: sc.scan_fwd_train(x_proj, w_hh),
                               lambda: sc._scan_fwd_train_ref(x_proj, w_hh), (x_proj, w_hh)),
            "scan_bwd": (lambda: sc.scan_bwd(g, *res[1:], w_hh),
                         lambda: sc._scan_bwd_ref(g, *res[1:], w_hh), (g, res[1:], w_hh)),
        }
        ns = sc.scan_ns(B_BIG, H_SCAN, dtype)
        for name, (kern, plain, inputs) in rows.items():
            # library: nn.LSTM(4H, H) with weight_ih = I over x_proj, in this
            # row's dtype where cuDNN takes it
            lib = cudnn_ms(T, B_BIG, 4 * H_SCAN, H_SCAN, 1, cudnn_call[name], scan=True,
                           dtype=torch.float32 if dtype == torch.float32 else None)
            row = timing_row(kern, plain, inputs, mm, dtype, 5, 2, lib)
            if name == "scan_bwd":
                setting = f"tile {ls.scan_tile(B_BIG, H_SCAN, dtype)}"
            elif ns:
                setting = f"the wavefront forward, {ns} CTA{'s' if ns > 1 else ''} a tile"
            else:
                setting = f"scan_fwd_kernel, tile {sc.pick_tile(B_BIG, H_SCAN)}"
            log(f"[scan timing] {name} {tag} ({setting}): {fmt_row(row)}")
            if name == "scan_bwd":
                if dtype == bf16:
                    times[name] = row
            else:  # bf16: the wavefront forward's rows; f32: scan_fwd_kernel's
                times[name + ("_wave" if dtype == bf16 else "")] = row
        del x_proj, w_hh, g, res

    # K12 and K13 through each kernel at the batches that set scan_path: the
    # bench batch, the CLI's, and 128 tiles (two CTAs of the split an SM)
    for B in (B_BIG, 16, 2 * B_BIG):
        x_proj, w_hh, _ = case(B, bf16, 9)
        ms = {(kind, ns): time_ms(functools.partial(sc._fwd_cuda, x_proj, w_hh, train, ns=ns), 5)
              for kind, train in (("K12", False), ("K13", True)) for ns in (0, 1, 2)}
        line = "; ".join(f"{kind} " + ", ".join(
            f"{'scan_fwd_kernel' if ns == 0 else f'wavefront {ns} CTA' + ('s' if ns > 1 else '')}"
            f" {ms[(kind, ns)]:.3f}" for ns in (0, 1, 2)) + " ms" for kind in ("K12", "K13"))
        log(f"[scan paths] bf16 H={H_SCAN} T={T} B={B}: {line}; scan_path takes "
            f"{sc.scan_ns(B, H_SCAN, bf16)} CTAs a tile (clusters at once "
            f"{sc.scan_wave_clusters(H_SCAN, 1)} / {sc.scan_wave_clusters(H_SCAN, 2)}) on {gpu}")
        del x_proj, w_hh

    # the main path: one grad and one no-grad call in bf16 (the wavefront
    # forward) and in f32 (scan_fwd_kernel), the counts zeroed before each
    launches = {}
    for dtype in (bf16, torch.float32):
        x_proj, w_hh, _ = case(B_BIG, dtype, 6)
        ns = sc.scan_ns(B_BIG, H_SCAN, dtype)
        reset_launches()
        d = grads(sc.lstm_scan, x_proj, w_hh)
        with torch.no_grad():
            h = sc.lstm_scan(x_proj, w_hh)
        torch.cuda.synchronize()
        n = dict(LAUNCHES)
        log(f"[scan] one grad and one no-grad call of lstm_scan, {str(dtype).split('.')[-1]} "
            f"B={B_BIG}: launches {n}")
        want = {"scan_fwd_train": 1, "scan_bwd": 1, "scan_fwd_infer": 1,
                "scan_fwd_wave": 2 if ns == 1 else 0, "scan_fwd_wave_split": 2 if ns == 2 else 0}
        if {k: n[k] for k in want} != want:
            raise AssertionError(f"launches {n}, expected {want}")
        if tuple(h.shape) != (T, B_BIG, H_SCAN) or not all(torch.isfinite(t).all()
                                                           for t in (h, *d)):
            raise AssertionError("lstm_scan gave a wrong shape or non-finite values")
        if dtype == bf16:
            launches.update({"scan_fwd_infer_wave": n["scan_fwd_infer"],
                             "scan_fwd_train_wave": n["scan_fwd_train"], "scan_bwd": n["scan_bwd"]})
        else:
            launches.update({k: n[k] for k in ("scan_fwd_infer", "scan_fwd_train")})
        del x_proj, w_hh, d, h
    return errs, times, launches


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    import cerebra_torch  # noqa: F401  (fails before any output outside a checkout)

    start = time.perf_counter()

    def run(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        log(f"[phases] {phase.__name__} {time.perf_counter() - t0:.1f} s")
        return out

    gpu = run(phase_device)
    run(phase_build)
    errs = run(phase_parity)
    launches = run(phase_main)
    times = run(phase_kernel_timing)
    run(phase_step_timing, gpu)
    errs.update(run(phase_vit_parity))
    launches.update({k: v for k, v in run(phase_main_dino).items() if k in VIT_SOURCES})
    times.update(run(phase_vit_timing, gpu))
    run(phase_dino_step_timing, gpu)
    errs.update(run(phase_ae_parity))
    ae_launches, ae_times = run(phase_ae_train, gpu)
    launches.update({k: ae_launches[k] for k in ("fwd_infer", "bwd_general", "fwd_in_product",
                                                  "fwd_cluster_scan")})
    times.update(ae_times)
    e, t = run(phase_fwd_paths, gpu)
    errs.update(e)
    times.update(t)
    for phase in (phase_rc, phase_scan):
        e, t, n = run(phase, gpu)
        errs.update(e)
        times.update(t)
        launches.update({k: n[k] for k in t})
    log(f"[phases] all {time.perf_counter() - start:.1f} s")
    sources = dict(VIT_SOURCES, **dict.fromkeys(SCAN_KERNELS, SCAN_SOURCE))
    kernels = [
        {"name": name, "route": "cuda", "source": sources.get(name, SOURCE),
         "replaces": REPLACES[name], "launches": launches[name], "max_abs_err": errs[name],
         **times[name]}
        for name in ("fwd_train", "bwd", "stack_bwd_scan", "stack_bwd_products",
                     "fwd_infer_last", "fwd_wave", *VIT_SOURCES, "fwd_infer", "fwd_in_product",
                     "fwd_cluster_scan", "bwd_general", "fwd_train_rc", "fwd_infer_wave",
                     "fwd_train_rc_split", "fwd_infer_split",
                     "bwd_rc", *RC_PIECES, *SCAN_KERNELS)
    ]
    log(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
