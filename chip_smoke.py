"""Smoke run of the PyTorch/CUDA port on one GPU: build every kernel, hold
each against its plain PyTorch version, drive the ported trainers at full
width through the kernels, and time kernels and training steps.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device      nvidia-smi name and power limit, torch.version.cuda
  2. build       nvcc of cerebra_torch/csrc/{lstm_stack,vit_attn,vit_mlp}.cu,
                 all started together, seconds each
  3. parity      K3, K1, K2 and the dW reduction against their plain
                 versions, f32 and bf16, at B = 1024, 16 and 13 (T = 460,
                 C = H = 96, L = 2)
  4. main        `cerebra_torch.cli.lstm_distill_from_dinov2_train.main` on
                 the synthetic corpus (40 classes x 30 trials of (96, 512)),
                 bf16, batch 16, 6 epochs; launch counts cover every step
  5. timing      each LSTM kernel against its plain version at the main
                 path's shapes, and bench.py's step (filter, crop, LSTM
                 fwd/bwd, RMSprop) at B = 1024, kernels and plain versions
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
                 and the locals' shapes, and ms/step and views/s of the
                 main_dino step through the kernels and the plain versions
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
                 t, no dx), K4 twice in the forward; ms/step, and K4/K2g
                 against their plain versions at both widths
A `[phases]` line after each phase gives its seconds. The line before the
last is a JSON object of per-kernel results; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
    "bwd_reduce": "cerebra/models/pallas_lstm_stack.py:305",
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
})


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

    names = ("lstm_stack", "vit_attn", "vit_mlp")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, all at once
        built = list(pool.map(_build.build, names))
    for so, seconds in built:
        log(f"[build] {os.path.relpath(so, ROOT)} in {seconds:.2f} s")
    log(f"[build] all in {time.perf_counter() - t0:.2f} s")


def make_stack(B: int, dtype: torch.dtype, seed: int, C: int = C, H: int = H, L: int = L):
    gen = torch.Generator().manual_seed(seed)
    bound = 1.0 / math.sqrt(H)

    def u(*shape):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * bound).to("cuda", dtype)

    x = torch.randn(T, B, C, generator=gen).to("cuda", dtype)
    layers = [(u(C if l == 0 else H, 4 * H), u(H, 4 * H), u(4 * H)) for l in range(L)]
    g = torch.randn(B, H, generator=gen).to("cuda", dtype)
    return x, layers, g


def compare(what: str, got: torch.Tensor, want: torch.Tensor, dtype, grad: bool,
            tols=(TOL_F32_ABS, TOL_F32_GRAD_REL, TOL_BF16_REL)) -> float:
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
    log(f"[parity] {what}: max_abs {max_abs:.3e} rel_frob {rel:.3e} ({limit}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: kernel disagrees with its plain version ({limit})")
    return max_abs


def phase_parity() -> dict:
    from cerebra_torch.models import lstm_stack as ls

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[parity] allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn {torch.backends.cudnn.allow_tf32}")
    errs = {}
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
            part = torch.randn(-(-B // 4), 4 * H * (C + (2 * L - 1) * H + L),
                               device="cuda")
            er = compare(f"bwd_reduce {tag}", ls.reduce_partials(part), part.sum(0),
                         torch.float32, True)
            if dtype == torch.bfloat16 and B == 16:
                errs = {"fwd_train": e1, "bwd": e2, "fwd_infer_last": e3, "bwd_reduce": er}
            del x, layers, g, want, got, got_g, want_g, part
    torch.cuda.synchronize()
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
    if launches["fwd_train"] < steps or launches["bwd"] < steps:
        raise AssertionError(f"train steps bypassed the kernels: {launches} for {steps} steps")
    for name in ("fwd_infer_last", "bwd_reduce"):
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    return launches


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel_timing() -> dict:
    from cerebra_torch.models import lstm_stack as ls

    out = {}
    for B_train, B_val in ((16, 960), (1024, 1024)):
        x, layers, g = make_stack(B_train, torch.bfloat16, seed=1)
        res = ls._fwd_train_ref(x, layers)
        xv, layers_v, _ = make_stack(B_val, torch.bfloat16, seed=2)
        part = torch.randn(-(-B_train // ls.pick_tile(B_train, C, H, L, bwd=True)),
                           4 * H * (C + (2 * L - 1) * H + L), device="cuda")
        rows = {
            "fwd_train": (lambda: ls.fwd_train(x, layers),
                          lambda: ls._fwd_train_ref(x, layers), B_train),
            "bwd": (lambda: ls.bwd(g, x, layers, *res),
                    lambda: ls._bwd_ref(g, x, layers, *res), B_train),
            "fwd_infer_last": (lambda: ls.fwd_infer_last(xv, layers_v),
                               lambda: ls._fwd_infer_last_ref(xv, layers_v), B_val),
            "bwd_reduce": (lambda: ls.reduce_partials(part), lambda: part.sum(0), B_train),
        }
        for name, (kern, plain, B) in rows.items():
            ms, plain_ms = time_ms(kern, 5), time_ms(plain, 2)
            log(f"[timing] {name} B={B} T={T} bf16: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
            if B_train == 16:  # the CLI's shapes (train batch 16, gallery 960)
                out[name] = (ms, plain_ms)
        del x, layers, g, res, xv, layers_v, part
    return out


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


def phase_vit_timing() -> dict:
    from cerebra_torch.models import vit_attn as va
    from cerebra_torch.models import vit_mlp as vm

    out = {}
    for B, N in VIT_SHAPES[:2]:
        x, dout, pa, pm, s_seq, s_rows = vit_inputs(B, N, torch.bfloat16, True, seed=1)
        xm, dm = x.reshape(B * N, D_VIT), dout.reshape(B * N, D_VIT)
        _, sa = va.attn_fwd(x, s_seq, pa, H_VIT)
        _, sm = vm.mlp_fwd(xm, s_rows, pm)
        rows = {
            "vit_attn_fwd": (lambda: va.attn_fwd(x, s_seq, pa, H_VIT),
                             lambda: va._attn_fwd_ref(x, s_seq, pa, H_VIT)),
            "vit_attn_bwd": (lambda: va.attn_bwd(dout, x, s_seq, pa, H_VIT, sa),
                             lambda: va._attn_bwd_ref(dout, x, s_seq, pa, H_VIT)),
            "vit_mlp_fwd": (lambda: vm.mlp_fwd(xm, s_rows, pm),
                            lambda: vm._mlp_fwd_ref(xm, s_rows, pm)),
            "vit_mlp_bwd": (lambda: vm.mlp_bwd(dm, xm, s_rows, pm, sm),
                            lambda: vm._mlp_bwd_ref(dm, xm, s_rows, pm)),
        }
        for name, (kern, plain) in rows.items():
            ms, plain_ms = time_ms(kern, 5), time_ms(plain, 5)
            log(f"[vit timing] {name} B={B} N={N} f32 stream/bf16: kernel {ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms")
            if (B, N) == VIT_SHAPES[0]:
                out[name] = (ms, plain_ms)
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
            n = 4
            t0 = time.perf_counter()
            for _ in range(n):
                state, metrics = step(state, eeg, gen)
            loss = metrics["loss"].item()
            dt = (time.perf_counter() - t0) / n
        if not math.isfinite(loss):
            raise AssertionError(f"{kind} main_dino step loss is {loss}")
        log(f"[dino step] {kind}: {dt * 1e3:.2f} ms/step, {B / dt:.2f} samples/s, "
            f"{B * views / dt:.2f} views/s (ViT-S/8, 2x224 + 4x96, batch {B}, bf16) on {gpu}")
        del state, step
        torch.cuda.empty_cache()


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
    want = {"fwd_train": 2 * steps, "bwd_general": steps, "bwd_reduce": steps,
            "fwd_infer": 2, "bwd": 0, "fwd_infer_last": 0}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"launches {launches}, expected {want}")

    batch = (eeg[:B_AE], feats[:B_AE], labels[:B_AE], 0)
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
            "fwd_infer": (lambda: ls.fwd_infer(x, layers), lambda: ls._fwd_infer_ref(x, layers)),
            "bwd_general": (lambda: ls.bwd(g, x, layers, *res, need_dx=dx),
                            lambda: ls._bwd_ref(g, x, layers, *res, need_dx=dx)),
        }
        for kname, (kern, plain) in rows.items():
            ms, plain_ms = time_ms(kern, 5), time_ms(plain, 2)
            log(f"[ae timing] {kname} {name} C={c} H={h} B={B_AE} T={T} bf16"
                f"{' (g all t, dx)' if kname == 'bwd_general' and dx else ''}"
                f"{' (g all t)' if kname == 'bwd_general' and not dx else ''}: "
                f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
            if name == "encoder":
                times[kname] = (ms, plain_ms)
        del x, layers, res, g
    return launches, times


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
    times.update(run(phase_vit_timing))
    run(phase_dino_step_timing, gpu)
    errs.update(run(phase_ae_parity))
    ae_launches, ae_times = run(phase_ae_train, gpu)
    launches.update({k: ae_launches[k] for k in ("fwd_infer", "bwd_general")})
    times.update(ae_times)
    log(f"[phases] all {time.perf_counter() - start:.1f} s")
    kernels = [
        {"name": name, "route": "cuda", "source": VIT_SOURCES.get(name, SOURCE),
         "replaces": REPLACES[name], "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name in ("fwd_train", "bwd", "fwd_infer_last", "bwd_reduce", *VIT_SOURCES,
                     "fwd_infer", "bwd_general")
    ]
    log(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
