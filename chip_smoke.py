"""Smoke run of the PyTorch/CUDA port on one GPU: build the LSTM-stack
kernels, hold each against its plain PyTorch version, train the
LSTM→DINOv2 CLI for 6 epochs at full width, and time the training step.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device   nvidia-smi name and power limit, torch.version.cuda
  2. build    nvcc of cerebra_torch/csrc/lstm_stack.cu, seconds
  3. parity   K3, K1, K2 and the dW reduction against their plain versions,
              f32 and bf16, at B = 1024, 16 and 13 (T = 460, C = H = 96, L = 2)
  4. main     `cerebra_torch.cli.lstm_distill_from_dinov2_train.main` on the
              synthetic corpus (40 classes x 30 trials of (96, 512)), bf16,
              batch 16, 6 epochs; launch counts cover every train step
  5. timing   each kernel against its plain version at the main path's
              shapes, and bench.py's step (filter, crop, LSTM fwd/bwd,
              RMSprop) at B = 1024 through the kernels and the plain versions
The line before the last is a JSON object of per-kernel results; the last
is {"ok": true, "device": {...}}.
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
# Tolerances. f32 values by max-abs: both sides run the same f32 algebra and
# differ only in the order of the dot products (at most 2.4e-7 seen on an
# H100). f32 weight gradients by relative Frobenius: sums of T*B terms in
# another order (at most 4.3e-7 seen). Every bf16 output by relative
# Frobenius: a sum that lands the other side of a bf16 rounding moves that
# element by an ulp (2^-8 relative) and the recurrence carries it on (at
# most 1.5e-4 seen). Each limit keeps a margin of 20x or more over what was
# seen; they were first set at 1e-4, 1e-4 and 2e-2.
TOL_F32_ABS = 1e-5
TOL_F32_GRAD_REL = 1e-5
TOL_BF16_REL = 5e-3


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
    from cerebra_torch.kernels import _build

    so, seconds = _build.build("lstm_stack")
    log(f"[build] {os.path.relpath(so, ROOT)} in {seconds:.2f} s")


def make_stack(B: int, dtype: torch.dtype, seed: int):
    gen = torch.Generator().manual_seed(seed)
    bound = 1.0 / math.sqrt(H)

    def u(*shape):
        return ((torch.rand(*shape, generator=gen) * 2 - 1) * bound).to("cuda", dtype)

    x = torch.randn(T, B, C, generator=gen).to("cuda", dtype)
    layers = [(u(C if l == 0 else H, 4 * H), u(H, 4 * H), u(4 * H)) for l in range(L)]
    g = torch.randn(B, H, generator=gen).to("cuda", dtype)
    return x, layers, g


def compare(what: str, got: torch.Tensor, want: torch.Tensor, dtype, grad: bool) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    max_abs = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
    if dtype == torch.float32 and not grad:
        ok, limit = max_abs <= TOL_F32_ABS, f"max_abs <= {TOL_F32_ABS}"
    elif dtype == torch.float32:
        ok, limit = rel <= TOL_F32_GRAD_REL, f"rel_frob <= {TOL_F32_GRAD_REL}"
    else:
        ok, limit = rel <= TOL_BF16_REL, f"rel_frob <= {TOL_BF16_REL}"
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
            got_g = ls.bwd(g, x, layers, *want)
            want_g = ls._bwd_ref(g, x, layers, *want)
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


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    import cerebra_torch  # noqa: F401  (fails before any output outside a checkout)

    gpu = phase_device()
    phase_build()
    errs = phase_parity()
    launches = phase_main()
    times = phase_kernel_timing()
    phase_step_timing(gpu)
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name in ("fwd_train", "bwd", "fwd_infer_last", "bwd_reduce")
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
