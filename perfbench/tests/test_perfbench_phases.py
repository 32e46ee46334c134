"""The program's spans read from a trace (`perfbench/phases.py`): device
time by the innermost span around each launch (`trace.attribute`), runtime
calls inside the step, and the recorded pass's host ms."""

import torch

from perfbench import phases, trace


def chrome_trace() -> dict:
    """A marker, a step before it and one after: a span of the program on
    the main thread, one on autograd's, their device twins, the harness's
    span, launches and a synchronise."""
    us = 1e6

    def x(cat, name, t, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": t * us, "dur": dur * us,
                "tid": 1, "args": args}

    return {"traceEvents": [
        x("user_annotation", "cerebra_torch.step", 0.5, 0.4),
        x("cuda_runtime", "cudaLaunchKernel", 0.6, 0.01, correlation=1),
        x("kernel", "k0", 0.7, 0.1, correlation=1),
        x("kernel", "at::cuda::spin_kernel(long)", 1.0, 0.2, correlation=2),
        x("user_annotation", "perfbench.step", 1.3, 0.7),
        x("user_annotation", "cerebra_torch.step", 1.4, 0.5),
        x("user_annotation", "cerebra_torch.lstm.fwd", 1.45, 0.1),
        x("gpu_user_annotation", "cerebra_torch.lstm.fwd", 2.0, 1.0),
        x("cuda_runtime", "cudaLaunchKernel", 1.5, 0.01, correlation=3),
        x("kernel", "wave_fwd_kernel", 2.0, 1.0, correlation=3),
        x("cuda_driver", "cuLaunchKernelEx", 1.6, 0.01, correlation=4),
        x("kernel", "nvjet", 3.0, 0.5, correlation=4),
        x("cuda_runtime", "cudaStreamSynchronize", 1.7, 0.01),
        x("cuda_runtime", "cudaLaunchKernel", 2.5, 0.01, correlation=5),  # after the step
        x("kernel", "k5", 3.5, 0.25, correlation=5)]}


def test_phases_of_a_trace():
    """Device ms a step by span after the marker, the device twins of the
    spans not counted as work; calls a step inside the step spans only,
    over every step span (the one before the marker too)."""
    p = phases.phases(trace.parse(chrome_trace()), k=1)
    assert p["step_spans"] == 2
    assert p["device_ms"] == {"cerebra_torch.lstm.fwd": 1000.0, "cerebra_torch.step": 500.0}
    assert p["calls"] == {"cudaLaunchKernel": 1.0, "cuLaunchKernelEx": 0.5,
                          "cudaStreamSynchronize": 0.5}
    assert p["launches"] == 1.5 and p["synchronising"] == 0.5


def test_phases_without_program_spans():
    """A program without spans gives empty readings and does not raise."""
    t = chrome_trace()
    t["traceEvents"] = [e for e in t["traceEvents"] if not e["name"].startswith("cerebra_torch.")]
    assert phases.phases(trace.parse(t), k=1) == {
        "step_spans": 0, "device_ms": {}, "launches": 0, "synchronising": 0, "calls": {}}


def test_recorded_pass_on_the_cpu():
    """Single steps of a cell at a size the CPU holds record the step's
    phases, each shorter than the step, the step no longer than the
    harness's call (the CPU's backward is the plain whole-stack one, with
    no scan or products spans)."""
    from perfbench.run import load_cell
    from perfbench.tests.conftest import small

    name = "lstm_distill_dinov2.b1024"
    cell, cfg = small(name)
    assert load_cell(name)[1]["driver"] == cfg["driver"] == "feature_distill"
    from perfbench.drivers.feature_distill import Run

    run = Run(cell, cfg, 2 ** 31 + 3, torch.device("cpu"))
    run.step()
    r = phases.recorded(run.step, 2, lambda: None)
    ms = r["span_ms"]
    parts = ["cerebra_torch.step." + p for p in ("forward", "loss", "backward", "optimizer")]
    assert all(0 < ms[p] < ms["cerebra_torch.step"] for p in parts)
    assert sum(ms[p] for p in parts) <= ms["cerebra_torch.step"] <= r["harness_ms"]
    assert {"cerebra_torch.lstm.prepare", "cerebra_torch.lstm.fwd",
            "cerebra_torch.lstm.bwd"} <= set(ms)


def test_a_span_off_is_cheap():
    """With nothing on, a span costs a check of two flags: well under the
    1 µs that ~12 spans a step may cost (a loose bound: this host's clock
    is shared)."""
    assert phases.span_off_us(n=20_000, repeats=3) < 5
