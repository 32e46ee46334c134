"""On the card: a short run of each cell of BENCHMARK.json, traced, through the benchmark's
own command, which prints one line with `correct` true and every per-layer
metric of the cell; and the LSTM stack's kernels inside the program spans
that its layer file names. Skips where there is no card."""

import json
import subprocess
import sys

import pytest

from perfbench import trace
from perfbench.run import ROOT, cell_metrics, load_json

BENCH = load_json(ROOT, "BENCHMARK.json")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_short_traced_run(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", name, "--seed",
                          str(2 ** 31 + 5), "--seconds", "2", "--trace", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    wanted = {m["name"] for m in cell_metrics(BENCH, name, "per_layer")}
    assert set(line["metrics"]) == wanted
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]


@pytest.mark.cuda
def test_stack_kernels_run_inside_the_stack_spans():
    """Every hand-written kernel of the headline stack's forward and
    backward (B 1024, C = H = 96, L 2, bf16, x needing no gradient; T cut to
    20), driven through autograd as the step drives it, is launched inside
    a span that `layers/lstm_stack.json`'s `program_spans` name, so
    `lstm_kernel_ms` counts it whatever its name (the products are
    `vit::` and `wg::` kernels). PyTorch's own kernels (`at::`) and copies
    are not checked."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from cerebra_torch.models import lstm_stack as ls

    prefixes = next(l for l in trace.load_layers() if l["name"] == "lstm_stack")["program_spans"]
    T, B, C, H = 20, 1024, 96, 96
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(6)

    def u(*shape):
        w = (torch.rand(*shape, generator=gen, device=dev) * 2 - 1) / H ** 0.5
        return w.to(bf16).requires_grad_()

    x = torch.randn(T, B, C, generator=gen, device=dev).to(bf16)
    layers = [(u(n, 4 * H), u(H, 4 * H), u(4 * H)) for n in (C, H)]

    def step():
        ls.lstm_stack_last(x, layers).float().square().sum().backward()

    step()
    torch.cuda.synchronize()
    ls.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    assert ls.LAUNCHES["stack_bwd_products_wgmma"] == 2
    events = trace.events_of(prof)
    by_length = sorted(trace.program_spans(events), key=lambda s: s[2] - s[1])
    ours = {(name, trace.innermost(events["launch"].get(corr), by_length))
            for name, _, _, corr in events["dev"]
            if "at::" not in name and not name.startswith(("Memcpy", "Memset"))}
    names = {name for name, _ in ours}
    assert any("stack_contract" in n for n in names) and any("wave_fwd" in n for n in names), ours
    assert all(trace.under(span, prefixes) for _, span in ours), ours
