"""One cell's step read by the program's own spans, on the card.

    python3 -m perfbench.phases --workload <cell> --seed <n>

No cell reports these numbers yet: they are not metrics of BENCHMARK.json,
and `run.py` does not call this module. Set-up is `run.py`'s (the kernels'
library, the cell's objects from the seed, the warm-up steps, no checked
steps and no window), then the cell's `trace_steps` steps each:

- each alone after a synchronise, the harness's host ms around the call
  (what `host_dispatch_ms` reads);
- `trace.profile_steps`, read by the harness's readers of the layers
  (`lstm_kernel_ms`, `filter_ms`, `rest_device_ms`: the stack's program
  spans, the filter's harness span, the time no layer claims);
- traced with the host's operations (`trace.capture`): each program span's
  device ms, every operation going to the innermost span around its
  launch (`trace.attribute`, the rule by which `lstm_kernel_ms` reads the
  stack's spans), and the runtime and driver calls inside
  `cerebra_torch.step`, launches and synchronising calls apart;
- each alone under the program's span recording (no profiler): each span's
  host ms, and the harness's host ms around the same calls;

and the cost of a span with nothing on. One JSON line on standard output;
a program without spans gives empty readings."""

import argparse
import importlib
import json
import sys
import time

STEP = "cerebra_torch.step"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")


def phases(events: dict, k: int) -> dict:
    """The k steps after `trace.capture`'s marker by the program's spans:
    device ms a step of each span, and each runtime or driver call's count
    a step inside `cerebra_torch.step` (over every step span traced, the
    one before the marker too)."""
    from perfbench.trace import MARKER, attribute, program_spans

    marks = [t1 for name, _, t1, _ in events["dev"] if MARKER in name]
    dev = [e for e in events["dev"] if e[1] >= max(marks)]
    spans = program_spans(events)
    steps = [(a, b) for name, a, b in spans if name == STEP]
    calls = {}
    for a, _, name in events["host"]:
        if name.startswith("cu") and any(s <= a <= e for s, e in steps):
            calls[name] = calls.get(name, 0) + 1
    calls = {name: n / len(steps) for name, n in calls.items()}
    return {"step_spans": len(steps),
            "device_ms": {n: s / k * 1e3 for n, s in attribute(dev, events["launch"], spans).items()},
            "launches": sum(calls.get(c, 0) for c in LAUNCH_CALLS),
            "synchronising": sum(calls.get(c, 0) for c in SYNC_CALLS), "calls": calls}


def recorded(step, n: int, sync) -> dict:
    """n calls of `step`, each alone after `sync()`, under the program's
    span recording: each span name's host ms a step, and the harness's host
    ms around the call; None where the program has no spans."""
    try:
        from cerebra_torch.utils.spans import recording
    except ImportError:
        return None
    around = 0
    with recording() as spans:
        for _ in range(n):
            sync()
            t = time.perf_counter_ns()
            step()
            around += time.perf_counter_ns() - t
        sync()
    span_ns = {}
    for name, _, _, t0, t1 in spans:
        span_ns[name] = span_ns.get(name, 0) + t1 - t0
    return {"span_ms": {k: v / n * 1e-6 for k, v in span_ns.items()}, "harness_ms": around / n * 1e-6}


def span_off_us(n: int = 200_000, repeats: int = 7):
    """µs an enter/exit pair of a span with nothing on, the median of
    `repeats` loops of n; None where the program has no spans."""
    try:
        from cerebra_torch.utils.spans import span
    except ImportError:
        return None
    out = []
    for _ in range(repeats):
        t = time.perf_counter_ns()
        for _ in range(n):
            with span("cerebra_torch.off"):
                pass
        out.append((time.perf_counter_ns() - t) / n * 1e-3)
    return sorted(out)[repeats // 2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)

    from perfbench.run import Marks, dispatch_ms, fixed_caches, load_cell, log, read_metric

    cell, cfg = load_cell(args.workload)
    fixed_caches()
    import torch

    if not torch.cuda.is_available():
        log(f"{args.workload} needs a CUDA device")
        return 2
    from cerebra_torch.kernels import _build

    from perfbench import trace

    for lib in cell["libraries"]:
        _build.build(lib)
    run = importlib.import_module(f"perfbench.drivers.{cfg['driver']}").Run(
        cell, cfg, args.seed, torch.device("cuda", 0))
    for _ in range(cell["warmup_steps"]):
        run.step()
    marks, k = Marks(True), cell["trace_steps"]
    marks.sync()
    out = {"cell": args.workload, "seed": args.seed, "steps": k,
           "card": torch.cuda.get_device_name(0), "dispatch_ms": dispatch_ms(run, k, marks)}
    named = {"trace": trace.profile_steps(run.step, k, trace.load_layers())}
    out.update({m: read_metric(m, named) for m in ("lstm_kernel_ms", "filter_ms", "rest_device_ms")})
    out.update(phases(trace.capture(run.step, k, host=True), k))
    out["recorded"] = recorded(run.step, k, marks.sync)
    out["span_off_us"] = span_off_us()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
