"""Spans and the device trace.

`span(name)` is a harness span (a `torch.profiler.record_function` range)
around a call into one layer. `capture` profiles k whole steps behind a
marker kernel and returns their events from the profiler's Chrome trace;
`reduce` turns them into what the per-layer readers read: the traced
stretch (first kernel start to last kernel end), the union of device
activity in it, each layer's device seconds, and the breakdown (the longest device operations, and the
idle gaps by what the host was doing).

A layer is a file `layers/<name>.json` of one of three kinds, which claim a
device operation in this order:

- `"span"`: a harness span; the layer owns each operation launched inside it;
- `"program_spans"`: prefixes of the program's own span names; the layer owns
  each operation whose innermost program span (`attribute`'s rule) is one of
  them or lies under one (`cerebra_torch.lstm.bwd` takes in
  `cerebra_torch.lstm.bwd.scan`, not `cerebra_torch.lstm.bwdx`);
- `"kernels"`: fragments of kernel names; the layer owns each operation whose
  name holds one."""

import bisect
import glob
import json
import os
import tempfile

import torch

MARKER = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
PROGRAM = "cerebra_torch."
KINDS = ("span", "program_spans", "kernels")  # the order in which layers claim
LAYERS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "layers")


def span(name: str):
    return torch.profiler.record_function(name)


def kind(layer: dict) -> str:
    """The key of KINDS that defines a layer: the first it has."""
    return next(k for k in KINDS if k in layer)


def load_layers() -> list:
    """layers/*.json: {"name", and a key of KINDS}, in the order they
    claim (by kind, then by name)."""
    layers = []
    for path in sorted(glob.glob(os.path.join(LAYERS_DIR, "*.json"))):
        with open(path) as f:
            layers.append(json.load(f))
    return sorted(layers, key=lambda l: KINDS.index(kind(l)))


def parse(trace: dict) -> dict:
    """The Chrome trace's device operations (name, start, end, launch
    correlation), launches (correlation → host time), harness spans and
    host operations, in seconds."""
    dev, launch, spans, host = [], {}, [], []
    for e in trace.get("traceEvents", []):
        cat = e.get("cat")
        if e.get("ph") != "X" or cat is None:
            continue
        t0 = float(e["ts"]) * 1e-6
        t1 = t0 + float(e.get("dur", 0.0)) * 1e-6
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((e["name"], t0, t1, corr))
        elif cat in HOST_CATS:
            if cat in LAUNCH_CATS and corr is not None:
                launch[corr] = t0
            if cat == "user_annotation" and e["name"].startswith("perfbench."):
                spans.append((e["name"], t0, t1))
            host.append((t0, t1, e["name"]))
    return {"dev": dev, "launch": launch, "spans": spans, "host": sorted(host)}


def program_spans(events: dict) -> list:
    """The program's ranges (name, start, end) among `parse`'s host
    operations. Their `gpu_user_annotation` twins are not among them, nor
    among the device operations."""
    return [(name, a, b) for a, b, name in events["host"] if name.startswith(PROGRAM)]


def innermost(at, by_length):
    """The name of the shortest span of `by_length` (spans sorted by
    length) whose interval holds the host time `at`; None where `at` is
    None or no span holds it."""
    if at is None:
        return None
    return next((name for name, s, e in by_length if s <= at <= e), None)


def attribute(dev, launch: dict, spans) -> dict:
    """Device seconds of each span: every operation goes to the innermost
    (shortest) span whose interval holds its launch's host time, on
    whatever thread (while autograd's thread runs `lstm.bwd`, the main
    thread is inside `step.backward`). An operation with no launch time or
    launched outside every span goes to none."""
    by_length = sorted(spans, key=lambda s: s[2] - s[1])
    out = {}
    for _, a, b, corr in dev:
        owner = innermost(launch.get(corr), by_length)
        if owner is not None:
            out[owner] = out.get(owner, 0.0) + b - a
    return out


def under(name, prefixes) -> bool:
    """Whether the span `name` is one of `prefixes` or lies under one."""
    return name is not None and any(name == p or name.startswith(p + ".") for p in prefixes)


def events_of(prof) -> dict:
    """`parse` of a finished profiler's Chrome trace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return parse(json.load(f))
    finally:
        os.remove(path)


def capture(step, k: int, host: bool) -> dict:
    """`parse` of a profile of k calls of `step` after a marker kernel (a
    trace can lose its first kernels: 64 small ones and one step run
    ahead). Without `host` only the device's activity and the CUDA calls
    are traced, which slows the host little; with it every host operation
    too, which can double a host-bound step. A trace without its marker is
    taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    pad = torch.empty(1, device="cuda")
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(64):
                pad.zero_()
            step()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(k):
                step()
            torch.cuda.synchronize()
        events = events_of(prof)
        if any(MARKER in name for name, *_ in events["dev"]):
            return events
    raise RuntimeError("three device traces lost their marker kernel")


def union(intervals) -> list:
    """(start, end) intervals merged where they overlap, in order."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def short(name: str) -> str:
    """A kernel's name without `void` and its argument list, at most 96
    characters."""
    name = name.removeprefix("void ")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:96]


def _label(host, starts, t: float) -> str:
    """The innermost host operation running at time t."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 4000), -1):
        a, b, name = host[j]
        if b >= t and (best is None or b - a < best[1] - best[0]):
            best = host[j]
    return best[2] if best else "no host operation"


def profile_steps(step, k: int, layers: list) -> dict:
    """`reduce` of k steps traced without the host's operations (the
    stretch, the busy union, the longest operations), with every layer's
    device seconds, the seconds no layer claims and the idle gaps' labels
    from k more steps traced with them: one partition of one capture, since
    span layers need the host's ranges (the kernels' times there are the
    device's own; the gaps between them carry the profiler's host
    overhead)."""
    quiet = reduce(capture(step, k, host=False), layers, k)
    full = reduce(capture(step, k, host=True), layers, k)
    quiet.update(layer_s=full["layer_s"], other_s=full["other_s"])
    quiet["breakdown"]["idle_gaps"] = full["breakdown"]["idle_gaps"]
    return quiet


def reduce(events: dict, layers: list, k: int) -> dict:
    """The k steps after the marker: the stretch, the busy union, each
    layer's device seconds (claimed in `load_layers`' order: harness spans
    and program spans by launch time, kernel fragments by name), the
    seconds no layer claims, and the breakdown a step."""
    marks = [t1 for name, _, t1, _ in events["dev"] if MARKER in name]
    dev = [e for e in events["dev"] if e[1] >= max(marks)]
    if not dev:
        return {"steps": k, "stretch_s": 0.0, "busy_s": 0.0, "other_s": 0.0,
                "layer_s": {l["name"]: 0.0 for l in layers},
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    t0, t1 = min(e[1] for e in dev), max(e[2] for e in dev)
    busy = union((a, b) for _, a, b, _ in dev)
    layer_s = {l["name"]: 0.0 for l in layers}
    other, by_name = 0.0, {}
    spans = {}
    for name, a, b in events["spans"]:
        spans.setdefault(name, []).append((a, b))
    by_length = sorted(program_spans(events), key=lambda s: s[2] - s[1])

    def claims(l, name, at, inner) -> bool:
        if kind(l) == "span":
            return at is not None and any(s <= at <= e for s, e in spans.get(l["span"], ()))
        if kind(l) == "program_spans":
            return under(inner, l["program_spans"])
        return any(frag in name for frag in l["kernels"])

    for name, a, b, corr in dev:
        at = events["launch"].get(corr)
        inner = innermost(at, by_length)
        owner = next((l["name"] for l in layers if claims(l, name, at, inner)), None)
        if owner:
            layer_s[owner] += b - a
        else:
            other += b - a
        key = short(name)
        by_name[key] = by_name.get(key, 0.0) + b - a
    host = events["host"]
    starts = [h[0] for h in host]
    gaps = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        label = _label(host, starts, (a + b) / 2)
        gaps[label] = gaps.get(label, 0.0) + b - a
    top = lambda d: [[n, s / k] for n, s in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"steps": k, "stretch_s": t1 - t0, "busy_s": sum(b - a for a, b in busy),
            "layer_s": layer_s, "other_s": other, "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gaps)}}
