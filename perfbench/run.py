"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the kernels' library, the corpus and weights from the seed, the
program's objects, the first steps that `correct` follows, the warm-up),
then a window of `--seconds` in which steps are dispatched with no
synchronise; with `--trace 1` also host-clock dispatches of single steps
and a profile of whole steps. Then the program's state is freed, the plain
reference follows the first steps and `compare.py` decides `correct`.
With `--trace 0` the line carries the cell's end-to-end metrics of
`BENCHMARK.json`, with `--trace 1` its per-layer metrics; each is read by
`metrics/<name>.py` from the run's record. The numbers compared, each with
its limit, come last on standard error and last in the line."""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "cerebra")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str):
    """(cell, configuration) from workloads/<name>.json and the
    configs/<config>.json it names."""
    cell = load_json(HERE, "workloads", f"{name}.json")
    return cell, load_json(HERE, "configs", f"{cell['config']}.json")


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") entries of BENCHMARK.json
    that this cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def read_metric(name: str, record: dict):
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), os.path.join(HERE, "metrics", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(record)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX, its libraries or the
    JAX package, compared whole (`cerebra_torch` is not `cerebra`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fixed_caches() -> None:
    """Kernel caches at fixed paths inside the checkout (the kernels'
    library itself goes to build/cerebra_torch/, where the program puts it)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, "build", "perfbench", sub)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.strip().splitlines()[0] if out.strip() else "unknown"


class Marks:
    """Step boundaries: CUDA events on the stream (no synchronise), or the
    host clock where the run has no card (the CPU tests)."""

    def __init__(self, cuda: bool):
        import torch

        self.cuda, self.torch = cuda, torch

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()


def window(run, seconds: float, marks: Marks) -> dict:
    """Steps dispatched until `seconds` have passed on the host clock; the
    window runs from a synchronise before the first to a synchronise after
    the last. Each step's ms is taken between the marks at its ends."""
    import torch

    marks.sync()
    t0 = time.perf_counter()
    ends, losses = [marks.mark()], []
    while True:
        losses.append(run.step())
        ends.append(marks.mark())
        if time.perf_counter() - t0 >= seconds:
            break
    marks.sync()
    window_s = time.perf_counter() - t0
    finite = int(torch.isfinite(torch.stack(losses).float()).sum())
    return {"steps": len(losses), "window_s": window_s, "failed": len(losses) - finite,
            "step_ms": [marks.ms(a, b) for a, b in zip(ends, ends[1:])]}


def dispatch_ms(run, n: int, marks: Marks) -> list:
    """Host ms of n calls of the step, each alone after a synchronise."""
    out = []
    for _ in range(n):
        marks.sync()
        t = time.perf_counter()
        run.step()
        out.append((time.perf_counter() - t) * 1e3)
    marks.sync()
    return out


def measure(name: str, seed: int, seconds: float, trace: bool, device, cell=None,
            cfg=None) -> dict:
    """Set-up, window, trace and check of one cell on one device; returns
    the run's record (what the metric readers read) with its checks. The
    tests pass `cell` and `cfg` at a size the CPU holds, where the run has
    no card to time or trace."""
    import torch

    from perfbench import compare
    from perfbench import trace as tracing

    if cell is None:
        cell, cfg = load_cell(name)
    driver = importlib.import_module(f"perfbench.drivers.{cfg['driver']}")
    cuda = device.type == "cuda"
    marks = Marks(cuda)
    record = {"cell": name, "chips": cell["chips"], "compile_s": 0.0, "launches": None}
    if cuda:
        from cerebra_torch.kernels import LAUNCHES, _build, reset_launches

        record["compile_s"] = sum(_build.build(lib)[1] for lib in cell["libraries"])
    run = driver.Run(cell, cfg, seed, device)
    run.first_steps(cell["check_steps"])
    for _ in range(cell["warmup_steps"]):
        run.step()
    marks.sync()
    record.update(batch=run.batch, counts=run.counts, setup_s=time.perf_counter() - T_START)
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
    record.update(window(run, seconds, marks))
    if cuda:
        record["launches"] = {k: v / record["steps"] for k, v in LAUNCHES.items() if v}
        record["peak_window_bytes"] = torch.cuda.max_memory_allocated()
        if trace:
            record["dispatch_ms"] = dispatch_ms(run, cell["trace_steps"], marks)
            record["trace"] = tracing.profile_steps(run.step, cell["trace_steps"],
                                                    tracing.load_layers())
        record["memory_peak_bytes"] = max(setup_peak, torch.cuda.max_memory_allocated())
    run.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = run.reference("f32")
    record["checks"] = compare.judge(compare.gaps(run.readings, ref), cell["limits"])
    return record


def result_line(bench: dict, record: dict, trace: bool) -> dict:
    """The last line: the cell's end-to-end (or, traced, per-layer) metrics
    that their readers find, the device, and the checks last."""
    import torch

    from perfbench.compare import passed

    metrics = {}
    for m in cell_metrics(bench, record["cell"], "per_layer" if trace else "end_to_end"):
        value = read_metric(m["name"], record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": record["failed"] == 0 and passed(record["checks"]),
           "attempted": record["steps"], "failed": record["failed"], "metrics": metrics,
           "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                      "count": record["chips"], "memory_peak_bytes": record["memory_peak_bytes"]}}
    if trace:
        t = record["trace"]
        out["device"].update(busy_s=t["busy_s"], window_s=t["stretch_s"])
        out["breakdown"] = t["breakdown"]
    out["checks"] = record["checks"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json(ROOT, "BENCHMARK.json")
    cell, _ = load_cell(args.workload)
    fixed_caches()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    if cell["chips"] != 1:
        log(f"{args.workload} asks for {cell['chips']} chips; this harness runs cells of one")
        return 2
    record = measure(args.workload, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return 3
    out = result_line(bench, record, bool(args.trace))
    ms = sorted(record["step_ms"])
    log(f"card {out['device']['kind']}, power limit {power_limit()}; set-up "
        f"{record['setup_s']:.3f} s (compile {record['compile_s']:.3f} s); "
        f"{record['steps']} steps in {record['window_s']:.3f} s; step ms min {ms[0]:.3f} "
        f"median {ms[len(ms) // 2]:.3f} max {ms[-1]:.3f}")
    print(f"launches a step: {json.dumps(record['launches'])}", flush=True)
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
