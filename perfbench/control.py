"""The readings that `correct`'s limits are set from, on the card at a
cell's own size (not part of a benchmark run):

    python3 -m perfbench.control --workload <cell> --seeds 1 2 ... --faults 1 2 3

For every seed the program takes the cell's first steps and the f32
reference follows them (`compare.gaps`: the lower readings). For the seeds
of `--faults`, the control, the reference in the program's place computed
in fp8 (`reference/precision.py`), and the fault "half of each batch left
out, the mean over the rest", planted in the reference in the program's
place, and the fault "a step that returns its state unchanged", likewise,
are held against the same f32 reference (the upper readings). One JSON
line a reading."""

import argparse
import gc
import importlib
import json
import sys

import torch

from perfbench import compare
from perfbench.run import fixed_caches, load_cell


def readings(name: str, seed: int, faults: bool, device) -> dict:
    cell, cfg = load_cell(name)
    driver = importlib.import_module(f"perfbench.drivers.{cfg['driver']}")
    run = driver.Run(cell, cfg, seed, device)
    run.first_steps(cell["check_steps"])
    run.free()
    gc.collect()
    torch.cuda.empty_cache()
    ref = run.reference("f32")
    out = {"workload": name, "seed": seed, "program": compare.gaps(run.readings, ref),
           "program_leaves": compare.leaf_gaps(run.readings, ref)}
    if faults:
        fp8 = run.reference("fp8")
        out["fp8"] = compare.gaps(fp8, ref)
        out["fp8_leaves"] = compare.leaf_gaps(fp8, ref)
        out["half"] = compare.gaps(run.reference("f32", half=True), ref)
        out["frozen"] = compare.gaps(run.reference("f32", frozen=True), ref)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    fixed_caches()
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, seed in args.faults, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
