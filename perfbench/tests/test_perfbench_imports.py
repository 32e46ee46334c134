"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references load nothing of the program. Module names are compared by their
top-level name whole: `cerebra_torch` is not `cerebra`."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from perfbench.run import FORBIDDEN, HERE, ROOT

MODULES = ["perfbench.run", "perfbench.control", "perfbench.compare", "perfbench.counts",
           "perfbench.feed", "perfbench.trace"] + [
    "perfbench.drivers." + os.path.basename(p)[:-3]
    for p in sorted(glob.glob(os.path.join(HERE, "drivers", "[a-z]*.py")))]
REFERENCE = ["perfbench.reference." + os.path.basename(p)[:-3]
             for p in sorted(glob.glob(os.path.join(HERE, "reference", "[a-z]*.py")))]


def loaded_top_levels(modules, then: str = "") -> set:
    """Top-level names of sys.modules in a fresh interpreter after importing
    `modules` (and running `then`)."""
    code = ";".join([f"import {m}" for m in modules] + [then] * bool(then) + ["import sys",
                     "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    names = loaded_top_levels(MODULES + REFERENCE)
    assert not names & set(FORBIDDEN)


def test_cells_load_no_jax():
    """A small run of each cell on the CPU, drivers, program and reference
    together, leaves no module of JAX or the JAX package loaded."""
    then = ("import torch;from perfbench.tests.conftest import small, CELLS;"
            "from perfbench.run import measure;"
            "[measure(n, 3, 0.05, False, torch.device('cpu'), *small(n)) for n in CELLS]")
    names = loaded_top_levels(["perfbench.run"], then)
    assert "cerebra_torch" in names
    assert not names & set(FORBIDDEN)


def test_whole_name_comparison():
    assert not {m.split(".")[0] for m in ("cerebra_torch.models", "jax_utils", "flaxen")} & set(
        FORBIDDEN)
    assert {m.split(".")[0] for m in ("cerebra.models", "jax.numpy")} & set(FORBIDDEN) == {
        "cerebra", "jax"}


def test_reference_loads_nothing_of_the_program():
    assert not loaded_top_levels(REFERENCE) & {"cerebra_torch", *FORBIDDEN}


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(HERE, "reference", "*.py"))),
                         ids=os.path.basename)
def test_reference_source_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names <= {"contextlib", "numpy", "scipy", "torch", "perfbench"}
