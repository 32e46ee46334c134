"""`correct` comes out false where it must, at a size the CPU holds and
against each cell's own limits: for the control (the reference, computed
in fp8, in the program's place) and for each fault a training cell can
have, planted underneath the timed path of a run that skips the look for
a chip: a step that returns its state unchanged, and half of each batch
left out with the mean over the rest."""

import pytest
import torch

from perfbench import compare
from perfbench.run import measure
from perfbench.tests.conftest import BENCHMARK_CELLS, driver, small

SEED = 2 ** 31 + 77


def run_small(name: str) -> bool:
    cell, cfg = small(name)
    record = measure(name, SEED, 0.05, False, torch.device("cpu"), cell, cfg)
    return record["failed"] == 0 and compare.passed(record["checks"])


@pytest.mark.parametrize("name", BENCHMARK_CELLS)
def test_sound_run_is_correct(name):
    assert run_small(name)


@pytest.mark.parametrize("fault", ["frozen", "half"])
@pytest.mark.parametrize("name", BENCHMARK_CELLS)
def test_fault_is_not_correct(monkeypatch, name, fault):
    cell, cfg = small(name)
    driver(cfg).plant(monkeypatch, fault)
    assert not run_small(name)


@pytest.mark.parametrize("seed", [SEED, 1, 2])
@pytest.mark.parametrize("name", BENCHMARK_CELLS)
def test_control_is_not_correct(name, seed):
    """The reference in fp8 in the program's place fails one of the cell's
    numbers at least."""
    import importlib

    cell, cfg = small(name)
    harness = importlib.import_module(f"perfbench.drivers.{cfg['driver']}")
    run = harness.Run(cell, cfg, seed, torch.device("cpu"))
    run.first_steps(cell["check_steps"])
    run.free()
    checks = compare.judge(compare.gaps(run.reference("fp8"), run.reference("f32")),
                           cell["limits"])
    assert not compare.passed(checks), checks
