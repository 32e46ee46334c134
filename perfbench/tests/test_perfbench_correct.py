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
from perfbench.tests.conftest import BENCHMARK_CELLS, small

SEED = 2 ** 31 + 77


def run_small(name: str) -> bool:
    cell, cfg = small(name)
    record = measure(name, SEED, 0.05, False, torch.device("cpu"), cell, cfg)
    return record["failed"] == 0 and compare.passed(record["checks"])


def frozen_distill_step(model, opt, loss_fn, eeg, feats, labels, epoch):
    return loss_fn(*model(eeg), feats, labels, epoch).detach()


def plant(monkeypatch, name: str, fault: str) -> None:
    import cerebra_torch.train.recipes as recipes
    import cerebra_torch.train.steps as steps

    if small(name)[1]["driver"] == "feature_distill":
        whole = steps.feature_distill_step
        if fault == "frozen":
            step = frozen_distill_step
        else:
            def step(model, opt, loss_fn, eeg, feats, labels, epoch):
                n = eeg.shape[0] // 2
                return whole(model, opt, loss_fn, eeg[:n], feats[:n], labels[:n], epoch)
        monkeypatch.setattr(steps, "feature_distill_step", step)
        return
    make = recipes.make_dino_lstm

    def make_faulty(*args, **kwargs):
        state, step, niter = make(*args, **kwargs)
        if fault == "frozen":
            return state, lambda s, batch, gen: (s, {"loss": torch.zeros(())}), niter
        return state, lambda s, batch, gen: step(s, batch[:batch.shape[0] // 2], gen), niter

    monkeypatch.setattr(recipes, "make_dino_lstm", make_faulty)


@pytest.mark.parametrize("name", BENCHMARK_CELLS)
def test_sound_run_is_correct(name):
    assert run_small(name)


@pytest.mark.parametrize("fault", ["frozen", "half"])
@pytest.mark.parametrize("name", BENCHMARK_CELLS)
def test_fault_is_not_correct(monkeypatch, name, fault):
    plant(monkeypatch, name, fault)
    assert not run_small(name)


@pytest.mark.parametrize("seed", [SEED, 1, 2])
@pytest.mark.parametrize("name", BENCHMARK_CELLS)
def test_control_is_not_correct(name, seed):
    """The reference in fp8 in the program's place fails one of the cell's
    numbers at least."""
    import importlib

    cell, cfg = small(name)
    driver = importlib.import_module(f"perfbench.drivers.{cfg['driver']}")
    run = driver.Run(cell, cfg, seed, torch.device("cpu"))
    run.first_steps(cell["check_steps"])
    run.free()
    checks = compare.judge(compare.gaps(run.reference("fp8"), run.reference("f32")),
                           cell["limits"])
    assert not compare.passed(checks), checks
