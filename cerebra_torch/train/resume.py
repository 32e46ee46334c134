"""Preemption-safe auto-resume, the loss-NaN abort and the training-loop
trace (port of cerebra/train/resume.py: AutoResume,
install_preemption_handler as PreemptionGuard, check_finite_loss,
profile_trace).

The JAX package keeps step-numbered orbax directories; the port keeps
step-numbered `torch.save` files (`step_0000000040.pt`), since orbax has no
place beside PyTorch. The two formats differ by construction: neither
package resumes from the other's auto-resume directory (the reference-layout
`checkpoint.pth` is what both read and write).
"""

from __future__ import annotations

import contextlib
import math
import os
import signal
import sys
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from cerebra_torch.utils.config import is_main_process


class AutoResume:
    """Step-numbered `torch.save` checkpoints in `directory`, the newest
    `keep` kept, with latest-step discovery (the unconditional auto-resume
    of EEG-BarlowNetworks/train.py:104-112)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}.pt")

    def _steps(self) -> list:
        return sorted(int(n[5:-3]) for n in os.listdir(self.directory)
                      if n.startswith("step_") and n.endswith(".pt") and n[5:-3].isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any) -> None:
        """Write `tree` (state dicts, tensors, numbers) at `step` through a
        temporary file, then drop all but the newest `keep`; rank 0 only
        (save_on_master, utils/utils.py:447-449)."""
        if not is_main_process():
            return
        tmp = self._path(step) + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, self._path(step))
        for old in self._steps()[:-self.keep]:
            os.remove(self._path(old))

    def restore_latest(self):
        """(step, tree) of the newest checkpoint, on the CPU, or (None, None)."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, torch.load(self._path(step), map_location="cpu", weights_only=True)


class PreemptionGuard:
    """The port of `install_preemption_handler`, made safe for state that is
    changed in place: while the `with` block runs, SIGTERM and SIGUSR1 (the
    scheduler's preemption, the replacement for the SLURM requeue handlers,
    train.py:53-57) are only recorded, and the training loop calls
    `exit_if_requested` at each step boundary, which writes a checkpoint and
    exits. The JAX handler saves an immutable pytree wherever the signal
    lands; here a signal between the optimizer step and the teacher's EMA
    would save a student a step ahead of its teacher. The previous handlers
    come back when the block ends. In a distributed world the ranks agree
    at each boundary (a MAX all-reduce of the flag, a tensor on `device`),
    so a signal to any rank saves and exits on all: the save may gather
    sharded state, a collective every rank must enter."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGUSR1),
                 device: Optional[torch.device] = None):
        self.signals = tuple(signals)
        self.signum: Optional[int] = None
        self.device = device
        self._previous: dict = {}

    def _record(self, signum, frame):
        self.signum = signum

    def __enter__(self) -> "PreemptionGuard":
        self._previous = {sig: signal.signal(sig, self._record) for sig in self.signals}
        return self

    def __exit__(self, *exc) -> None:
        for sig, handler in self._previous.items():
            signal.signal(sig, handler)

    def exit_if_requested(self, save_fn: Callable[[], None]) -> None:
        """After a recorded signal: `save_fn()`, then exit with code 0."""
        if dist.is_available() and dist.is_initialized():
            flag = torch.tensor([0 if self.signum is None else self.signum], device=self.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            self.signum = int(flag.item()) or None
        if self.signum is None:
            return
        print(f"[cerebra] signal {self.signum}: writing preemption checkpoint", file=sys.stderr)
        save_fn()
        sys.exit(0)


def check_finite_loss(loss: float, step: int) -> None:
    """Loss-NaN abort (dino/main_dino.py:387-389)."""
    if not math.isfinite(loss):
        raise FloatingPointError(f"Loss is {loss} at step {step}, stopping training")


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str], enabled: bool = True):
    """A `torch.profiler` trace of the enclosed code, written into `log_dir`
    when it ends as `<host>_<pid>.<time>.pt.trace.json` (a Chrome trace; the
    PyTorch TensorBoard plugin and Perfetto read it), where the JAX package
    writes a `jax.profiler` trace. Host operators always, device kernels
    when a CUDA card is present. A no-op when not `enabled` or `log_dir` is
    empty."""
    if not enabled or not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
