"""The loss-NaN abort and the training-loop trace (port of
cerebra/train/resume.py::check_finite_loss and ::profile_trace)."""

from __future__ import annotations

import contextlib
import math
import os
from typing import Optional

import torch


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
