"""Named ranges around the program's phases, read by the profiler the port
already uses.

`span(name)` is a context manager. While `torch.profiler` runs it is a
`record_function` range, so it lands in the same Chrome trace as the
kernels, on the device trace's clock (`--profile_dir`'s traces name the
step's phases through it). While `recording()` is open it also appends
`(name, parent, thread id, t0_ns, t1_ns)` from `time.perf_counter_ns` to
the list that `recording()` yields, the parent being the span that
encloses it on the same thread (None at the top): host durations without
the profiler, which stretches a host step. With neither on, `span` returns
one shared no-op, after a check of two module-level flags.

The names begin with `cerebra_torch.`: `step` (`train/steps.py::
feature_distill_step` and `make_dino_step`'s step) with `step.forward`,
`.loss`, `.backward` and `.optimizer` (zero_grad and the update, two
intervals a step) inside it, and in the DINO step also `step.views`,
`.teacher` and `.ema` (the EMA of teacher and center);
`lstm.prepare` (`models/lstm.py::LSTMStack.prepare`: the input's
time-major copy and the weights' casts), `lstm.fwd` and `lstm.bwd` (the
stack's autograd function, `models/lstm_stack.py::_Stack`) and, inside
`lstm.bwd`, `lstm.bwd.scan` and `lstm.bwd.products` (K2's reverse scan and
products, one of each a layer); `vit.attn` and `vit.mlp` (each ViT
half-block's forward, fused or not: `models/vit_attn.py::_residual`,
`models/vit_mlp.py::_residual`, `models/vit.py::Block.forward`'s unfused
branches), `vit.attn.bwd` and `vit.mlp.bwd` (the fused halves' backwards,
K6 and K8).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Optional, Tuple

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

Record = Tuple[str, Optional[str], int, int, int]

_records: Optional[List[Record]] = None  # the open recording's list
_stacks = threading.local()  # each thread's open spans, innermost last


class _Off:
    """The span when neither the profiler nor a recording is on."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("name", "range", "records", "t0")

    def __init__(self, name: str):
        self.name, self.range, self.records = name, None, _records

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.range = record_function(self.name)
            self.range.__enter__()
        if self.records is not None:
            stack = _stacks.__dict__.setdefault("open", [])
            stack.append(self.name)
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.records is not None:
            t1 = time.perf_counter_ns()
            stack = _stacks.open
            stack.pop()
            self.records.append((self.name, stack[-1] if stack else None,
                                 threading.get_ident(), self.t0, t1))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A named range around a phase: a profiler range and/or a recorded
    interval when either is on, else the shared no-op `OFF`."""
    if _records is None and not _profiler._is_profiler_enabled:
        return OFF
    return _Span(name)


@contextlib.contextmanager
def recording():
    """Record every span entered on any thread until the block ends; yields
    the list of `(name, parent, thread id, t0_ns, t1_ns)`, each appended as
    its span ends."""
    global _records
    if _records is not None:
        raise RuntimeError("a recording is already open")
    _records = out = []
    try:
        yield out
    finally:
        _records = None
