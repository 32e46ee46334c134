"""MetricLogger / SmoothedValue — host-side training telemetry (port of
cerebra/utils/logging.py; utils/utils.py:224-283 SmoothedValue, :313-400
MetricLogger.log_every). `synchronize_between_processes` sums count and
total over the world with one all-reduce, as the reference does; without a
process group it is a no-op."""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Iterable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist


class SmoothedValue:
    """Windowed median/avg + global average (utils/utils.py:224-283)."""

    def __init__(self, window_size: int = 20, fmt: Optional[str] = None):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt or "{median:.6f} ({global_avg:.6f})"

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self, device: Optional[torch.device] = None) -> None:
        """Sum count/total over the world; the window stays local, the
        reference's caveat (:242). `device` is the tensor's (the process
        group's backend must take it: a CUDA device under NCCL)."""
        if not (dist.is_available() and dist.is_initialized()):
            return
        t = torch.tensor([self.count, self.total], dtype=torch.float64, device=device)
        dist.barrier()
        dist.all_reduce(t)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

    @property
    def median(self) -> float:
        return float(np.median(list(self.deque))) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(list(self.deque))) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               max=self.max, value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())

    def synchronize_between_processes(self, device: Optional[torch.device] = None) -> None:
        for meter in self.meters.values():
            meter.synchronize_between_processes(device)

    def add_meter(self, name: str, meter: SmoothedValue) -> None:
        self.meters[name] = meter

    def log_every(self, iterable: Iterable, print_freq: int, header: str = "") -> Iterator:
        """utils/utils.py:348-400: yields the items, logging iteration and
        data time, the ETA and (on a CUDA machine) the device memory in use."""
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.6f}")
        data_time = SmoothedValue(fmt="{avg:.6f}")
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
        space = len(str(total)) if total else 6
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total and i == total - 1):
                eta = ""
                if total:
                    eta_seconds = iter_time.global_avg * (total - i)
                    eta = f"eta: {datetime.timedelta(seconds=int(eta_seconds))}  "
                mem = (f"  mem: {torch.cuda.memory_allocated() / 1e6:.0f}MB"
                       if torch.cuda.is_available() else "")
                print(f"{header} [{i:{space}d}/{total or '?'}]  {eta}{self}  "
                      f"time: {iter_time}  data: {data_time}{mem}")
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        print(f"{header} Total time: {datetime.timedelta(seconds=int(total_time))}")
