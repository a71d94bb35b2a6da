"""Tracing and step timing (the port's own copy of
clipcap_tpu/utils/profiling.py).

The reference has no profiling beyond ad-hoc time.time() deltas
(reference sampling.py:415,432-434). Here:

- `trace(logdir)`: torch.profiler over the host and, when there is one,
  the card, writing a TensorBoard trace into `logdir`;
- `annotate(name)`: a named region inside a step (record_function);
- `StepTimer`: wall-clock step timing that waits for the device before
  reading the clock, reporting mean, p50 and p90.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    return torch.profiler.record_function(name)


def _first_tensor(x) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def hard_sync(x) -> None:
    """Wait until the device of `x`'s first tensor has finished its work
    (a CUDA synchronize); nothing for CPU tensors, which are computed when
    they are returned."""
    t = _first_tensor(x)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


class StepTimer:
    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        if result is not None:
            hard_sync(result)
        self.times.append(time.perf_counter() - self._t0)

    @contextlib.contextmanager
    def step(self, sync_on=None):
        self.start()
        holder = {}
        yield holder
        self.stop(holder.get("result", sync_on))

    def summary(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "steps_per_sec": float(1.0 / arr.mean()),
        }
