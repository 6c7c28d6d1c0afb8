"""Profiling and debug switches of the port.

Counterpart of the JAX package's ``spatial_alignment_tpu/utils/profiling.py``:

  - ``StepTimer``: steady-state steps/s with the first laps left out; on
    CUDA each lap ends with ``torch.cuda.synchronize()``, so a lap holds
    the device's work and not only its issue;
  - ``trace``: ``torch.profiler`` around a block, written as a chrome trace;
  - ``enable_debug``: autograd anomaly detection with NaN checks, off by
    default. Anomaly mode syncs the host in every backward, so
    ``VariationalGPSA.fit`` refuses to capture its step under it on CUDA;
    debug the step eagerly with ``make_train_step``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

__all__ = ["StepTimer", "trace", "enable_debug"]


class StepTimer:
    """Accumulates steady-state step timings, excluding the first
    ``warmup`` laps (kernel builds, graph capture, allocator warm-up)."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.n = 0
        self.total = 0.0
        self._t0: Optional[float] = None
        self._sync = torch.cuda.is_available()

    def __enter__(self):
        if self._sync:
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync:
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        if self.warmup > 0:
            self.warmup -= 1
        else:
            self.n += 1
            self.total += dt
        return False

    lap = __enter__  # alias: with timer.lap(): ... reads naturally

    @property
    def steps_per_sec(self) -> float:
        return self.n / self.total if self.total else float("nan")

    @property
    def seconds_per_step(self) -> float:
        return self.total / self.n if self.n else float("nan")


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` around a block (host ops, and the device's
    kernels where there is a card); writes ``log_dir/trace.json`` for
    chrome://tracing or Perfetto and yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def enable_debug(nans: bool = True, checks: bool = False):
    """Opt-in numerical debugging (off by default).

    nans: autograd anomaly detection that raises at the backward op which
    first produces a NaN, naming the forward op behind it.
    checks: anomaly detection without the NaN test (forward traces for
    errors in backward). ``enable_debug(False)`` turns both off.
    """
    torch.autograd.set_detect_anomaly(bool(nans or checks), check_nan=bool(nans))
