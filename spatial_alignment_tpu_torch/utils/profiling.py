"""Profiling and debug switches of the port.

Counterpart of the JAX package's ``spatial_alignment_tpu/utils/profiling.py``:

  - ``StepTimer``: steady-state steps/s with the first laps left out; on
    CUDA each lap ends with ``torch.cuda.synchronize()``, so a lap holds
    the device's work and not only its issue;
  - ``trace``: ``torch.profiler`` around a block, written as a chrome trace;
  - ``enable_debug``: autograd anomaly detection with NaN checks, off by
    default. Anomaly mode syncs the host in every backward, so
    ``VariationalGPSA.fit`` refuses to capture its step under it on CUDA;
    debug the step eagerly with ``make_train_step``;
  - ``enable_spans`` / ``span`` / ``spans``: the span recorder, off by
    default, at the boundaries of the layers the fit path runs through
    (``SPAN_NAMES``).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import List, NamedTuple, Optional

import torch

__all__ = ["StepTimer", "trace", "enable_debug", "enable_spans", "span", "spanned", "spans",
           "Span", "SPAN_NAMES"]


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


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

# The spans the port records, by layer: the constructor and its k-means; a
# fit() call (one call id); the training loop's build (priming, warm-up,
# capture) and its runs (optimizer reset, the chunk's inputs, the replays,
# the losses' copy to the host); a kernel library's build or load; and the
# step's parts, entered wherever the step's functions run (a captured or an
# eager step, predict, the distributed executor).
SPAN_NAMES = (
    "gpsa.model.init", "gpsa.model.kmeans",
    "gpsa.fit",
    "gpsa.loop.build", "gpsa.loop.prime", "gpsa.loop.warmup", "gpsa.loop.capture",
    "gpsa.loop.reset", "gpsa.loop.inputs", "gpsa.loop.replays", "gpsa.loop.losses",
    "gpsa.ops.build",
    "gpsa.sampler", "gpsa.factors", "gpsa.warp", "gpsa.data", "gpsa.objective",
    "gpsa.optimizer",
)


class Span(NamedTuple):
    """One recorded span: its times on ``time.perf_counter_ns`` (the host's
    CLOCK_MONOTONIC on Linux), the index of its parent in the same list
    (None at the top) and the id of the fit() call it belongs to (None
    outside any)."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    call_id: Optional[int]


class _Recorder:
    """The process's span state: the switch, the records (lists while
    open), the indices of the open spans and the last call id given."""

    def __init__(self):
        self.on = False
        self.records: list = []
        self.open: List[int] = []
        self.calls = 0


_REC = _Recorder()
_OFF = contextlib.nullcontext()


def enable_spans(on: bool = True):
    """Turn the span recorder on or off (off by default)."""
    _REC.on = bool(on)


def spans() -> List[Span]:
    """The spans recorded since the last call, in the order they opened,
    and clear them. Raises while a span is open (its children would lose
    their parent)."""
    if _REC.open:
        raise RuntimeError(f"{len(_REC.open)} span(s) still open")
    out = [Span(*r) for r in _REC.records]
    _REC.records = []
    return out


class _Span:
    __slots__ = ("name", "call", "_rf", "_index")

    def __init__(self, name: str, call: bool):
        self.name, self.call = name, call

    def __enter__(self):
        import torch.profiler

        parent = _REC.open[-1] if _REC.open else None
        if self.call:
            _REC.calls += 1
            call_id = _REC.calls
        else:
            call_id = _REC.records[parent][4] if parent is not None else None
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._index = len(_REC.records)
        _REC.records.append([self.name, time.perf_counter_ns(), None, parent, call_id])
        _REC.open.append(self._index)
        return self

    def __exit__(self, *exc):
        _REC.records[self._index][2] = time.perf_counter_ns()
        _REC.open.pop()
        self._rf.__exit__(*exc)
        return False


def span(name: str, call: bool = False):
    """A context manager around one layer's work. With spans off (the
    default) it is a shared null context. With spans on it enters
    ``torch.profiler.record_function(name)``, so the span shows in a
    profiler trace (``trace``) on the profiler's clock, and appends a
    :class:`Span` to the recorder. Spans nest in the order they open, on
    any thread; ``call=True`` starts a new call id, which the spans opened
    inside it share."""
    if not _REC.on:
        return _OFF
    return _Span(name, call)


def spanned(name: str, call: bool = False):
    """Decorator: each call of the function runs inside ``span(name, call)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _REC.on:
                return fn(*args, **kwargs)
            with _Span(name, call):
                return fn(*args, **kwargs)

        return inner

    return wrap
