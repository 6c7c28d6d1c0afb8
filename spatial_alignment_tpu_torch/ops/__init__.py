"""Kernels and linear algebra of the PyTorch port.

Each kernel module names its launch and plain-call counters in
``COUNTERS``; :func:`read_counters`, :func:`set_counters` and
:func:`add_counters` act on all of them at once, keyed ``"<module>.<name>"``
(e.g. ``"quad.bwd_launches"``). A module outside this package whose
counters belong with them (the distributed path's collectives) adds itself
with :func:`register_counted` when it is imported.
"""

from __future__ import annotations

import importlib

# Counter prefix -> kernel module, relative to this package.
_COUNTED = {"cholesky": ".cholesky", "factor": ".factor", "gram": ".gram", "quad": ".quad",
            "trisolve": ".trisolve"}
_REGISTERED = {}


def register_counted(name: str, module) -> None:
    """Count ``module``'s ``COUNTERS`` under ``"<name>.<counter>"``."""
    _REGISTERED[name] = module


def _counted_modules():
    return [(name, importlib.import_module(path, __name__)) for name, path in _COUNTED.items()
            ] + list(_REGISTERED.items())


def read_counters() -> dict:
    """{"<module>.<counter>": value} of every kernel module's counters."""
    return {f"{name}.{c}": getattr(mod, c) for name, mod in _counted_modules()
            for c in mod.COUNTERS}


def set_counters(values: dict) -> None:
    """Set the counters named in ``values``."""
    for name, mod in _counted_modules():
        for c in mod.COUNTERS:
            key = f"{name}.{c}"
            if key in values:
                setattr(mod, c, values[key])


def add_counters(per_step: dict, times: int) -> None:
    """Add ``times`` x ``per_step`` to the counters (a captured step's
    counts, once per replay)."""
    now = read_counters()
    set_counters({k: now[k] + times * v for k, v in per_step.items() if v})
