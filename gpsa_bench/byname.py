"""The benchmark's own files found by name: ``<kind>/<name>.py`` under its
folder (a traffic mix's entry, a configuration's generator, a per-layer
metric's reader), each loaded once as a module."""

from __future__ import annotations

import importlib.util
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
_loaded = {}


def load(kind: str, name: str):
    """The module ``<kind>/<name>.py``; KeyError where there is none."""
    key = (kind, name)
    if key not in _loaded:
        path = BENCH_DIR / kind / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {kind[:-1]} {name!r}: {path.relative_to(BENCH_DIR)} is missing")
        spec = importlib.util.spec_from_file_location(f"gpsa_bench.{kind}.{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded[key] = module
    return _loaded[key]
