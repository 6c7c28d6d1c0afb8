"""The benchmark's inputs, made from ``--seed`` on the device by the
generator a configuration names under ``"data": {"generator": ...}``:
``generators/<name>.py``, which gives ``make(data, gen, device)`` ->
(float32 coordinates (N, 2), float32 outputs (N, P), per-view counts) and
``points_per_view(data)``. The same seed gives the same arrays on the same
device."""

from __future__ import annotations

import torch

from gpsa_bench import byname

__all__ = ["make_data", "points_per_view"]


def _generator(cfg: dict):
    return byname.load("generators", cfg["data"]["generator"])


def points_per_view(cfg: dict) -> list:
    """The per-view counts of configuration ``cfg``'s data."""
    return _generator(cfg).points_per_view(cfg["data"])


def make_data(cfg: dict, seed: int, device) -> tuple:
    """(coords (N, 2) float32, outputs (N, P) float32, per-view counts) of
    configuration ``cfg`` from ``seed``, made on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 2 + 1)
    return _generator(cfg).make(cfg["data"], gen, torch.device(device))
