"""The 100k-spot configuration's data, frozen: ``n_per_view`` uniform spots
on [0, 10]^2 a view, an analytic smooth warp of the second view, and
``n_outputs`` analytic sinusoidal genes (no noise)."""

from __future__ import annotations

import torch

SPATIAL_DIMS = 2


def points_per_view(data: dict) -> list:
    return [int(data["n_per_view"])] * 2


def make(data: dict, gen, device):
    n, P = int(data["n_per_view"]), int(data["n_outputs"])
    X1 = 10.0 * torch.rand((n, 2), generator=gen, dtype=torch.float32, device=device)
    warp = 0.4 * torch.stack([torch.sin(X1[:, 0] / 2.0 + 1.0), torch.cos(X1[:, 1] / 2.0)], 1)
    X = torch.cat([X1, X1 + warp])
    j = torch.arange(P, device=device)
    a = ((j % 3 + 1) / 3.0)[None]
    b = ((j % 2 + 1) / 2.0)[None]
    Y1 = torch.sin(X1[:, :1] * a) + torch.cos(X1[:, 1:] * b)
    return X, torch.cat([Y1, Y1]), [n, n]
