"""The work counts of ``gpsa_bench/work/`` against hand counts at small
shapes, and the roofline arithmetic."""

import types

import pytest
import torch

from gpsa_bench import peaks
from gpsa_bench.work import cholesky, factor, quad, step, trisolve


def test_cholesky_counts():
    a = torch.zeros(2, 3, 4, 4)  # 6 matrices of 4 x 4
    w = cholesky.forward(a)
    assert w["flops"] == pytest.approx(6 * 64 / 3)
    assert w["bytes"] == 4 * (96 + 96)


def test_factor_counts():
    w = factor.forward(torch.zeros(5, 3, 3))
    assert w["flops"] == pytest.approx(5 * 2 * 27 / 3)
    assert w["bytes"] == 4 * (45 + 90)


def test_trisolve_counts_and_a_broadcast_factor_read_once():
    L, B = torch.zeros(2, 4, 4), torch.zeros(2, 4, 3)
    w = trisolve.forward(L, B, False)
    assert w["flops"] == 2 * 16 * 3
    assert w["bytes"] == 4 * (2 * 10 + 24 + 24)
    shared = torch.zeros(4, 4).expand(5, 4, 4)
    w = trisolve.forward(shared, torch.zeros(5, 4, 3), True)
    assert w["flops"] == 5 * 16 * 3
    assert w["bytes"] == 4 * (10 + 60 + 60)
    w = trisolve.forward(torch.zeros(3, 4, 4))
    assert w["flops"] == pytest.approx(3 * 64 / 3)
    assert w["bytes"] == 4 * (30 + 30)


def test_quad_counts():
    x, F = torch.zeros(2, 5, 3), torch.zeros(4, 3, 3)  # G 2, N 5, m 3, L 4
    w = quad.forward(x, F, "default")
    assert w["flops"] == 2 * 2 * 4 * 5 * 9 + 2 * 2 * 4 * 5 * 3
    assert w["bytes"] == 4 * (30 + 36 + 40)
    w = quad.backward(x, F, "default")
    assert w["flops"] == 6 * 2 * 4 * 5 * 9 + 3 * 2 * 4 * 5 * 3
    assert w["bytes"] == 4 * (60 + 72 + 40)
    assert quad.rate("default") == "tf32" and quad.rate("highest") == "fp32"


def test_step_counts_by_hand():
    """One warp view and the data layer at m = 2, two points a view,
    S = 1, L = 1, P = 1 (D = 2), counted term by term."""
    cfg = {"data": {"generator": "twod_grid", "grid_size": 1, "n_views": 2, "n_outputs": 1},
           "model": {"n_latent_gps": 1, "m_X_per_view": 2, "m_G": 2, "fixed_view_idx": 0},
           "train": {"S": 1}}
    m, n, D = 2, 1, 2
    gram = lambda a, b: a * b * (3 * D + 3)
    factors = lambda ch: gram(m, m) + m**3 / 3 + ch * (m**3 + m**3 / 3)
    pred = lambda pts, C, B: (gram(m, pts) + m * m * pts + 2 * m * pts + 2 * m * pts * C
                              + B * (2 * m * m * pts + 2 * m * pts + 4 * pts))
    once = lambda C, B: 2 * m * m * C + B * m**3 / 3 + B * m * m * (m + 1)
    warp = factors(D) + pred(n, D, D) + once(D, D) + 3 * n * D
    N = 2 * n
    data = factors(1) + once(1, 1) + pred(N, 1, 1) + 3 * N + 2 * N + 6 * N
    assert step.forward_flops(cfg, {}) == pytest.approx(warp + data)
    assert step.step_flops(cfg, {}) == pytest.approx(3 * (warp + data))
    # A minibatch replaces a view's points.
    cfg["data"]["grid_size"] = 10
    assert step.forward_flops(cfg, {"minibatch_size": 1}) == pytest.approx(warp + data)


def test_step_counts_by_hand_with_two_modalities(monkeypatch):
    """3-D coordinates (the generator's D); modality A through 1 latent into
    2 outputs at 1 point a view, B without LMC, 1 output at 2 and 1 points:
    one warp pass over 3 padded points a view, the data layer's Gram and
    Cholesky once, each modality's channels, solves, KL and predictive pass
    at its own width, the LMC product for A only."""
    from gpsa_bench import byname

    gen = types.ModuleType("two_modality_counts")
    gen.SPATIAL_DIMS = 3
    gen.points_per_view = lambda data: {"A": [1, 1], "B": [2, 1]}
    monkeypatch.setitem(byname._loaded, ("generators", "two_modality_counts"), gen)
    cfg = {"data": {"generator": "two_modality_counts", "n_outputs": {"A": 2, "B": 1}},
           "model": {"n_latent_gps": {"A": 1, "B": None}, "m_X_per_view": 2, "m_G": 2,
                     "fixed_view_idx": 0},
           "train": {"S": 1}}
    m, D = 2, 3
    gram = lambda a, b: a * b * (3 * D + 3)
    pred = lambda pts, C, B: (gram(m, pts) + m * m * pts + 2 * m * pts + 2 * m * pts * C
                              + B * (2 * m * m * pts + 2 * m * pts + 4 * pts))
    once = lambda C, B: 2 * m * m * C + B * m**3 / 3 + B * m * m * (m + 1)
    n = 1 + 2
    warp = (gram(m, m) + m**3 / 3 + D * (m**3 + m**3 / 3)) + pred(n, D, D) + once(D, D) + 3 * n * D
    data = gram(m, m) + m**3 / 3 + 2 * (m**3 + m**3 / 3)
    data += once(1, 1) + pred(2, 1, 1) + 3 * 2 + 2 * 2 * 2 + 6 * 2 * 2  # A: N = 2, P = 2
    data += once(1, 1) + pred(4, 1, 1) + 3 * 4 + 6 * 4  # B: N = 4, P = 1, no W
    assert step.forward_flops(cfg, {}) == pytest.approx(warp + data)


def test_least_seconds_takes_the_larger_bound():
    p = peaks.for_device("NVIDIA H100 80GB HBM3")
    assert peaks.least_seconds(67e12, 0, p, "fp32") == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12, p, "tf32") == pytest.approx(1.0)
    assert peaks.for_device("NVIDIA H100 PCIe")["tf32"] == 378e12
    with pytest.raises(ValueError):
        peaks.for_device("cpu")
