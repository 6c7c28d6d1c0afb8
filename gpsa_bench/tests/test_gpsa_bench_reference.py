"""The frozen reference against a float64 hand computation at a tiny
size, its Adam against torch.optim.Adam, and its control's roundings."""

import math

import numpy as np
import pytest
import torch

from gpsa_bench import reference


def _rbf(a, b, ls, var):
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return math.exp(var) * np.exp(-0.5 * d2 / math.exp(ls) ** 2)


def _kl(mq, Sq, mp, Sp):
    k = len(mq)
    Spi = np.linalg.inv(Sp)
    d = mp - mq
    return 0.5 * (np.trace(Spi @ Sq) + d @ Spi @ d - k
                  + np.linalg.slogdet(Sp)[1] - np.linalg.slogdet(Sq)[1])


def _hand_loss(p, X, Y, nsl, warp_noise, data_noise, eps):
    """The negative ELBO in numpy, from the model's description: view 0
    fixed, dense inverses, one sample."""
    V, n = len(nsl), nsl[0]
    Xv = [X[v * n:(v + 1) * n] for v in range(V)]
    G = [Xv[0]]
    kl = 0.0
    for v in range(1, V):
        Xt = p["Xtilde"][v]
        ls, var = p["warp_kernel_lengthscales"][v], p["warp_kernel_variances"][v]
        Kuu = _rbf(Xt, Xt, ls, var)
        Kuu = Kuu + eps * max(1.0, np.mean(np.diag(Kuu))) * np.eye(len(Xt))
        Kinv = np.linalg.inv(Kuu)
        Kfu = _rbf(Xv[v], Xt, ls, var)
        g = np.zeros_like(Xv[v])
        for d in range(2):
            A = p["Omega_sqt_G"][v, d]
            Sq = A @ A.T
            Sq = Sq + eps * max(1.0, np.mean(np.diag(Sq))) * np.eye(len(Xt))
            mean = Xv[v][:, d] + Kfu @ Kinv @ (p["delta_G"][v][:, d] - Xt[:, d])
            cov = (math.exp(var) - np.einsum("ij,jk,ik->i", Kfu, Kinv, Kfu)
                   + np.einsum("ij,jk,kl,il->i", Kfu, Kinv @ Sq, Kinv, Kfu) + 2 * eps)
            g[:, d] = mean + np.sqrt(cov) * warp_noise[0, v, :, d]
            kl += _kl(p["delta_G"][v][:, d], Sq, Xt[:, d], Kuu)
        G.append(g)
    Gs = np.concatenate(G)
    Gt, ls, var = p["Gtilde"], p["data_kernel_lengthscale"][0], p["data_kernel_variance"][0]
    Kuu = _rbf(Gt, Gt, ls, var)
    Kuu = Kuu + eps * max(1.0, np.mean(np.diag(Kuu))) * np.eye(len(Gt))
    Kinv = np.linalg.inv(Kuu)
    Kfu = _rbf(Gs, Gt, ls, var)
    A = p["Omega_sqt_F/expression"][0]
    Sq = A @ A.T
    Sq = Sq + eps * max(1.0, np.mean(np.diag(Sq))) * np.eye(len(Gt))
    delta = p["delta_F/expression"][:, 0]
    mean = Kfu @ Kinv @ delta
    cov = (math.exp(var) - np.einsum("ij,jk,ik->i", Kfu, Kinv, Kfu)
           + np.einsum("ij,jk,kl,il->i", Kfu, Kinv @ Sq, Kinv, Kfu) + 2 * eps)
    lat = mean + np.sqrt(cov) * data_noise[0, :, 0]
    obs = lat[:, None] @ p["W/expression"]
    kl += _kl(delta, Sq, np.zeros_like(delta), Kuu)
    s = math.exp(p["noise_variance"][-1]) + eps
    ll = (-0.5 * ((Y - obs) / s) ** 2 - math.log(s) - 0.5 * math.log(2 * math.pi)).sum()
    return -ll + kl


def _tiny():
    rng = np.random.default_rng(3)
    n, m = 3, 2
    X = rng.uniform(0, 2, (2 * n, 2))
    Y = rng.normal(size=(2 * n, 2))
    p = {"noise_variance": rng.normal(size=2) - 1, "warp_kernel_variances": np.zeros(2),
         "warp_kernel_lengthscales": np.zeros(2), "data_kernel_lengthscale": np.zeros(1),
         "data_kernel_variance": rng.normal(size=1) * 0.1,
         "Xtilde": rng.uniform(0, 2, (2, m, 2)), "Gtilde": rng.uniform(0, 2, (m, 2)),
         "Omega_sqt_G": 0.3 * rng.normal(size=(2, 2, m, m)),
         "Omega_sqt_F/expression": 0.3 * rng.normal(size=(1, m, m)),
         "delta_F/expression": rng.normal(size=(m, 1)), "W/expression": rng.normal(size=(1, 2))}
    p["delta_G"] = p["Xtilde"] + 0.1 * rng.normal(size=(2, m, 2))
    cfg = {"model": {"diagonal_offset": 1e-5, "fixed_view_idx": 0, "n_latent_gps": 1},
           "train": {"S": 1, "lr": 0.01}}
    return p, X, Y, [n, n], cfg


def test_loss_matches_a_float64_hand_computation():
    p, X, Y, nsl, cfg = _tiny()
    gen = torch.Generator()
    gen.manual_seed(9)
    draws = reference.Draws(gen, nsl, 1, 2, 1)
    pt = {k: torch.as_tensor(v) for k, v in p.items()}
    got = reference.negative_elbo(pt, torch.as_tensor(X), torch.as_tensor(Y), nsl, draws, cfg,
                                  reference.Precision())
    want = _hand_loss(p, X, Y, nsl, draws.warp.double().numpy(), draws.data.double().numpy(),
                      1e-5)
    assert float(got) == pytest.approx(want, rel=1e-10)


def test_aligned_means_are_the_warp_mean():
    p, X, Y, nsl, cfg = _tiny()
    pt = {k: torch.as_tensor(v) for k, v in p.items()}
    got = reference.aligned_means(pt, torch.as_tensor(X), nsl, cfg, 1, reference.Precision())
    Xt = p["Xtilde"][1]
    Kuu = _rbf(Xt, Xt, 0.0, 0.0) + 1e-5 * np.eye(2)
    want = X[3:] + _rbf(X[3:], Xt, 0.0, 0.0) @ np.linalg.solve(Kuu, p["delta_G"][1] - Xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


def test_adam_follows_torch_adam():
    torch.manual_seed(0)
    p = torch.randn(7, dtype=torch.float64)
    opt_p = p.clone().requires_grad_(True)
    opt = torch.optim.Adam([opt_p], lr=0.01)
    mine = reference.Adam(0.01)
    params = {"p": p.clone()}
    for _ in range(3):
        g = torch.randn(7, dtype=torch.float64)
        opt_p.grad = g.clone()
        opt.step()
        params = mine.step(params, {"p": g})
    torch.testing.assert_close(params["p"], opt_p.detach(), rtol=1e-12, atol=1e-14)


def test_control_rounds_to_tf32_and_bf16():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-12), 3.0e-3])
    t = reference._round_tf32(x)
    assert t[0] == 1.0 and t[1] == 1.0 + 2**-9 and t[2] == -1.0  # ties to even
    assert abs(float(t[3]) - 3.0e-3) <= 3.0e-3 * 2**-11
    b = reference._round_bf16(x)
    assert b[0] == 1.0 and b[1] == 1.0
    ctl = reference.Precision("control")
    a = torch.randn(5, 6)
    w = torch.randn(6, 4)
    low = ctl.mm(a, w)
    assert 0 < float((low - a @ w).abs().max()) < 1e-2
