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


def _hand_loss(p, data, warp_noise, data_noise, eps):
    """The negative ELBO in numpy, from the model's description: view 0
    fixed, dense inverses, one sample; the draws padded as the model pads
    each modality's points (``reference.Draws``)."""
    mods = list(data)
    M, V = len(mods), len(data[mods[0]][2])
    pad = {mod: max(nsl) for mod, (_, _, nsl) in data.items()}
    off = dict(zip(mods, np.cumsum([0] + [pad[mod] for mod in mods])))
    views = {mod: [X[sum(nsl[:v]):sum(nsl[:v + 1])] for v in range(V)]
             for mod, (X, _, nsl) in data.items()}
    G = {mod: [views[mod][0]] for mod in mods}
    kl = 0.0
    for v in range(1, V):
        Xt = p["Xtilde"][v]
        ls, var = p["warp_kernel_lengthscales"][v], p["warp_kernel_variances"][v]
        Kuu = _rbf(Xt, Xt, ls, var)
        Kuu = Kuu + eps * max(1.0, np.mean(np.diag(Kuu))) * np.eye(len(Xt))
        Kinv = np.linalg.inv(Kuu)
        Xw = np.concatenate([views[mod][v] for mod in mods])
        noise = np.concatenate([warp_noise[0, v, off[mod]:off[mod] + len(views[mod][v])]
                                for mod in mods])
        Kfu = _rbf(Xw, Xt, ls, var)
        g = np.zeros_like(Xw)
        for d in range(2):
            A = p["Omega_sqt_G"][v, d]
            Sq = A @ A.T
            Sq = Sq + eps * max(1.0, np.mean(np.diag(Sq))) * np.eye(len(Xt))
            mean = Xw[:, d] + Kfu @ Kinv @ (p["delta_G"][v][:, d] - Xt[:, d])
            cov = (math.exp(var) - np.einsum("ij,jk,ik->i", Kfu, Kinv, Kfu)
                   + np.einsum("ij,jk,kl,il->i", Kfu, Kinv @ Sq, Kinv, Kfu) + 2 * eps)
            g[:, d] = mean + np.sqrt(cov) * noise[:, d]
            kl += _kl(p["delta_G"][v][:, d], Sq, Xt[:, d], Kuu)
        ends = np.cumsum([len(views[mod][v]) for mod in mods])[:-1]
        for mod, piece in zip(mods, np.split(g, ends)):
            G[mod].append(piece)
    Gt, ls, var = p["Gtilde"], p["data_kernel_lengthscale"][0], p["data_kernel_variance"][0]
    Kuu = _rbf(Gt, Gt, ls, var)
    Kuu = Kuu + eps * max(1.0, np.mean(np.diag(Kuu))) * np.eye(len(Gt))
    Kinv = np.linalg.inv(Kuu)
    ll = 0.0
    for mm, mod in enumerate(mods):
        _, Y, nsl = data[mod]
        Gs = np.concatenate(G[mod])
        Kfu = _rbf(Gs, Gt, ls, var)
        z = np.concatenate([data_noise[mod][0, v * pad[mod]:v * pad[mod] + nsl[v]]
                            for v in range(V)])
        lat = np.zeros((len(Gs), p[f"delta_F/{mod}"].shape[1]))
        for c in range(lat.shape[1]):
            A = p[f"Omega_sqt_F/{mod}"][c]
            Sq = A @ A.T
            Sq = Sq + eps * max(1.0, np.mean(np.diag(Sq))) * np.eye(len(Gt))
            delta = p[f"delta_F/{mod}"][:, c]
            mean = Kfu @ Kinv @ delta
            cov = (math.exp(var) - np.einsum("ij,jk,ik->i", Kfu, Kinv, Kfu)
                   + np.einsum("ij,jk,kl,il->i", Kfu, Kinv @ Sq, Kinv, Kfu) + 2 * eps)
            lat[:, c] = mean + np.sqrt(cov) * z[:, c]
            kl += _kl(delta, Sq, np.zeros_like(delta), Kuu)
        obs = lat @ p[f"W/{mod}"] if f"W/{mod}" in p else lat
        s = math.exp(p["noise_variance"][-M + mm]) + eps
        ll += (-0.5 * ((Y - obs) / s) ** 2 - math.log(s) - 0.5 * math.log(2 * math.pi)).sum()
    return -ll + kl


def _tiny(two_modalities=False):
    """Parameters and data at m = 2: one modality of 3 points a view, 2
    outputs through 1 latent; or two, "A" (3 and 2 points, 2 outputs
    through 1 latent) and "B" (2 and 4 points, 3 outputs without LMC), with
    three noise terms."""
    rng = np.random.default_rng(3)
    m = 2
    shapes = {"A": ([3, 2], 2, 1), "B": ([2, 4], 3, None)} if two_modalities \
        else {"expression": ([3, 3], 2, 1)}
    data = {mod: (rng.uniform(0, 2, (sum(nsl), 2)), rng.normal(size=(sum(nsl), P)), nsl)
            for mod, (nsl, P, _) in shapes.items()}
    p = {"noise_variance": rng.normal(size=3 if two_modalities else 2) - 1,
         "warp_kernel_variances": np.zeros(2),
         "warp_kernel_lengthscales": np.zeros(2), "data_kernel_lengthscale": np.zeros(1),
         "data_kernel_variance": rng.normal(size=1) * 0.1,
         "Xtilde": rng.uniform(0, 2, (2, m, 2)), "Gtilde": rng.uniform(0, 2, (m, 2)),
         "Omega_sqt_G": 0.3 * rng.normal(size=(2, 2, m, m))}
    for mod, (_, P, L) in shapes.items():
        p[f"Omega_sqt_F/{mod}"] = 0.3 * rng.normal(size=(L or P, m, m))
        p[f"delta_F/{mod}"] = rng.normal(size=(m, L or P))
        if L is not None:
            p[f"W/{mod}"] = rng.normal(size=(L, P))
    p["delta_G"] = p["Xtilde"] + 0.1 * rng.normal(size=(2, m, 2))
    cfg = {"model": {"diagonal_offset": 1e-5, "fixed_view_idx": 0,
                     "n_latent_gps": {mod: L for mod, (_, _, L) in shapes.items()}},
           "train": {"S": 1, "lr": 0.01}}
    return p, data, cfg


def _torch(p, data):
    return ({k: torch.as_tensor(v) for k, v in p.items()},
            {mod: (torch.as_tensor(X), torch.as_tensor(Y), nsl)
             for mod, (X, Y, nsl) in data.items()})


@pytest.mark.parametrize("two_modalities", [False, True])
def test_loss_matches_a_float64_hand_computation(two_modalities):
    p, data, cfg = _tiny(two_modalities)
    gen = torch.Generator()
    gen.manual_seed(9)
    counts = {mod: nsl for mod, (_, _, nsl) in data.items()}
    widths = {mod: p[f"delta_F/{mod}"].shape[1] for mod in data}
    draws = reference.Draws(gen, counts, 1, 2, widths)
    pt, dt = _torch(p, data)
    got = reference.negative_elbo(pt, dt, draws, cfg, reference.Precision())
    want = _hand_loss(p, data, draws.warp.double().numpy(),
                      {mod: z.double().numpy() for mod, z in draws.data.items()}, 1e-5)
    assert float(got) == pytest.approx(want, rel=1e-10)


@pytest.mark.parametrize("two_modalities", [False, True])
def test_aligned_means_are_the_warp_mean(two_modalities):
    """The moving view's points of every modality, in the model's order."""
    p, data, cfg = _tiny(two_modalities)
    pt, dt = _torch(p, data)
    got = reference.aligned_means(pt, dt, cfg, 1, reference.Precision())
    Xt = p["Xtilde"][1]
    Kuu = _rbf(Xt, Xt, 0.0, 0.0) + 1e-5 * np.eye(2)
    X1 = np.concatenate([X[nsl[0]:] for X, _, nsl in data.values()])
    want = X1 + _rbf(X1, Xt, 0.0, 0.0) @ np.linalg.solve(Kuu, p["delta_G"][1] - Xt)
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
