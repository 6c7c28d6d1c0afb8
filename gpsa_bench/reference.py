"""The plain reference of GPSA training, in PyTorch and nothing else.

It imports neither JAX nor either GPSA package: the model's mathematics is
written out here from its description (Jones et al., Nature Methods 2023;
the square variational parameterization of the upstream ``VariationalGPSA``)
in the plainest form, with autograd for the gradients and Adam by its
formulas.

The two layers, each a sparse variational GP with inducing points, over
one or more modalities (``{modality: (coords, outputs, per-view counts)}``
in the model's order, all over the same views):

* warp layer, per view v that is not the fixed one: inducing points
  Xtilde_v, RBF kernel (lengthscale, variance per view), prior mean the
  identity, q(u) = N(delta_G, Omega Omega^T) per spatial dimension with
  Omega = chol(A A^T + eps max(1, mean diag) I) from the stored factor A,
  over the view's points of every modality. The aligned coordinates are
  mu + sqrt(var) * noise at the warp temperature; the fixed view keeps its
  coordinates.
* data layer on the aligned coordinates: inducing points Gtilde and one
  RBF kernel shared by the modalities; each modality has its own q(u) of
  L latent GPs with zero prior mean and its own KL term, and its latents
  are mixed into its P outputs by its W (``"W/<modality>"``), or are its
  outputs where it has none (L = P, no LMC).

The loss is -E[log N(y; f, s)] + KL, with s = exp(noise_variance[-M + mm])
+ eps for modality mm of M, the sample mean over S Monte-Carlo draws.
Every Gram gets the jitter eps max(1, mean diag), raised from m = 64 up to
the float32 noise floor 0.5 sqrt(m) 1.2e-7 max row sum |K|, and escalated
to 10x or 100x where a float32 Cholesky fails at the lower rung: the
model's stated numerical safeguard.

``Precision("reference")`` computes everything in float64;
``Precision("float32")`` everything in float32, and
``Precision("float32_differences")`` the same with each Gram's squared
distances taken as sums of squared differences (two witnesses of what
float32 itself resolves, with the model's expansion and without it);
``Precision("control")`` is the reference one precision below the
configuration's: float32, with every product the model states in float32
rounded to TF32 operands and every product it states in TF32 (the
variance's quadratic form, precision name ``default``) rounded to bfloat16
operands; solves and factorizations stay float32. Faults can be planted by
name for the benchmark's own tests of its comparison.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

__all__ = ["Precision", "Draws", "negative_elbo", "follow", "aligned_means", "FAULTS"]

_LOG_2PI = math.log(2.0 * math.pi)
_VAR_FLOOR = 1e-10
_ULP_F32 = 1.2e-7
# The faults the benchmark's tests plant in the reference put in the
# program's place: half the points' likelihood doubled, and the warp
# layer's mean moved where it is produced.
FAULTS = ("half_batch", "warp_mean_altered")


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits, to nearest even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class _LowMatmul(torch.autograd.Function):
    """a @ b with both operands (and, backward, the cotangent) rounded."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        ctx.save_for_backward(a, b)
        ctx.rnd = rnd
        return rnd(a) @ rnd(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = ctx.rnd
        ga = r(g) @ r(b).transpose(-1, -2)
        gb = r(a).transpose(-1, -2) @ r(g)
        # Broadcast batch dims summed back to each operand's shape.
        while ga.dim() > a.dim():
            ga = ga.sum(0)
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        for d in range(a.dim() - 2):
            if a.shape[d] == 1 and ga.shape[d] != 1:
                ga = ga.sum(d, keepdim=True)
        for d in range(b.dim() - 2):
            if b.shape[d] == 1 and gb.shape[d] != 1:
                gb = gb.sum(d, keepdim=True)
        return ga, gb, None


class Precision:
    """How the reference computes: ``"reference"`` (float64), ``"float32"``,
    ``"float32_differences"`` or ``"control"`` (see the module doc);
    ``fault`` plants one of ``FAULTS``."""

    NAMES = ("reference", "float32", "float32_differences", "control")

    def __init__(self, name: str = "reference", fault: Optional[str] = None):
        if name not in self.NAMES:
            raise ValueError(f"unknown precision {name!r}")
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.name, self.fault = name, fault
        self.dtype = torch.float64 if name == "reference" else torch.float32
        self.differences = name == "float32_differences"

    def mm(self, a, b, stated: str = "fp32"):
        """a @ b, for a product the model states in ``stated`` ("fp32" or
        "tf32")."""
        if self.name != "control":
            return a @ b
        return _LowMatmul.apply(a, b, _round_bf16 if stated == "tf32" else _round_tf32)


def rbf(x1, x2, log_ls, log_var, P=None):
    """exp(log_var) exp(-|x1 - x2|^2 / (2 exp(log_ls)^2)), x1 (..., n, D),
    x2 (..., k, D) -> (..., n, k). The squared distances by the expansion
    |x1|^2 + |x2|^2 - 2 x1 . x2, floored at 0, as GPSA writes its Gram:
    one product, at float32 as the model states it (``P``'s rounding in
    the control); ``P.differences`` takes them as sums of squared
    differences instead."""
    if P is not None and P.differences:
        d2 = torch.square(x1[..., :, None, :] - x2[..., None, :, :]).sum(-1)
    else:
        cross = x1 @ x2.transpose(-1, -2) if P is None else P.mm(x1, x2.transpose(-1, -2))
        d2 = (x1 * x1).sum(-1)[..., :, None] + (x2 * x2).sum(-1)[..., None, :] - 2.0 * cross
    return torch.exp(log_var) * torch.exp(-0.5 * torch.clamp_min(d2, 0.0) / torch.exp(log_ls) ** 2)


def _eye(m, like):
    return torch.eye(m, dtype=like.dtype, device=like.device)


def _jitter(K: torch.Tensor, eps: float) -> torch.Tensor:
    """The stated jitter of a (batched) Gram, detached (see the module doc)."""
    K = K.detach()
    m = K.shape[-1]
    base = eps * torch.clamp_min(torch.diagonal(K, dim1=-2, dim2=-1).mean(-1), 1.0)
    if m >= 64:
        floor = 0.5 * math.sqrt(m) * _ULP_F32 * K.abs().sum(-1).amax(-1)
        base = torch.maximum(base, floor)
    K32, eye32 = K.float(), _eye(m, K).float()
    ok = lambda r: torch.linalg.cholesky_ex(
        K32 + (r * base).float()[..., None, None] * eye32)[1] == 0
    if m >= 64:
        return torch.where(ok(1.0), base, torch.where(ok(10.0), 10.0 * base, 100.0 * base))
    return torch.where(ok(1.0), base, 100.0 * base)


def _chol_jittered(K, eps):
    return torch.linalg.cholesky(K + _jitter(K, eps)[..., None, None] * _eye(K.shape[-1], K))


def _chol_psd(A, eps, P):
    """chol(A A^T + eps max(1, mean diag) I)."""
    M = P.mm(A, A.transpose(-1, -2))
    scale = torch.clamp_min(torch.diagonal(M, dim1=-2, dim2=-1).mean(-1), 1.0).detach()
    return torch.linalg.cholesky(M + (eps * scale)[..., None, None] * _eye(M.shape[-1], M))


def _solve_lower(L, B):
    return torch.linalg.solve_triangular(L, B, upper=False)


def _kl(mu_q, Lq, mu_p, Lp):
    """sum over the batch of KL(N(mu_q, Lq Lq^T) || N(mu_p, Lp Lp^T));
    mu (B, k), Lq (B, k, k), Lp (k, k)."""
    k = mu_q.shape[-1]
    Lp_b = Lp.expand(Lq.shape)
    trace = torch.square(_solve_lower(Lp_b, Lq)).sum((-2, -1))
    quad = torch.square(_solve_lower(Lp_b, (mu_p - mu_q)[..., None])).sum((-2, -1))
    logdet = 2 * torch.log(torch.diagonal(Lp, dim1=-2, dim2=-1).abs()).sum(-1) \
        - 2 * torch.log(torch.diagonal(Lq, dim1=-2, dim2=-1).abs()).sum(-1)
    return (0.5 * (trace + quad - k + logdet)).sum()


def _svgp(Kuf, Lu, Om, diff, kff, eps, P):
    """SVGP posterior at the Kuf columns: mean Kfu Kuu^-1 diff (..., N, C)
    and variances kff - q + diag(A^T T T^T A) + 2 eps per channel
    (..., B, N), A = Lu^-1 Kuf, T = Lu^-1 Om."""
    A = _solve_lower(Lu, Kuf)  # (..., m, N)
    q = torch.square(A).sum(-2)
    v = torch.cholesky_solve(diff, Lu)  # (m, C)
    mu = P.mm(Kuf.transpose(-1, -2), v)
    T = _solve_lower(Lu, Om)  # (B, m, m)
    AT = A.transpose(-1, -2).unsqueeze(-3)  # (..., 1, N, m)
    quad = torch.square(P.mm(AT, T, "tf32")).sum(-1)  # (..., B, N)
    return mu, kff - q.unsqueeze(-2) + quad + 2.0 * eps


class Draws:
    """One step's Monte-Carlo draws, from a ``torch.Generator`` seeded as the
    model's, in the order and the padding of a training step of the model
    (``models/core.py``: ``subsample_batch``, then ``warp_layer``, then
    ``data_layer``). A modality's points are padded, view by view, to Np:
    the most points a view of it has, or the minibatch's ``B``; view v's
    n_v points come first in its block. In order:

    * with a minibatch, each modality's indices in turn, each view's B
      drawn from [0, n_v): ``idx[mod]`` (V, B);
    * the warp noise ``warp`` (S, V, Ntot, D): Ntot is the modalities' Np
      summed, each modality's block at ``offset[mod]``, in the model's
      order (the warp layer runs over all modalities' points at once);
    * each modality's data noise in turn, ``data[mod]`` (S, V Np, L), view
      v's rows from v Np.

    ``counts`` is {modality: per-view counts} and ``widths`` {modality: L},
    both in the model's order."""

    def __init__(self, gen, counts: dict, S, D, widths: dict, B=None):
        dev = gen.device
        self.idx = None
        if B is not None:
            self.idx = {mod: torch.stack([torch.randint(n, (B,), generator=gen, device=dev)
                                          for n in nsl]) for mod, nsl in counts.items()}
        self.padded = {mod: B if B is not None else max(nsl) for mod, nsl in counts.items()}
        self.offset, total = {}, 0
        for mod, n in self.padded.items():
            self.offset[mod], total = total, total + n
        V = len(next(iter(counts.values())))
        self.warp = torch.randn((S, V, total, D), generator=gen, device=dev)
        self.data = {mod: torch.randn((S, V * n, widths[mod]), generator=gen, device=dev)
                     for mod, n in self.padded.items()}


def negative_elbo(p: Dict[str, torch.Tensor], data: dict, draws: Draws, cfg: dict,
                  P: Precision, temperature: float = 1.0):
    """The loss at parameters ``p`` ({name: tensor}, flat names as
    ``"delta_F/expression"``) on ``data``, {modality: (coordinates (N, D),
    outputs (N, P), per-view counts)} in the model's order, with
    ``draws``."""
    dt = P.dtype
    model = cfg["model"]
    eps = float(model.get("diagonal_offset", 1e-5))
    fixed = model.get("fixed_view_idx")
    mods = list(data)
    M, V = len(mods), len(data[mods[0]][2])
    dev = data[mods[0]][0].device
    S = draws.warp.shape[0]
    # Each modality's coordinates, outputs and likelihood weights, view by view.
    Xv, Yv, weights = {}, {}, {}
    for mod, (X, Y, nsl) in data.items():
        offs = [sum(nsl[:v]) for v in range(V)]
        Xv[mod] = [X[o:o + n].to(dt) for o, n in zip(offs, nsl)]
        Yv[mod] = [Y[o:o + n].to(dt) for o, n in zip(offs, nsl)]
        weights[mod] = [torch.ones((), dtype=dt, device=dev)] * V
        if draws.idx is not None:
            idx = draws.idx[mod]
            Xv[mod] = [x[idx[v]] for v, x in enumerate(Xv[mod])]
            Yv[mod] = [y[idx[v]] for v, y in enumerate(Yv[mod])]
            weights[mod] = [torch.tensor(n / idx.shape[1], dtype=dt, device=dev) for n in nsl]

    kl = torch.zeros((), dtype=dt, device=dev)
    G = {mod: [] for mod in mods}  # each view's warped points, (S, n_v, D)
    for v in range(V):
        if v == fixed:
            for mod in mods:
                G[mod].append(Xv[mod][v].expand(S, *Xv[mod][v].shape))
            continue
        # One warp GP over the view's points of every modality.
        sizes = [Xv[mod][v].shape[0] for mod in mods]
        Xw = torch.cat([Xv[mod][v] for mod in mods])
        noise = torch.cat([draws.warp[:, v, draws.offset[mod]:draws.offset[mod] + n]
                           for mod, n in zip(mods, sizes)], dim=1)
        Xt = p["Xtilde"][v]
        ls, var = p["warp_kernel_lengthscales"][v], p["warp_kernel_variances"][v]
        Lu = _chol_jittered(rbf(Xt, Xt, ls, var, P), eps)
        Om = _chol_psd(p["Omega_sqt_G"][v], eps, P)  # (D, m, m)
        mu, sig = _svgp(rbf(Xt, Xw, ls, var, P), Lu, Om, p["delta_G"][v] - Xt,
                        torch.exp(var), eps, P)
        mu = Xw + mu
        if P.fault == "warp_mean_altered":
            mu = mu + 1e-2
        scale = torch.sqrt(torch.clamp_min(sig.transpose(-1, -2), _VAR_FLOOR)) * temperature
        warped = mu + scale * noise.to(dt)
        for mod, g in zip(mods, warped.split(sizes, dim=1)):
            G[mod].append(g)
        kl = kl + _kl(p["delta_G"][v].transpose(0, 1), Om, Xt.transpose(0, 1), Lu)

    # The data GP: Gtilde and the kernel shared, q(u), W and noise per modality.
    Gt = p["Gtilde"]
    lsd, vard = p["data_kernel_lengthscale"][0], p["data_kernel_variance"][0]
    Ld = _chol_jittered(rbf(Gt, Gt, lsd, vard, P), eps)
    nll = 0.0
    for mm, mod in enumerate(mods):
        Gs = torch.cat(G[mod], dim=1)  # (S, N, D), view-major
        OmF = _chol_psd(p[f"Omega_sqt_F/{mod}"], eps, P)  # (L, m, m)
        delta = p[f"delta_F/{mod}"]
        mu, sig = _svgp(rbf(Gt, Gs, lsd, vard, P), Ld, OmF, delta, torch.exp(vard), eps, P)
        sig = torch.clamp_min(sig.transpose(-1, -2), _VAR_FLOOR)  # (S, N, L)
        Np = draws.padded[mod]
        z = torch.cat([draws.data[mod][:, v * Np:v * Np + y.shape[0]]
                       for v, y in enumerate(Yv[mod])], dim=1)
        lat = mu + torch.sqrt(sig) * z.to(dt)
        W = p.get(f"W/{mod}")
        obs = lat if W is None else P.mm(lat, W)  # (S, N, P)
        kl = kl + _kl(delta.transpose(0, 1), OmF, torch.zeros_like(delta.transpose(0, 1)), Ld)

        scale = torch.exp(p["noise_variance"][-M + mm]) + eps
        Yall = torch.cat(Yv[mod], 0)
        w = torch.cat([weights[mod][v].expand(Yv[mod][v].shape[0]) for v in range(V)])
        lp = -0.5 * torch.square((Yall - obs) / scale) - torch.log(scale) - 0.5 * _LOG_2PI
        lp = lp * w[None, :, None]
        if P.fault == "half_batch":
            lp = 2.0 * lp[:, : lp.shape[1] // 2]
        nll = nll - lp.sum()
    return nll / S + kl


class Adam:
    """torch.optim.Adam's update by its formulas (no weight decay)."""

    def __init__(self, lr, betas=(0.9, 0.999), eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m = self.v = None
        self.t = 0

    def step(self, params, grads):
        if self.m is None:
            self.m = {k: torch.zeros_like(g) for k, g in grads.items()}
            self.v = {k: torch.zeros_like(g) for k, g in grads.items()}
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            out[k] = p - self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps)
        return out


def follow(init: Dict[str, torch.Tensor], data: dict, cfg: dict, calls, gen_seed: int,
           P: Precision, minibatch: Optional[int] = None):
    """The first steps of training from ``init`` on ``data`` (as
    :func:`negative_elbo` takes it): ``calls`` is the steps of each fit()
    call in order (a new Adam each call, as each fit() starts from a fresh
    state), the draws from a generator on the data's device seeded
    ``gen_seed``. Returns (losses, first step's gradients, parameters
    after the last step), all float64 on the data's device."""
    dt = P.dtype
    train = cfg["train"]
    S = int(train["S"])
    X = next(iter(data.values()))[0]
    counts = {mod: nsl for mod, (_, _, nsl) in data.items()}
    widths = {mod: init[f"delta_F/{mod}"].shape[-1] for mod in data}
    gen = torch.Generator(device=X.device)
    gen.manual_seed(int(gen_seed))
    params = {k: v.detach().to(dt) for k, v in init.items()}
    losses, first_grad = [], None
    for n_steps in calls:
        opt = Adam(float(train["lr"]))
        for _ in range(n_steps):
            draws = Draws(gen, counts, S, X.shape[-1], widths, minibatch)
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss = negative_elbo(leaves, data, draws, cfg, P)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            if first_grad is None:
                first_grad = {k: g.detach().double() for k, g in grads.items()}
            losses.append(float(loss.detach()))
            with torch.no_grad():
                params = opt.step({k: v.detach() for k, v in leaves.items()}, grads)
    return losses, first_grad, {k: v.detach().double() for k, v in params.items()}


def aligned_means(p: Dict[str, torch.Tensor], data: dict, cfg: dict, view: int, P: Precision,
                  block: int = 8192):
    """The warp layer's posterior mean of view ``view``'s points of every
    modality, concatenated in the model's order (the aligned coordinates
    ``predict`` reads out), in blocks of points."""
    dt = P.dtype
    eps = float(cfg["model"].get("diagonal_offset", 1e-5))
    Xv = torch.cat([X[sum(nsl[:view]):sum(nsl[:view + 1])] for X, _, nsl in data.values()]).to(dt)
    Xt = p["Xtilde"][view].to(dt)
    ls, var = p["warp_kernel_lengthscales"][view].to(dt), p["warp_kernel_variances"][view].to(dt)
    Lu = _chol_jittered(rbf(Xt, Xt, ls, var, P), eps)
    v = torch.cholesky_solve(p["delta_G"][view].to(dt) - Xt, Lu)
    out = torch.cat([xb + P.mm(rbf(Xt, xb, ls, var, P).transpose(0, 1), v)
                     for xb in Xv.split(block)])
    return out + 1e-2 if P.fault == "warp_mean_altered" else out
