"""The plain reference of GPSA training, in PyTorch and nothing else.

It imports neither JAX nor either GPSA package: the model's mathematics is
written out here from its description (Jones et al., Nature Methods 2023;
the square variational parameterization of the upstream ``VariationalGPSA``)
in the plainest form, with autograd for the gradients and Adam by its
formulas.

The two layers, each a sparse variational GP with inducing points:

* warp layer, per view v that is not the fixed one: inducing points
  Xtilde_v, RBF kernel (lengthscale, variance per view), prior mean the
  identity, q(u) = N(delta_G, Omega Omega^T) per spatial dimension with
  Omega = chol(A A^T + eps max(1, mean diag) I) from the stored factor A.
  The aligned coordinates are mu + sqrt(var) * noise at the warp
  temperature; the fixed view keeps its coordinates.
* data layer on the aligned coordinates: inducing points Gtilde, one RBF
  kernel, L latent GPs with zero prior mean mixed into the P outputs by W.

The loss is -E[log N(y; f, s)] + KL, with s = exp(noise_variance[-1]) + eps,
the sample mean over S Monte-Carlo draws. Every Gram gets the jitter
eps max(1, mean diag), raised from m = 64 up to the float32 noise floor
0.5 sqrt(m) 1.2e-7 max row sum |K|, and escalated to 10x or 100x where a
float32 Cholesky fails at the lower rung: the model's stated numerical
safeguard.

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
    model's, in the order a training step of the model draws them: the
    minibatch indices per view (when ``B``), the warp noise
    (S, V, n, D), the data noise (S, V n, L)."""

    def __init__(self, gen, nsl, S, D, L, B=None):
        dev = gen.device
        self.idx = None
        if B is not None:
            self.idx = torch.stack([torch.randint(n, (B,), generator=gen, device=dev)
                                    for n in nsl])
        n = B if B is not None else max(nsl)
        V = len(nsl)
        self.warp = torch.randn((S, V, n, D), generator=gen, device=dev)
        self.data = torch.randn((S, V * n, L), generator=gen, device=dev)


def negative_elbo(p: Dict[str, torch.Tensor], X, Y, nsl, draws: Draws, cfg: dict,
                  P: Precision, temperature: float = 1.0):
    """The loss at parameters ``p`` ({name: tensor}, flat names as
    ``"delta_F/expression"``) on coordinates X (N, D) and outputs Y (N, P)
    of views of sizes ``nsl``, with ``draws``."""
    dt = P.dtype
    model = cfg["model"]
    eps = float(model.get("diagonal_offset", 1e-5))
    fixed = model.get("fixed_view_idx")
    V, D = len(nsl), X.shape[-1]
    mod = "expression"
    offs = [sum(nsl[:v]) for v in range(V)]
    Xv = [X[o:o + n].to(dt) for o, n in zip(offs, nsl)]
    Yv = [Y[o:o + n].to(dt) for o, n in zip(offs, nsl)]
    S = draws.warp.shape[0]
    weights = [torch.ones((), dtype=dt, device=X.device)] * V
    if draws.idx is not None:
        B = draws.idx.shape[1]
        Xv = [x[draws.idx[v]] for v, x in enumerate(Xv)]
        Yv = [y[draws.idx[v]] for v, y in enumerate(Yv)]
        weights = [torch.tensor(n / B, dtype=dt, device=X.device) for n in nsl]

    kl = torch.zeros((), dtype=dt, device=X.device)
    G = []
    for v in range(V):
        if v == fixed:
            G.append(Xv[v].expand(S, *Xv[v].shape))
            continue
        Xt = p["Xtilde"][v]
        ls, var = p["warp_kernel_lengthscales"][v], p["warp_kernel_variances"][v]
        Lu = _chol_jittered(rbf(Xt, Xt, ls, var, P), eps)
        Om = _chol_psd(p["Omega_sqt_G"][v], eps, P)  # (D, m, m)
        mu, sig = _svgp(rbf(Xt, Xv[v], ls, var, P), Lu, Om, p["delta_G"][v] - Xt,
                        torch.exp(var), eps, P)
        mu = Xv[v] + mu
        if P.fault == "warp_mean_altered":
            mu = mu + 1e-2
        scale = torch.sqrt(torch.clamp_min(sig.transpose(-1, -2), _VAR_FLOOR)) * temperature
        G.append(mu + scale * draws.warp[:, v, : Xv[v].shape[0]].to(dt))
        kl = kl + _kl(p["delta_G"][v].transpose(0, 1), Om, Xt.transpose(0, 1), Lu)

    Gs = torch.cat(G, dim=1)  # (S, N, D), view-major
    Gt = p["Gtilde"]
    lsd, vard = p["data_kernel_lengthscale"][0], p["data_kernel_variance"][0]
    Ld = _chol_jittered(rbf(Gt, Gt, lsd, vard, P), eps)
    OmF = _chol_psd(p[f"Omega_sqt_F/{mod}"], eps, P)  # (L, m, m)
    delta = p[f"delta_F/{mod}"]
    mu, sig = _svgp(rbf(Gt, Gs, lsd, vard, P), Ld, OmF, delta, torch.exp(vard), eps, P)
    sig = torch.clamp_min(sig.transpose(-1, -2), _VAR_FLOOR)  # (S, N, L)
    lat = mu + torch.sqrt(sig) * draws.data.to(dt)
    obs = P.mm(lat, p[f"W/{mod}"])  # (S, N, P)
    kl = kl + _kl(delta.transpose(0, 1), OmF, torch.zeros_like(delta.transpose(0, 1)), Ld)

    scale = torch.exp(p["noise_variance"][-1]) + eps
    Yall = torch.cat(Yv, 0)
    w = torch.cat([weights[v].expand(Yv[v].shape[0]) for v in range(V)])
    lp = -0.5 * torch.square((Yall - obs) / scale) - torch.log(scale) - 0.5 * _LOG_2PI
    lp = lp * w[None, :, None]
    if P.fault == "half_batch":
        lp = 2.0 * lp[:, : lp.shape[1] // 2]
    return -lp.sum() / S + kl


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


def follow(init: Dict[str, torch.Tensor], X, Y, nsl, cfg: dict, calls, gen_seed: int,
           P: Precision, minibatch: Optional[int] = None):
    """The first steps of training from ``init``: ``calls`` is the steps of
    each fit() call in order (a new Adam each call, as each fit() starts
    from a fresh state), the draws from a generator on X's device seeded
    ``gen_seed``. Returns (losses, first step's gradients, parameters
    after the last step), all float64 on X's device."""
    dt = P.dtype
    train = cfg["train"]
    L = cfg["model"]["n_latent_gps"]
    S = int(train["S"])
    gen = torch.Generator(device=X.device)
    gen.manual_seed(int(gen_seed))
    params = {k: v.detach().to(dt) for k, v in init.items()}
    losses, first_grad = [], None
    for n_steps in calls:
        opt = Adam(float(train["lr"]))
        for _ in range(n_steps):
            draws = Draws(gen, nsl, S, X.shape[-1], L, minibatch)
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss = negative_elbo(leaves, X, Y, nsl, draws, cfg, P)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            if first_grad is None:
                first_grad = {k: g.detach().double() for k, g in grads.items()}
            losses.append(float(loss.detach()))
            with torch.no_grad():
                params = opt.step({k: v.detach() for k, v in leaves.items()}, grads)
    return losses, first_grad, {k: v.detach().double() for k, v in params.items()}


def aligned_means(p: Dict[str, torch.Tensor], X, nsl, cfg: dict, view: int, P: Precision,
                  block: int = 8192):
    """The warp layer's posterior mean of view ``view``'s coordinates (the
    aligned coordinates ``predict`` reads out), in blocks of points."""
    dt = P.dtype
    eps = float(cfg["model"].get("diagonal_offset", 1e-5))
    off = sum(nsl[:view])
    Xv = X[off:off + nsl[view]].to(dt)
    Xt = p["Xtilde"][view].to(dt)
    ls, var = p["warp_kernel_lengthscales"][view].to(dt), p["warp_kernel_variances"][view].to(dt)
    Lu = _chol_jittered(rbf(Xt, Xt, ls, var, P), eps)
    v = torch.cholesky_solve(p["delta_G"][view].to(dt) - Xt, Lu)
    out = torch.cat([xb + P.mm(rbf(Xt, xb, ls, var, P).transpose(0, 1), v)
                     for xb in Xv.split(block)])
    return out + 1e-2 if P.fault == "warp_mean_altered" else out
