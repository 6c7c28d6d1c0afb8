"""Model operations of one training step of GPSA (forward of the negative
ELBO; the backward counted as twice the forward, nothing recomputed),
from a configuration's shapes and a traffic mix's minibatch.

Counted in the forward, per sparse GP layer with m inducing points at n
points, mean width C and B variance channels:
  Grams             (3 D + 3) a pair (differences, squares, sums, scale, exp, variance)
  Cholesky          m^3 / 3 a Gram, and a variational factor A A^T (m^3) and its
                    Cholesky (m^3 / 3) a channel
  A = L^-1 Kuf      m^2 n; its column norms 2 m n
  mean              a width-C solve pair 2 m^2 C, Kfu v 2 m n C
  variance          T = L^-1 Omega m^3 / 3 a channel, the quadratic form
                    2 m^2 n + 2 m n a channel, assembly 4 n a channel
  KL                a solve with m + 1 right-hand sides m^2 (m + 1) a channel
  sampling          3 a sampled value; LMC 2 L P a point; likelihood 6 a value
The warp layer runs once a step for each view that is not fixed (C = B = D
on the view's points of every modality, each modality padded to its fullest
view). The data layer's Gram of its inducing points and its Cholesky run
once a step; each modality's channels' factors, solves and KL once a step,
and its predictive pass, sampling and likelihood once for every Monte-Carlo
sample (C = B = its L latents, or its P outputs where it has no LMC, on all
views' points of that modality); the LMC product only where the modality
has a W.
"""

from __future__ import annotations

from gpsa_bench.datagen import modalities, n_outputs, points_per_view, spatial_dims


def _gram(m, n, D):
    return m * n * (3 * D + 3)


def _factors(m, channels, D):
    """Gram of the inducing points, its Cholesky, the channels' factors."""
    return _gram(m, m, D) + m**3 / 3 + channels * (m**3 + m**3 / 3)


def _predictive(m, n, C, B, D):
    return (_gram(m, n, D) + m * m * n + 2 * m * n + 2 * m * n * C
            + B * (2 * m * m * n + 2 * m * n + 4 * n))


def _per_step(m, C, B):
    """The parts of a layer computed once a step: the mean's solves, T, KL."""
    return 2 * m * m * C + B * m**3 / 3 + B * m * m * (m + 1)


def forward_flops(cfg: dict, traffic: dict) -> float:
    """Operations of one forward of the negative ELBO."""
    model, train = cfg["model"], cfg["train"]
    D, S = spatial_dims(cfg), int(train["S"])
    lmc, outputs, counts = modalities(cfg), n_outputs(cfg), points_per_view(cfg)
    batch = traffic.get("minibatch_size")
    padded = {mod: int(batch) if batch else max(nsl) for mod, nsl in counts.items()}
    V = len(next(iter(counts.values())))
    active = V - (0 if model.get("fixed_view_idx") is None else 1)
    mX, mG = int(model["m_X_per_view"]), int(model["m_G"])
    n = sum(padded.values())
    warp = active * (_factors(mX, D, D) + _predictive(mX, n, D, D, D) + _per_step(mX, D, D)
                     + 3 * n * D)
    width = {mod: outputs[mod] if L is None else L for mod, L in lmc.items()}
    data_layer = _factors(mG, sum(width.values()), D)
    for mod, L in width.items():
        N, P = V * padded[mod], outputs[mod]
        data_layer = data_layer + _per_step(mG, L, L)
        data_layer = data_layer + S * (_predictive(mG, N, L, L, D) + 3 * N * L
                                       + (0 if lmc[mod] is None else 2 * N * L * P) + 6 * N * P)
    return float(warp + data_layer)


def step_flops(cfg: dict, traffic: dict) -> float:
    """Operations of one training step: forward, and the backward at twice
    the forward."""
    return 3.0 * forward_flops(cfg, traffic)
