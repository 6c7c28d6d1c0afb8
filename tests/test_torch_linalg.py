"""PyTorch port: jitter escalation, merged factor slabs, solves and KLs
against the JAX package's ops/linalg.py on the same numpy inputs.

Tolerances: the selected jitter must be the same rung (rel 1e-6: the same
f32 formula); factors, inverses and solves of well-conditioned input rel
1e-5; KL values rel 1e-5 (sums of a few hundred f32 terms).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from spatial_alignment_tpu.ops import linalg as jl
from spatial_alignment_tpu_torch.ops import linalg as tl

# The suite runs in several worker processes on shared cores; PyTorch's
# default of one intra-op thread per core in each of them oversubscribes
# the machine and slows these tiny problems by orders of magnitude.
torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _spd(rng, B, m, lo=1.0, hi=2.0):
    q, _ = np.linalg.qr(rng.standard_normal((B, m, m)))
    lam = rng.uniform(lo, hi, (B, m))
    return (q * lam[:, None, :]) @ np.swapaxes(q, -1, -2), q, lam


def _crafted(m, rungs, eps, seed=0):
    """Symmetric matrices whose smallest eigenvalue needs the given jitter
    rung (1, 10 or 100 times the base jitter) to factor."""
    rng = np.random.default_rng(seed)
    A, q, lam = _spd(rng, len(rungs), m)
    base = np.asarray(jl._base_jitter(jnp.asarray(A, jnp.float32), eps), np.float64)
    # lam_min + k * base must be < 0 below the wanted rung and > 0 at it.
    lam_min = {1: 1.0, 10: -2.0, 100: -20.0}
    for i, r in enumerate(rungs):
        lam[i, 0] = lam_min[r] * base[i] if r > 1 else 0.5
    A = (q * lam[:, None, :]) @ np.swapaxes(q, -1, -2)
    return A.astype(np.float32)


@pytest.mark.parametrize(
    "m,rungs,expect",
    [
        (16, [1, 10, 100], [1, 100, 100]),  # below the floor gate: one probe, 1x or 100x
        (80, [1, 10, 100], [1, 10, 100]),  # floor regime: two probes, 1x / 10x / 100x
    ],
    ids=["m16_one_probe", "m80_two_probes"],
)
def test_probed_jitter_escalation_matches_jax(m, rungs, expect):
    eps = 1e-2
    A = _crafted(m, rungs, eps)
    base = np.asarray(jl._base_jitter(jnp.asarray(A), eps))
    want = np.asarray(jl._probed_jitter(jnp.asarray(A), eps))
    got = tl._probed_jitter(torch.from_numpy(A), eps).numpy()
    np.testing.assert_allclose(want / base, expect, rtol=1e-6)
    assert _rel(got, want) <= 1e-6
    L_t = tl.jittered_cholesky(torch.from_numpy(A), eps)
    assert torch.isfinite(L_t).all()
    assert _rel(L_t, jl.jittered_cholesky(jnp.asarray(A), eps)) <= 1e-5


def test_add_jitter_and_jittered_cholesky_inverse_match_jax():
    A = _spd(np.random.default_rng(5), 3, 20)[0].astype(np.float32)
    assert _rel(tl.add_jitter(torch.from_numpy(A), 0.25), jl.add_jitter(jnp.asarray(A), 0.25)) <= 1e-6
    L, Linv = tl.jittered_cholesky_inverse(torch.from_numpy(A), 1e-5)
    L_j, Linv_j = jl.jittered_cholesky_inverse(jnp.asarray(A), 1e-5)
    assert _rel(L, L_j) <= 1e-5
    assert _rel(Linv, Linv_j) <= 1e-5


def test_base_jitter_floor_is_detached():
    A = torch.from_numpy(_spd(np.random.default_rng(1), 2, 70)[0].astype(np.float32))
    A.requires_grad_(True)
    base = tl._base_jitter(A, 1e-5)
    assert not base.requires_grad
    assert _rel(base, jl._base_jitter(jnp.asarray(A.detach().numpy()), 1e-5)) <= 1e-6


@pytest.mark.parametrize("n_inv", [0, 3])
def test_joint_factor_cholesky_inverse_matches_jax(n_inv):
    rng = np.random.default_rng(2)
    gram = _spd(rng, 3, 12)[0].astype(np.float32)
    sqt = (0.3 * rng.standard_normal((4, 12, 12))).astype(np.float32)
    Lg_j, Lp_j, inv_j = jl.joint_factor_cholesky_inverse(
        jnp.asarray(gram), jnp.asarray(sqt), 1e-5, n_inv=n_inv
    )
    Lg, Lp, inv = tl.joint_factor_cholesky_inverse(
        torch.from_numpy(gram), torch.from_numpy(sqt), 1e-5, n_inv=n_inv
    )
    assert _rel(Lg, Lg_j) <= 1e-5
    assert _rel(Lp, Lp_j) <= 1e-5
    if n_inv:
        assert _rel(inv, inv_j) <= 1e-5
    else:
        assert inv is None and inv_j is None
    L_psd = tl.factor_psd_cholesky(torch.from_numpy(sqt), 1e-5)
    assert _rel(L_psd, jl.factor_psd_cholesky(jnp.asarray(sqt), 1e-5)) <= 1e-5


def test_solves_and_inverse_match_jax():
    rng = np.random.default_rng(3)
    L = np.linalg.cholesky(_spd(rng, 2, 10)[0]).astype(np.float32)
    rhs = rng.standard_normal((5, 2, 10, 4)).astype(np.float32)  # broadcast batch
    Lt, rt = torch.from_numpy(L), torch.from_numpy(rhs)
    assert _rel(tl.tri_inverse(Lt), jl.tri_inverse(jnp.asarray(L))) <= 1e-5
    assert _rel(tl.cholesky_solve(Lt, rt), jl.cholesky_solve(jnp.asarray(L), jnp.asarray(rhs))) <= 1e-5
    for trans in (False, True):
        got = tl.tri_solve(Lt, rt, trans=trans)
        assert _rel(got, jl.tri_solve(jnp.asarray(L), jnp.asarray(rhs), trans=trans)) <= 1e-5
    assert _rel(tl.chol_logdet(Lt), jl.chol_logdet(jnp.asarray(L))) <= 1e-5


@pytest.mark.parametrize("with_inverse", [False, True])
def test_kl_mvn_chol_matches_jax(with_inverse):
    rng = np.random.default_rng(4)
    Lq = np.linalg.cholesky(_spd(rng, 3, 9)[0]).astype(np.float32)
    Lp = np.linalg.cholesky(_spd(rng, 3, 9)[0]).astype(np.float32)
    mu_q = rng.standard_normal((3, 9)).astype(np.float32)
    mu_p = rng.standard_normal((3, 9)).astype(np.float32)
    inv = np.linalg.inv(Lp).astype(np.float32) if with_inverse else None
    want = jl.kl_mvn_chol(
        *map(jnp.asarray, (mu_q, Lq, mu_p, Lp)),
        chol_p_inv=None if inv is None else jnp.asarray(inv),
    )
    got = tl.kl_mvn_chol(
        *map(torch.from_numpy, (mu_q, Lq, mu_p, Lp)),
        chol_p_inv=None if inv is None else torch.from_numpy(inv),
    )
    assert _rel(got, want) <= 1e-5
    assert _rel(tl.kl_whitened(torch.from_numpy(mu_q), torch.from_numpy(Lq)),
                jl.kl_whitened(jnp.asarray(mu_q), jnp.asarray(Lq))) <= 1e-5
