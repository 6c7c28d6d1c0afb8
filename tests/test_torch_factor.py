"""PyTorch port: the fused Cholesky + inverse (plain version, composed
backward, NaN contract, the ``fused_factor_inverse`` routing) against the
JAX package. The CUDA kernel is held against the plain version in
test_torch_cuda.py.

Tolerances: rel 1e-5 on factors and inverses of well-conditioned SPD input
(cond < ~10; f32 LAPACK on both sides); rel 1e-4 against the Pallas kernel
in interpret mode (another elimination order, its own tests' bound); rel
2e-4 on gradients, the bound ``test_pallas_factor.py`` puts on the fused
backward against the unfused chain (three solves and products in f32).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spatial_alignment_tpu.ops import linalg as jl
from spatial_alignment_tpu.ops import pallas_factor as pf
from spatial_alignment_tpu_torch.ops import factor
from spatial_alignment_tpu_torch.ops import linalg as tl

# The suite runs in several worker processes on shared cores; PyTorch's
# default of one intra-op thread per core in each of them oversubscribes
# the machine and slows these tiny problems by orders of magnitude.
torch.set_num_threads(1)


def _spd(rng, B, m):
    a = rng.standard_normal((B, m, m)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) / m + np.eye(m, dtype=np.float32)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jax_chain(A):
    """The unfused chain the JAX package runs when the kernel is off."""
    L = jnp.linalg.cholesky(A)
    return L, jl.tri_inverse(L)


@pytest.mark.parametrize("B,m", [(3, 20), (14, 50), (3, 17), (3, 33), (2, 37)])
def test_forward_matches_jax(B, m):
    A = _spd(np.random.default_rng(0), B, m)
    L, Linv = factor.cholesky_and_inverse(torch.from_numpy(A))
    Lj, Linvj = _jax_chain(jnp.asarray(A))
    assert _rel(L, Lj) <= 1e-5
    assert _rel(Linv, Linvj) <= 1e-5
    assert torch.count_nonzero(torch.triu(L, 1)) == 0
    assert torch.count_nonzero(torch.triu(Linv, 1)) == 0


def test_matches_pallas_kernel_in_interpret_mode():
    """Forward and the composed VJP against the Pallas kernel's."""
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(1)
    A = _spd(rng, 2, 64)
    wL = rng.standard_normal(A.shape).astype(np.float32)
    wI = rng.standard_normal(A.shape).astype(np.float32)

    def loss_p(a):
        L, Linv = pf.cholesky_and_inverse(a)
        return jnp.sum(L * wL) + jnp.sum(Linv * wI)

    with pltpu.force_tpu_interpret_mode():
        Lp, Linvp = pf.cholesky_and_inverse(jnp.asarray(A))
        gp = jax.grad(loss_p)(jnp.asarray(A))
    a = torch.from_numpy(A).requires_grad_(True)
    L, Linv = factor.cholesky_and_inverse(a)
    ((L * torch.from_numpy(wL)).sum() + (Linv * torch.from_numpy(wI)).sum()).backward()
    assert _rel(L.detach(), Lp) <= 1e-4
    assert _rel(Linv.detach(), Linvp) <= 1e-4
    assert _rel(a.grad, gp) <= 2e-4


def test_gradient_matches_jax_unfused_chain():
    rng = np.random.default_rng(2)
    A = _spd(rng, 3, 24)
    wL = rng.standard_normal(A.shape).astype(np.float32)
    wI = rng.standard_normal(A.shape).astype(np.float32)

    def loss_j(a):
        L, Linv = _jax_chain(a)
        return jnp.sum(L * wL) + jnp.sum(Linv * wI)

    gj = jax.grad(loss_j)(jnp.asarray(A))
    a = torch.from_numpy(A).requires_grad_(True)
    L, Linv = factor.cholesky_and_inverse(a)
    ((L * torch.from_numpy(wL)).sum() + (Linv * torch.from_numpy(wI)).sum()).backward()
    assert _rel(a.grad, gj) <= 2e-4


def test_gradient_through_one_output():
    """The model keeps the inverses of a prefix of the slab only: the other
    output's cotangent is zero."""
    rng = np.random.default_rng(3)
    A = _spd(rng, 4, 16)
    wI = rng.standard_normal((2, 16, 16)).astype(np.float32)
    gj = jax.grad(lambda x: jnp.sum(_jax_chain(x)[1][:2] * wI))(jnp.asarray(A))
    a = torch.from_numpy(A).requires_grad_(True)
    (factor.cholesky_and_inverse(a)[1][:2] * torch.from_numpy(wI)).sum().backward()
    assert _rel(a.grad, gj) <= 2e-4


def test_nan_contract():
    """An indefinite lane gets NaN over the lower triangle of both L and
    L^-1 and 0 above; the other lanes are what they are without it."""
    A = _spd(np.random.default_rng(4), 3, 20)
    bad = A.copy()
    bad[1] -= 3.0 * np.eye(20, dtype=np.float32)
    L, Linv = (t.numpy() for t in factor.cholesky_and_inverse(torch.from_numpy(bad)))
    assert np.isnan(np.asarray(jnp.linalg.cholesky(bad[1]))).any()  # JAX fails the lane too
    lower = np.tril(np.ones((20, 20), bool))
    for out in (L, Linv):
        assert np.isnan(out[1][lower]).all()
        assert (out[1][~lower] == 0).all()
    L0, Linv0 = (t.numpy() for t in factor.cholesky_and_inverse(torch.from_numpy(A)))
    np.testing.assert_array_equal(L[[0, 2]], L0[[0, 2]])
    np.testing.assert_array_equal(Linv[[0, 2]], Linv0[[0, 2]])


def test_symmetrizes_input_like_jax():
    A = _spd(np.random.default_rng(5), 2, 12)
    A_asym = A + np.triu(np.full_like(A, 0.01), 1)  # only the upper triangle moves
    L, _ = factor.cholesky_and_inverse(torch.from_numpy(A_asym))
    assert _rel(L, jnp.linalg.cholesky(A_asym)) <= 1e-5


def test_linalg_routes_only_the_explicit_opt_in():
    """``fused="fused"`` takes the factor module (its plain version on the
    CPU, counted) and matches the JAX package's unfused chain; ``auto``,
    ``off`` and None do not; anything else raises, as in JAX."""
    rng = np.random.default_rng(6)
    gram = _spd(rng, 3, 16)
    sqt = (0.3 * rng.standard_normal((4, 16, 16))).astype(np.float32)
    factor.plain_calls = 0
    for fused in (None, "auto", "off"):
        tl.jittered_cholesky_inverse(torch.from_numpy(gram), 1e-5, fused=fused)
        tl.joint_factor_cholesky_inverse(
            torch.from_numpy(gram), torch.from_numpy(sqt), 1e-5, n_inv=2, fused=fused
        )
    assert factor.plain_calls == 0
    L, Linv = tl.jittered_cholesky_inverse(torch.from_numpy(gram), 1e-5, fused="fused")
    Lj, Linvj = jl.jittered_cholesky_inverse(jnp.asarray(gram), 1e-5, fused="off")
    assert _rel(L, Lj) <= 1e-5 and _rel(Linv, Linvj) <= 1e-5
    Lg, Lp, inv = tl.joint_factor_cholesky_inverse(
        torch.from_numpy(gram), torch.from_numpy(sqt), 1e-5, n_inv=2, fused="fused"
    )
    Lgj, Lpj, invj = jl.joint_factor_cholesky_inverse(
        jnp.asarray(gram), jnp.asarray(sqt), 1e-5, n_inv=2, fused="off"
    )
    assert factor.plain_calls == 2
    assert inv.shape == (2, 16, 16)
    for got, want in ((Lg, Lgj), (Lp, Lpj), (inv, invj)):
        assert _rel(got, want) <= 1e-5
    with pytest.raises(ValueError, match="fused_factor_inverse"):
        tl.jittered_cholesky_inverse(torch.from_numpy(gram), 1e-5, fused="bogus")


def test_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        factor.cholesky_and_inverse_kernel(torch.eye(4))
