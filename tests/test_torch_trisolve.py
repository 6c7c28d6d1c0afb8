"""PyTorch port: the batched triangular solve and inverse (plain version,
solve-based backward, non-finite lanes, the ``cholesky_impl`` routing)
against the JAX package. The CUDA kernel is held against the plain version
in test_torch_cuda.py.

Tolerances: rel 1e-5 against ``jax.scipy.linalg`` on well-conditioned
factors (cond < ~10; f32 substitution on both sides); rel 1e-4 against
the Pallas kernel in interpret mode (blocked substitution in another
order, the bound its own tests use) and on gradients (two solves and a
product in float32).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import torch

from spatial_alignment_tpu.ops import linalg as jl
from spatial_alignment_tpu.ops import pallas_trisolve as pt
from spatial_alignment_tpu_torch.ops import linalg as tl
from spatial_alignment_tpu_torch.ops import trisolve as ts

# The suite runs in several worker processes on shared cores; PyTorch's
# default of one intra-op thread per core in each of them oversubscribes
# the machine and slows these tiny problems by orders of magnitude.
torch.set_num_threads(1)


def _factor(rng, B, m):
    a = rng.standard_normal((B, m, m))
    return np.linalg.cholesky(a @ np.swapaxes(a, -1, -2) / m + np.eye(m)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("B,m,n", [(3, 20, 5), (2, 50, 200)], ids=["narrow", "wide"])
def test_solve_matches_jax(B, m, n, trans):
    rng = np.random.default_rng(0)
    L = _factor(rng, B, m)
    rhs = rng.standard_normal((B, m, n)).astype(np.float32)
    got = ts.tri_solve(torch.from_numpy(L), torch.from_numpy(rhs), trans)
    want = jsl.solve_triangular(L, rhs, lower=True, trans=1 if trans else 0)
    assert got.shape == (B, m, n)
    assert _rel(got, want) <= 1e-5


def test_shared_factor_broadcasts_over_the_batch():
    """The data layer's form: one factor against a batch of right-hand
    sides; its gradient is summed over the batch, as JAX's broadcast."""
    rng = np.random.default_rng(1)
    L = _factor(rng, 1, 16)[0]
    rhs = rng.standard_normal((4, 16, 6)).astype(np.float32)
    W = rng.standard_normal((4, 16, 6)).astype(np.float32)
    Lt = torch.from_numpy(L).requires_grad_(True)
    X = ts.tri_solve(Lt, torch.from_numpy(rhs))
    (X * torch.from_numpy(W)).sum().backward()
    want = jl.tri_solve(jnp.asarray(L), jnp.asarray(rhs))
    g_want = jax.grad(lambda l: jnp.sum(jl.tri_solve(l, jnp.asarray(rhs)) * W))(jnp.asarray(L))
    assert _rel(X.detach(), want) <= 1e-5
    assert Lt.grad.shape == (16, 16)
    assert _rel(Lt.grad, g_want) <= 1e-4


def test_inverse_matches_jax_and_is_lower():
    L = _factor(np.random.default_rng(2), 3, 24)
    got = ts.tri_inverse(torch.from_numpy(L))
    assert _rel(got, jl.tri_inverse(jnp.asarray(L))) <= 1e-5
    assert torch.count_nonzero(torch.triu(got, 1)) == 0


@pytest.mark.parametrize("trans", [False, True])
def test_solve_gradients_match_jax(trans):
    rng = np.random.default_rng(3)
    B, m, n = 2, 24, 7
    L = _factor(rng, B, m)
    rhs = rng.standard_normal((B, m, n)).astype(np.float32)
    W = rng.standard_normal((B, m, n)).astype(np.float32)
    gj = jax.grad(
        lambda l, r: jnp.sum(jsl.solve_triangular(l, r, lower=True, trans=1 if trans else 0) * W),
        argnums=(0, 1),
    )(jnp.asarray(L), jnp.asarray(rhs))
    Lt = torch.from_numpy(L).requires_grad_(True)
    rt = torch.from_numpy(rhs).requires_grad_(True)
    (ts.tri_solve(Lt, rt, trans) * torch.from_numpy(W)).sum().backward()
    # JAX's gradient of the triangular solve w.r.t. L is lower triangular.
    assert _rel(Lt.grad, gj[0]) <= 1e-4
    assert _rel(rt.grad, gj[1]) <= 1e-4


def test_inverse_gradient_matches_jax():
    L = _factor(np.random.default_rng(4), 2, 20)
    gj = jax.grad(lambda l: jnp.sum(jnp.square(jl.tri_inverse(l))))(jnp.asarray(L))
    Lt = torch.from_numpy(L).requires_grad_(True)
    torch.square(ts.tri_inverse(Lt)).sum().backward()
    assert _rel(Lt.grad, gj) <= 1e-4


@pytest.fixture
def interp():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def test_matches_pallas_kernel_in_interpret_mode(interp):
    rng = np.random.default_rng(5)
    L = _factor(rng, 2, 64)
    rhs = rng.standard_normal((2, 64, 8)).astype(np.float32)
    Lj, rj = jnp.asarray(L), jnp.asarray(rhs)
    Lt, rt = torch.from_numpy(L), torch.from_numpy(rhs)
    for trans in (False, True):
        assert _rel(ts.tri_solve(Lt, rt, trans), pt.tri_solve(Lj, rj, trans)) <= 1e-4
    assert _rel(ts.tri_inverse(Lt), pt.tri_inverse(Lj)) <= 1e-4


def test_vjp_matches_pallas_kernel_in_interpret_mode(interp):
    """The solve's and the inverse's custom VJPs against the Pallas kernel's."""
    rng = np.random.default_rng(6)
    L = _factor(rng, 2, 64)
    rhs = rng.standard_normal((2, 64, 8)).astype(np.float32)
    W = rng.standard_normal((2, 64, 8)).astype(np.float32)
    gj = jax.grad(lambda l, r: jnp.sum(pt.tri_solve(l, r, False) * W), argnums=(0, 1))(
        jnp.asarray(L), jnp.asarray(rhs)
    )
    Lt = torch.from_numpy(L).requires_grad_(True)
    rt = torch.from_numpy(rhs).requires_grad_(True)
    (ts.tri_solve(Lt, rt) * torch.from_numpy(W)).sum().backward()
    assert _rel(Lt.grad, gj[0]) <= 1e-4
    assert _rel(rt.grad, gj[1]) <= 1e-4
    gi = jax.grad(lambda l: jnp.sum(jnp.square(pt.tri_inverse(l))))(jnp.asarray(L))
    Li = torch.from_numpy(L).requires_grad_(True)
    torch.square(ts.tri_inverse(Li)).sum().backward()
    assert _rel(Li.grad, gi) <= 1e-4


@pytest.mark.parametrize("pivot", [np.nan, 0.0], ids=["nan_pivot", "zero_pivot"])
def test_non_finite_pivot_stays_in_its_lane(pivot):
    """The jitter probes may feed NaN factors through solves: a zero or NaN
    pivot makes its own lane non-finite, as XLA's solve does, and leaves
    the other lanes exactly as without it."""
    rng = np.random.default_rng(7)
    L = _factor(rng, 3, 16)
    rhs = rng.standard_normal((3, 16, 4)).astype(np.float32)
    bad = L.copy()
    bad[1, 5, 5] = pivot
    for trans in (False, True):
        got = ts.tri_solve(torch.from_numpy(bad), torch.from_numpy(rhs), trans).numpy()
        want = np.asarray(jsl.solve_triangular(bad, rhs, lower=True, trans=1 if trans else 0))
        assert not np.isfinite(got[1]).all() and not np.isfinite(want[1]).all()
        clean = ts.tri_solve(torch.from_numpy(L), torch.from_numpy(rhs), trans).numpy()
        np.testing.assert_array_equal(got[[0, 2]], clean[[0, 2]])
    inv = ts.tri_inverse(torch.from_numpy(bad)).numpy()
    assert not np.isfinite(inv[1]).all()
    assert np.isfinite(inv[[0, 2]]).all()


def test_linalg_routes_only_the_explicit_opt_in():
    """``impl="pallas"`` takes the trisolve module (its plain version on the
    CPU, counted); ``auto``, ``xla`` and None keep solve_triangular, as the
    JAX package keeps XLA's solve."""
    rng = np.random.default_rng(8)
    L = torch.from_numpy(_factor(rng, 2, 12))
    rhs = torch.from_numpy(rng.standard_normal((2, 12, 3)).astype(np.float32))
    ts.plain_calls = 0
    for impl in (None, "auto", "xla"):
        tl.tri_solve(L, rhs, impl=impl)
        tl.tri_inverse(L, impl=impl)
        tl.cholesky_solve(L, rhs, impl=impl)
    assert ts.plain_calls == 0
    want = jsl.cho_solve((np.asarray(L), True), np.asarray(rhs))
    assert _rel(tl.cholesky_solve(L, rhs, impl="pallas"), want) <= 1e-5
    assert ts.plain_calls == 2  # two substitutions
    tl.tri_inverse(L, impl="pallas")
    mu = torch.zeros(2, 12)
    kl = tl.kl_mvn_chol(mu, L, mu + 0.1, L, impl="pallas")
    assert ts.plain_calls == 4
    assert _rel(kl, jl.kl_mvn_chol(*(jnp.asarray(t.numpy()) for t in (mu, L, mu + 0.1, L)))) <= 1e-5


def test_kernel_refuses_cpu_tensors():
    L = torch.eye(4)
    with pytest.raises(ValueError):
        ts.tri_solve_kernel(L, torch.ones(4, 2))
    with pytest.raises(ValueError):
        ts.tri_inverse_kernel(L)
