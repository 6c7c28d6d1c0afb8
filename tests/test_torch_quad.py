"""PyTorch port: the quad-diag forward and backward (plain versions, the
autograd function around the kernels, both forms of the factors, the
``quad_diag_impl`` routing) against the JAX package. The CUDA kernels are
held against the plain versions in test_torch_cuda.py.

Tolerances: rel 2e-6 on the forward and 3e-5 on gradients against
``pallas_quad``'s jnp form and its interpret-mode kernel, the bounds the
JAX package's own tests use (float32 sums of m products in another order).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spatial_alignment_tpu.ops import pallas_quad as pq
from spatial_alignment_tpu_torch.models import core as tcore
from spatial_alignment_tpu_torch.ops import quad

# The suite runs in several worker processes on shared cores; PyTorch's
# default of one intra-op thread per core in each of them oversubscribes
# the machine and slows these tiny problems by orders of magnitude.
torch.set_num_threads(1)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jax_quad(x, F):
    """The JAX package's quad-diag on the same forms: shared factors
    directly, per-group factors under vmap as its warp layer calls it."""
    if F.ndim == 3:
        return pq._quad_jnp(x, F, "highest")
    lead = x.shape[:-2]
    xf = x.reshape((-1,) + x.shape[-2:])
    Ff = F.reshape((-1,) + F.shape[-3:])
    out = jax.vmap(lambda a, b: pq._quad_jnp(a, b, "highest"))(xf, Ff)
    return out.reshape(lead + out.shape[-2:])


_FORMS = [
    ((3,), 40, 12, 4, False),  # data layer: S samples, shared (L, m, m)
    ((2, 3), 17, 9, 2, False),
    ((2,), 30, 10, 3, True),  # warp layer: per-view (V, D, m, m)
    # Across the CUDA forward's tiles: ragged points and depths.
    ((2,), 130, 37, 2, False),
    ((3,), 130, 37, 1, True),
    ((2,), 40, 17, 3, False),
    ((2,), 33, 33, 2, True),
    # Past m = 256, where the CUDA backward shares each row group between
    # two warps.
    ((1,), 16, 264, 2, False),
]


@pytest.mark.parametrize("lead,N,m,L,per_group", _FORMS)
def test_forward_matches_jax(lead, N, m, L, per_group):
    rng = np.random.default_rng(0)
    x = _rand(rng, lead + (N, m))
    F = _rand(rng, (lead if per_group else ()) + (L, m, m), 0.3)
    want = _jax_quad(jnp.asarray(x), jnp.asarray(F))
    for got in (
        quad.quad_diag(torch.from_numpy(x), torch.from_numpy(F)),
        quad.quad_diag_plain(torch.from_numpy(x), torch.from_numpy(F)),
    ):
        assert got.shape == lead + (L, N)
        assert _rel(got, want) <= 2e-6


@pytest.mark.parametrize("lead,N,m,L,per_group", _FORMS)
def test_backward_matches_jax(lead, N, m, L, per_group):
    """The explicit pullback (the kernels' plain version) against JAX's
    autodiff of the same function."""
    rng = np.random.default_rng(1)
    x = _rand(rng, lead + (N, m))
    F = _rand(rng, (lead if per_group else ()) + (L, m, m), 0.3)
    g = _rand(rng, lead + (L, N))
    gx, gF = jax.grad(lambda a, b: jnp.vdot(_jax_quad(a, b), g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(F)
    )
    xt = torch.from_numpy(x).requires_grad_(True)
    Ft = torch.from_numpy(F).requires_grad_(True)
    (quad.quad_diag(xt, Ft) * torch.from_numpy(g)).sum().backward()
    assert Ft.grad.shape == F.shape
    assert _rel(xt.grad, gx) <= 3e-5
    assert _rel(Ft.grad, gF) <= 3e-5


def test_takes_a_transposed_view_as_the_model_passes_it():
    """svgp_mean_var passes half^T, a transposed view; the gradient flows
    back to the untransposed tensor."""
    rng = np.random.default_rng(2)
    half = torch.from_numpy(_rand(rng, (2, 8, 25))).requires_grad_(True)
    F = torch.from_numpy(_rand(rng, (3, 8, 8), 0.3))
    quad.quad_diag(half.transpose(-1, -2), F).sum().backward()
    ref = half.detach().clone().requires_grad_(True)
    quad.quad_diag_plain(ref.transpose(-1, -2), F).sum().backward()
    assert _rel(half.grad, ref.grad) <= 3e-5


def test_matches_pallas_kernel_in_interpret_mode():
    rng = np.random.default_rng(3)
    x = _rand(rng, (3, 40, 12))
    F = _rand(rng, (4, 12, 12), 0.3)
    g = _rand(rng, (3, 4, 40))
    pal = lambda a, b: pq.quad_diag(a, b, "highest", True, 16, True)  # force, interpret
    want = pal(jnp.asarray(x), jnp.asarray(F))
    gx, gF = jax.grad(lambda a, b: jnp.vdot(pal(a, b), g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(F)
    )
    xt = torch.from_numpy(x).requires_grad_(True)
    Ft = torch.from_numpy(F).requires_grad_(True)
    out = quad.quad_diag(xt, Ft)
    (out * torch.from_numpy(g)).sum().backward()
    assert _rel(out.detach(), want) <= 2e-6
    assert _rel(xt.grad, gx) <= 3e-5
    assert _rel(Ft.grad, gF) <= 3e-5


def test_core_routes_only_the_explicit_opt_in():
    """``quad_diag_impl="pallas"`` takes the autograd function (its plain
    versions on the CPU, counted: one forward, one backward); ``xla`` keeps
    the plain product under autograd."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_rand(rng, (2, 20, 6))).requires_grad_(True)
    F = torch.from_numpy(_rand(rng, (3, 6, 6), 0.3))
    quad.plain_calls = 0
    base = tcore._quad_diag(x, F, "xla")
    base.sum().backward()
    assert quad.plain_calls == 0
    got = tcore._quad_diag(x, F, "pallas")
    got.sum().backward()
    assert quad.plain_calls == 2
    assert _rel(got.detach(), base.detach()) <= 2e-6


def test_factors_must_match_the_leading_dims():
    with pytest.raises(ValueError, match="leading dims"):
        quad.quad_diag(torch.zeros(2, 5, 4), torch.zeros(3, 2, 4, 4))


def test_kernels_refuse_cpu_tensors():
    x, F = torch.zeros(1, 5, 4), torch.zeros(2, 4, 4)
    with pytest.raises(ValueError):
        quad.quad_fwd_kernel(x, F)
    with pytest.raises(ValueError):
        quad.quad_bwd_kernel(x, F, torch.zeros(1, 2, 5))
