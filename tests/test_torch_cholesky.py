"""PyTorch port: the batched Cholesky (plain version, backward, NaN
contract) against the JAX package. The CUDA kernel is held against the
plain version in test_torch_cuda.py.

Tolerances: rel 1e-5 on factors of well-conditioned SPD input (cond < ~10;
f32 LAPACK on both sides), 1e-4 on gradients (two triangular solves in
float32), 1e-4 against the Pallas kernel in interpret mode (blocked
elimination in another order, the bound its own tests use).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spatial_alignment_tpu.ops import pallas_cholesky as pc
from spatial_alignment_tpu_torch.ops import cholesky as ch

# The suite runs in several worker processes on shared cores; PyTorch's
# default of one intra-op thread per core in each of them oversubscribes
# the machine and slows these tiny problems by orders of magnitude.
torch.set_num_threads(1)


def _spd(rng, B, m):
    a = rng.standard_normal((B, m, m)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) / m + np.eye(m, dtype=np.float32)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("B,m", [(3, 50), (14, 50)])
def test_plain_forward_matches_jax(B, m):
    A = _spd(np.random.default_rng(0), B, m)
    L = ch.cholesky(torch.from_numpy(A))
    assert _rel(L, jnp.linalg.cholesky(A)) <= 1e-5
    assert torch.count_nonzero(torch.triu(L, 1)) == 0


def test_gradient_matches_jax():
    rng = np.random.default_rng(1)
    A = _spd(rng, 3, 50)
    W = rng.standard_normal(A.shape).astype(np.float32)
    g_j = jax.grad(lambda a: jnp.sum(jnp.linalg.cholesky(a) * W))(jnp.asarray(A))
    a = torch.from_numpy(A).requires_grad_(True)
    (ch.cholesky(a) * torch.from_numpy(W)).sum().backward()
    assert _rel(a.grad, g_j) <= 1e-4


def test_matches_pallas_kernel_in_interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    A = _spd(np.random.default_rng(2), 14, 50)
    with pltpu.force_tpu_interpret_mode():
        L_pallas = np.asarray(pc.cholesky(jnp.asarray(A)))
    assert _rel(ch.cholesky(torch.from_numpy(A)), L_pallas) <= 1e-4


def test_nan_contract_matches_jax():
    """An indefinite lane is NaN over its whole lower triangle and 0 above,
    as jnp.linalg.cholesky gives; the other lanes stay finite."""
    A = _spd(np.random.default_rng(3), 3, 50)
    A[1] -= 3.0 * np.eye(50, dtype=np.float32)
    L = ch.cholesky(torch.from_numpy(A)).numpy()
    L_j = np.asarray(jnp.linalg.cholesky(A))
    lower = np.tril(np.ones((50, 50), bool))
    assert np.isnan(L[1][lower]).all() and np.isnan(L_j[1][lower]).all()
    assert (L[1][~lower] == 0).all()
    assert np.isfinite(L[[0, 2]]).all()
    assert _rel(L[[0, 2]], L_j[[0, 2]]) <= 1e-5


def test_zero_pivot_gives_nan_not_inf():
    L = ch.cholesky(torch.zeros(2, 4, 4))
    lower = torch.tril(torch.ones(4, 4, dtype=torch.bool))
    assert torch.isnan(L[:, lower]).all()


def test_symmetrizes_input_like_jax():
    A = _spd(np.random.default_rng(4), 2, 20)
    A_asym = A + np.triu(np.full_like(A, 0.01), 1)  # only the upper triangle moves
    L = ch.cholesky(torch.from_numpy(A_asym))
    assert _rel(L, jnp.linalg.cholesky(A_asym)) <= 1e-5


def test_cpu_tensor_takes_plain_version_and_no_launch():
    ch.launches = 0
    ch.plain_calls = 0
    ch.cholesky(torch.from_numpy(_spd(np.random.default_rng(5), 2, 8)))
    assert ch.launches == 0
    assert ch.plain_calls == 1
    with pytest.raises(ValueError):
        ch.cholesky_kernel(torch.eye(4))  # the kernel refuses a CPU tensor

