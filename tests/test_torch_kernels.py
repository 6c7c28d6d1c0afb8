"""PyTorch port: covariance functions and the differentiable cross-Gram,
held against the JAX package on the same numpy inputs.

Tolerances: rel 1e-5 on values and 1e-4 on gradients. Both sides compute in
float32 through the expansion |x|^2 + |z|^2 - 2 x.z, whose cancellation and
different summation orders leave errors of a few ulp that the gradient's
sums over m*N pairs grow by about an order of magnitude.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from spatial_alignment_tpu.ops import kernels as jk
from spatial_alignment_tpu.ops.pallas_gram import gram as jgram
from spatial_alignment_tpu_torch.ops import kernels as tk
from spatial_alignment_tpu_torch.ops.gram import gram as tgram

# The suite runs in several worker processes on shared cores; PyTorch's
# default of one intra-op thread per core in each of them oversubscribes
# the machine and slows these tiny problems by orders of magnitude.
torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


@pytest.mark.parametrize("kind", ["rbf", "matern12", "matern32"])
@pytest.mark.parametrize("batched", [False, True], ids=["x2_2d", "x2_S_batched"])
def test_gram_values_and_grads_match_jax(kind, batched):
    rng = np.random.default_rng(1)
    x1 = rng.uniform(0, 5, (9, 2)).astype(np.float32)
    x2 = rng.uniform(0, 5, ((3, 13, 2) if batched else (13, 2))).astype(np.float32)
    log_ls = np.array([0.4], np.float32)
    log_var = np.array([-0.2], np.float32)
    g = rng.standard_normal((3, 9, 13) if batched else (9, 13)).astype(np.float32)

    jf = lambda a, b, l, v: jnp.sum(jgram(a, b, l, v, kind) * g)
    K_j = jgram(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(log_ls), jnp.asarray(log_var), kind)
    grads_j = jax.grad(jf, argnums=(0, 1, 2, 3))(x1, x2, log_ls, log_var)

    ins = [_t(a, grad=True) for a in (x1, x2, log_ls, log_var)]
    K_t = tgram(*ins, kind)
    (K_t * _t(g)).sum().backward()

    assert _rel(K_t.detach(), K_j) <= 1e-5
    for inp, gj in zip(ins, grads_j):
        assert inp.grad.shape == inp.shape
        assert _rel(inp.grad, gj) <= 1e-4, (kind, _rel(inp.grad, gj))


@pytest.mark.parametrize("kind", ["rbf", "matern32"])
def test_gram_per_view_params_match_vmapped_jax(kind):
    """The warp layer's explicit view dim: x1 (V, m, D), x2 (V, N, D) and one
    lengthscale / variance per view, against jax.vmap over the views."""
    rng = np.random.default_rng(2)
    x1 = rng.uniform(0, 5, (2, 7, 2)).astype(np.float32)
    x2 = rng.uniform(0, 5, (2, 11, 2)).astype(np.float32)
    ls = np.array([0.3, 0.9], np.float32)
    var = np.array([0.1, -0.4], np.float32)
    g = rng.standard_normal((2, 7, 11)).astype(np.float32)

    def jf(a, b, l, v):
        K = jax.vmap(lambda a_, b_, l_, v_: jgram(a_, b_, l_, v_, kind))(a, b, l, v)
        return jnp.sum(K * g), K

    (_, K_j), grads_j = jax.value_and_grad(jf, argnums=(0, 1, 2, 3), has_aux=True)(x1, x2, ls, var)
    ins = [_t(a, grad=True) for a in (x1, x2, ls, var)]
    K_t = tgram(*ins, kind)
    (K_t * _t(g)).sum().backward()
    assert _rel(K_t.detach(), K_j) <= 1e-5
    for inp, gj in zip(ins, grads_j):
        assert _rel(inp.grad, gj) <= 1e-4


@pytest.mark.parametrize("name", ["rbf", "matern12", "matern32"])
@pytest.mark.parametrize("diag", [False, True])
def test_kernel_functions_match_jax(name, diag):
    rng = np.random.default_rng(3)
    x1 = rng.uniform(0, 5, (6, 2)).astype(np.float32)
    x2 = rng.uniform(0, 5, (6, 2)).astype(np.float32)
    want = jk.get_kernel(name)(jnp.asarray(x1), jnp.asarray(x2), 0.3, -0.5, diag=diag)
    got = tk.get_kernel(name)(_t(x1), _t(x2), 0.3, -0.5, diag=diag)
    assert got.shape == tuple(want.shape)
    assert _rel(got, want) <= 1e-5


def test_pairwise_sqdist_and_numpy_twin():
    rng = np.random.default_rng(4)
    x1 = rng.standard_normal((3, 7, 2)).astype(np.float32)
    x2 = rng.standard_normal((3, 5, 2)).astype(np.float32)
    got = tk.pairwise_sqdist(_t(x1), _t(x2))
    assert _rel(got, jk.pairwise_sqdist(jnp.asarray(x1), jnp.asarray(x2))) <= 1e-5
    params = np.array([np.log(0.5), np.log(2.0)])
    np.testing.assert_array_equal(
        tk.rbf_kernel_numpy(x1[0], x2[0], params), jk.rbf_kernel_numpy(x1[0], x2[0], params)
    )


def test_kernel_names_resolve_and_validate():
    for name in ("rbf", "matern12", "matern32"):
        assert tk.kernel_name(name) == name
        assert tk.kernel_name(tk.get_kernel(name)) == name
    with pytest.raises(ValueError):
        tk.get_kernel("bogus")
    with pytest.raises(ValueError):
        tk.kernel_name(lambda *a: a)
