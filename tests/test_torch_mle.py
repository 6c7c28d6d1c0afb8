"""PyTorch port: ``WarpGPMLE`` against the JAX package's on the same data
and parameters, and the JAX package's own three tests of it.

Both packages build the model from the same data and seed; every initial
parameter they share is equal (checked). For the parity tests both get warp
lengthscales of 2 (the reference's 10 over coordinates in [0, 10] makes the
warp Gram near-singular, and there any two float32 Cholesky routes differ
from the float64 loss by about 1e-4: at the reference's setting the port's
initial loss is held against the float64 loss instead, as close as the JAX
package's). The JAX side runs ``_mle_loss`` under ``jit`` on the CPU.

Tolerances: loss rel 1e-5 (float32 sums of N-point solves through two
Cholesky factorizations in another order); gradients rel 2e-3 per leaf
(max-norm, as the variational model's tests); the parameters after 5 Adam
steps rel 1e-4, their losses as ``test_adam_steps_match_optax`` says.
"""

import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from spatial_alignment_tpu.models import mle as jmle
from spatial_alignment_tpu.models import spec as jspec
from spatial_alignment_tpu_torch import WarpGPMLE
from spatial_alignment_tpu_torch.models import mle as tmle
from spatial_alignment_tpu_torch.models.convert import params_into

from conftest import make_two_view_data
from test_torch_model import _rel, leaf

torch.set_num_threads(1)

_FIXED = dict(fixed_warp_kernel_variances=np.ones(2) * 0.01,
              fixed_warp_kernel_lengthscales=np.ones(2) * 10.0)
# Unit warp variances for the multi-step parity tests: at 0.01 the loss is a
# difference of log-determinants about 50 times its size, and float32
# differences of 1e-7 in them reach 1e-5 of the loss.
_WELL = dict(fixed_warp_kernel_variances=np.ones(2), fixed_warp_kernel_lengthscales=np.ones(2) * 2.0)


def _pair(dd, **kw):
    """(JAX model, port model on the CPU), warp lengthscales 2 on both."""
    jm = jmle.WarpGPMLE(dd, **kw)
    tm = WarpGPMLE(dd, device="cpu", **kw)
    tree = "consts" if "fixed_warp_kernel_lengthscales" in kw else "params"
    jtree = dict(getattr(jm, tree))
    jtree["warp_kernel_lengthscales"] = jnp.full((2,), math.log(2.0), jnp.float32)
    setattr(jm, tree, jtree)
    with torch.no_grad():
        getattr(tm, tree)["warp_kernel_lengthscales"].fill_(math.log(2.0))
    return jm, tm


def _jax_value_and_grad(jm):
    return jax.jit(jax.value_and_grad(
        lambda p: jmle._mle_loss(jm.spec, p, jm.consts, jm._batch)))


def _optax_steps(jm, params, n, lr=1e-2):
    """n optax.adam steps from a fresh state with the fixed view's G
    gradient zeroed, as the JAX package's fit() takes them."""
    tx = optax.adam(lr)
    state = tx.init(params)
    fixed = np.asarray(jm.spec.fixed_view_mask)[:, None, None]
    losses, value_and_grad = [], _jax_value_and_grad(jm)
    for _ in range(n):
        loss, grads = value_and_grad(params)
        grads = dict(grads)
        grads["G"] = {m: jnp.where(fixed, 0.0, g) for m, g in grads["G"].items()}
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return params, losses


def _assert_trees_close(torch_tree, jax_tree, tol):
    for path, want in jax.tree_util.tree_flatten_with_path(jax_tree)[0]:
        got = leaf(torch_tree, path)
        got = got.detach() if isinstance(got, torch.Tensor) else got
        assert _rel(got, want) <= tol, (jax.tree_util.keystr(path), _rel(got, want))


def _float64_loss(tm):
    f64 = lambda t: ({k: f64(v) for k, v in t.items()} if isinstance(t, dict)
                     else t.detach().double())
    return tmle.mle_loss(tm.spec, f64(tm.params), f64(tm.consts), f64(tm._batch)).item()


@pytest.mark.parametrize(
    "kw",
    [dict(fixed_view_idx=0, **_FIXED), dict(n_latent_gps={"expression": 2}),
     dict(mean_function="linear", kernel_func_data="matern32", fixed_view_idx=1)],
    ids=["fixed_view", "lmc", "linear_mean_matern"],
)
def test_initial_loss_and_gradients_match_jax(kw):
    dd = make_two_view_data(n_per_view=20, n_outputs=3, seed=1)
    jm, tm = _pair(dd, **kw)
    # The same initial parameters, G at the packed coordinates.
    _assert_trees_close(tm.params, jm.params, 0.0)
    loss_j, grads_j = _jax_value_and_grad(jm)(jm.params)
    loss_t = tm.loss_fn()
    loss_t.backward()
    assert _rel(loss_t.item(), float(loss_j)) <= 1e-5
    grads_t = jax.tree_util.tree_map(lambda t: t.grad, tm.params,
                                     is_leaf=lambda t: isinstance(t, torch.Tensor))
    _assert_trees_close(grads_t, grads_j, 2e-3)


def test_reference_setting_loss_near_float64():
    """At the reference's warp lengthscale of 10 the port's float32 loss
    is as close to the float64 loss as the JAX package's is."""
    dd = make_two_view_data(n_per_view=20, n_outputs=3, seed=1)
    jm = jmle.WarpGPMLE(dd, fixed_view_idx=0, **_FIXED)
    tm = WarpGPMLE(dd, device="cpu", fixed_view_idx=0, **_FIXED)
    exact = _float64_loss(tm)
    err_t = abs(tm.loss_fn().item() - exact) / abs(exact)
    err_j = abs(float(jm.loss_fn()) - exact) / abs(exact)
    assert err_t <= max(2 * err_j, 1e-5), (err_t, err_j)


def test_adam_steps_match_optax():
    """fit(3) then fit(2), each from a fresh Adam state (the cached loop
    reset), against optax.adam over the same steps."""
    dd = make_two_view_data(n_per_view=20, n_outputs=3, seed=2)
    jm, tm = _pair(dd, fixed_view_idx=0, n_latent_gps={"expression": 2},
                   **_WELL)
    params, losses_j = _optax_steps(jm, jm.params, 3)
    params, more = _optax_steps(jm, params, 2)
    exact = _float64_loss(tm)
    losses_t = np.concatenate([tm.fit(n_epochs=3, lr=1e-2, chunk_size=2),
                               tm.fit(n_epochs=2, lr=1e-2)])
    # Here the JAX package's float32 loss is itself 1.1e-5 off the float64
    # loss at the init (the port's 1.4e-6), so the port is held to float64
    # at 1e-5 and to JAX at twice that.
    assert abs(losses_t[0] - exact) <= 1e-5 * abs(exact)
    np.testing.assert_allclose(losses_t, losses_j + more, rtol=2e-5)
    _assert_trees_close(tm.params, params, 1e-4)


def test_g_layout_and_the_fixed_view_stays_put():
    dd = make_two_view_data(n_per_view=12, n_outputs=2, seed=3)
    X = dd["expression"]["spatial_coords"]
    jm, tm = _pair(dd, fixed_view_idx=0, **_FIXED)
    assert tm.G["expression"].shape == jm.G["expression"].shape == (24, 2)
    np.testing.assert_array_equal(tm.G["expression"], jm.G["expression"])
    tm.fit(n_epochs=10, lr=1e-2)
    G = tm.G["expression"]
    np.testing.assert_array_equal(G[:12], X[:12])  # bit for bit
    assert not np.allclose(G[12:], X[12:])
    assert tm.forward(None)["expression"].shape == (24, 2)
    assert tm.train() is tm and tm.eval() is tm and tm.to("cpu") is tm and tm.n_views == 2
    vi, Ns, Ps, n_total = tm.create_view_idx_dict(dd)
    assert n_total == 24 and Ps == {"expression": 2} and len(vi["expression"]) == 2


def test_jax_parameters_carry_across():
    """A JAX WarpGPMLE's params/consts (G included) moved off their init
    and written into a port model give the JAX loss and aligned coords."""
    dd = make_two_view_data(n_per_view=15, n_outputs=3, seed=4)
    jm, tm = _pair(dd, fixed_view_idx=0, n_latent_gps={"expression": 2},
                   **_WELL)
    rng = np.random.default_rng(4)
    params = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), jm.params)
    params_into(tm, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, jm.consts))
    want_G = jspec.unpack_points(jm.spec, "expression", np.asarray(params["G"]["expression"]))
    np.testing.assert_array_equal(tm.G["expression"], want_G)
    want = float(_jax_value_and_grad(jm)(params)[0])
    assert _rel(tm.loss_fn().item(), want) <= 1e-5
    with pytest.raises(ValueError, match="does not match"):
        params_into(tm, {"G": {}}, {})


@pytest.mark.parametrize("shape", [(2, 5), (5, 2), (3, 3)])
def test_pinv_through_the_gram_equals_the_svd_one(shape):
    """The LMC projection's pseudo-inverse (through the Cholesky factor of
    W's smaller Gram, so a captured step can run it) against
    ``torch.linalg.pinv``'s SVD one, for a full-rank W: float64, 1e-12."""
    W = torch.from_numpy(np.random.default_rng(6).standard_normal(shape))
    assert _rel(tmle._pinv(W), torch.linalg.pinv(W)) <= 1e-12


def _conditioned_w(cond):
    """A float32 W (2, 3) with singular values 1 and 1 / cond."""
    rng = np.random.default_rng(7)
    U = np.linalg.qr(rng.standard_normal((2, 2)))[0]
    V = np.linalg.qr(rng.standard_normal((3, 2)))[0]
    return (U @ np.diag([1.0, 1.0 / cond]) @ V.T).astype(np.float32)


@pytest.mark.parametrize("cond", [30.0, 300.0])
def test_pinv_of_an_ill_conditioned_w_against_jax(cond):
    """A float32 W of condition number ``cond``: the port's pseudo-inverse
    within 4 cond² 2⁻²⁴ of float64's (its Gram squares cond(W)), JAX's SVD one
    within 4 cond 2⁻²⁴; the LMC model's loss with that W against the JAX
    package's within 1e-5 plus the port's pinv bound."""
    W = _conditioned_w(cond)
    exact = np.linalg.pinv(W.astype(np.float64))
    u = 2.0**-24
    got = tmle._pinv(torch.from_numpy(W))
    assert _rel(got, exact) <= 4 * cond**2 * u
    assert _rel(np.asarray(jnp.linalg.pinv(jnp.asarray(W))), exact) <= 4 * cond * u
    dd = make_two_view_data(n_per_view=20, n_outputs=3, seed=1)
    jm, tm = _pair(dd, n_latent_gps={"expression": 2})
    jm.params = {**jm.params, "W": {"expression": jnp.asarray(W)}}
    with torch.no_grad():
        tm.params["W"]["expression"].copy_(torch.from_numpy(W))
    loss_j = float(_jax_value_and_grad(jm)(jm.params)[0])
    assert _rel(tm.loss_fn().item(), loss_j) <= 1e-5 + 4 * cond**2 * u


def test_rank_deficient_w_is_refused():
    """A W of rank 1 (and one past the cutoff JAX's pinv applies): the
    eager loss raises, where the SVD's pseudo-inverse would drop the null
    direction."""
    dd = make_two_view_data(n_per_view=20, n_outputs=3, seed=1)
    tm = WarpGPMLE(dd, device="cpu", n_latent_gps={"expression": 2})
    for W in (np.array([[1.0, 2.0, 0.5], [2.0, 4.0, 1.0]], np.float32), _conditioned_w(3e4)):
        with torch.no_grad():
            tm.params["W"]["expression"].copy_(torch.from_numpy(W))
        with pytest.raises(torch.linalg.LinAlgError, match="rank-deficient"):
            tm.loss_fn()


# The JAX package's tests of WarpGPMLE (tests/test_mle.py), on the port.


def test_mle_loss_and_fit(two_view_data):
    model = WarpGPMLE(two_view_data, fixed_view_idx=0, device="cpu", **_FIXED)
    l0 = float(model.loss_fn(data_dict=two_view_data))
    assert np.isfinite(l0)
    losses = model.fit(n_epochs=60, lr=1e-2)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_mle_fixed_view_pinned(two_view_data):
    X = two_view_data["expression"]["spatial_coords"]
    model = WarpGPMLE(two_view_data, fixed_view_idx=0, device="cpu", **_FIXED)
    model.fit(n_epochs=30, lr=1e-2)
    G = model.G["expression"]
    np.testing.assert_allclose(G[:30], X[:30], atol=1e-6)
    assert not np.allclose(G[30:], X[30:])


def test_mle_alignment_improves():
    data = make_two_view_data(n_per_view=25, n_outputs=4, warp_sigma=0.4, seed=2)
    X = data["expression"]["spatial_coords"]
    model = WarpGPMLE(data, fixed_warp_kernel_variances=np.ones(2) * 0.1,
                      fixed_warp_kernel_lengthscales=np.ones(2) * 10.0, fixed_view_idx=0,
                      device="cpu")
    pre = np.mean(np.sum((X[:25] - X[25:]) ** 2, axis=1))
    model.fit(n_epochs=300, lr=1e-2)
    G = model.G["expression"]
    post = np.mean(np.sum((G[:25] - G[25:]) ** 2, axis=1))
    assert post < pre
