"""PyTorch port, the slice as a whole: a model built with the three kernel
opt-ins (``cholesky_impl="pallas"``, ``quad_diag_impl="pallas"``,
``fused_factor_inverse="fused"``) against the JAX package.

The JAX side runs with its default knobs. With the opt-ins it cannot run
on the CPU: its Pallas trisolve and factor kernels sit inside
``custom_partitioning``, and in interpret mode they carry an ordered
effect that ``jit`` cannot lower (``KeyError: OrderedIOEffect``), while its
quad-diag gate never takes the kernel off the TPU. The opt-ins change the
route, not the function: ``tests/test_pallas_*.py`` hold each Pallas kernel
against the jnp form the default knobs run, and ``test_torch_trisolve``,
``test_torch_quad`` and ``test_torch_factor`` hold the port's plain
versions against the same kernels in interpret mode.

Inputs: m = 48 inducing points, two views of 64 points (k-means needs at
least m points per view), lengthscales of 0.7 so the Grams stay well
conditioned at this m (the data Gram's cond is about 14; at 2.0 it is
about 2e5 and the two packages part at 1e-3 on the loss), and the JAX
package's own Monte-Carlo draws.

Tolerances: against JAX, loss rel 1e-5 and gradients rel 2e-3 per leaf:
at m = 48 the port's default route already parts from JAX by up to 8.6e-4
on the Omega_sqt leaves, float32 sums through the Cholesky backward of
48 x 48 products in another order. Against the port's own default route,
the same function on another route, rel 1e-6 on the loss and 1e-4 on
gradients: the fused factor's backward adds the inverse's pullback into
the factor's before one Murray pass, where the default route runs
autograd through each (measured 1.9e-5 on the Omega_sqt_F leaf).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spatial_alignment_tpu as sat
import spatial_alignment_tpu_torch as tp
from spatial_alignment_tpu_torch.models import core as tcore
from spatial_alignment_tpu_torch.models.convert import params_from_numpy
from spatial_alignment_tpu_torch.models.spec import build_spec
from spatial_alignment_tpu_torch.ops import factor, quad, trisolve

from conftest import make_two_view_data
from test_torch_model import _jit_value_and_grad, _rel, jax_noise, leaf

# The suite runs in several worker processes on shared cores; PyTorch's
# default of one intra-op thread per core in each of them oversubscribes
# the machine and slows these tiny problems by orders of magnitude.
torch.set_num_threads(1)

OPT_INS = dict(cholesky_impl="pallas", quad_diag_impl="pallas", fused_factor_inverse="fused")
_KW = dict(m_X_per_view=48, m_G=48, n_latent_gps={"expression": 2}, fixed_view_idx=0)


def _pair(dd, mode):
    """(JAX model with default knobs, port models with the opt-ins and with
    the default knobs) sharing the JAX model's parameters, lengthscales
    set to 0.7."""
    jm = sat.VariationalGPSA(dd, svgp_solve_mode=mode, **_KW)
    jm.params = dict(jm.params)
    for name in ("warp_kernel_lengthscales", "data_kernel_lengthscale"):
        jm.params[name] = jnp.full_like(jm.params[name], math.log(0.7))
    ports = []
    for extra in (OPT_INS, {}):
        tm = tp.VariationalGPSA(dd, device="cpu", svgp_solve_mode=mode, **_KW, **extra)
        params, consts = params_from_numpy(
            jax.tree.map(np.asarray, jm.params), jax.tree.map(np.asarray, jm.consts), "cpu"
        )
        tm._set_state(params, consts, tm._batch, 0)
        ports.append(tm)
    return jm, ports


def test_check_supported_accepts_the_opt_ins():
    """The port refuses no spec option (the last refusal went with
    merged_factor_dispatch=False's port): the opt-in spec factors."""
    dd = make_two_view_data(n_per_view=12, n_outputs=2)
    spec = build_spec(dd, m_X_per_view=4, m_G=4, **OPT_INS)
    model = tp.VariationalGPSA(dd, m_X_per_view=4, m_G=4, device="cpu", **OPT_INS)
    fp = tcore.compute_factors(spec, {**model.consts, **model.params})
    assert all(torch.isfinite(t).all() for t in (fp.warp_Kuu_chol, fp.data_Kuu_chol))
    assert (spec.cholesky_impl, spec.quad_diag_impl, spec.fused_factor_inverse) == (
        "pallas", "pallas", "fused"
    )


@pytest.mark.parametrize("mode", ["mixed", "kl_inverse"])
def test_negative_elbo_and_grads_match_jax(mode):
    dd = make_two_view_data(n_per_view=64, n_outputs=3)
    jm, (tm, tm_default) = _pair(dd, mode)
    S, key = 2, jax.random.PRNGKey(7)
    loss_j, grads_j = _jit_value_and_grad(jm.spec, jm.params, jm.consts, jm._batch, key, S, 1.0)
    warp, data = jax_noise(jm.spec, key, S)
    losses = []
    for model in (tm, tm_default):
        trisolve.plain_calls = quad.plain_calls = factor.plain_calls = 0
        loss = tcore.negative_elbo(
            model.spec, model.params, model.consts, model._batch, S, 1.0,
            warp_noise=warp, data_noise=data,
        )
        loss.backward()
        losses.append(loss.detach())
        counts = (trisolve.plain_calls, quad.plain_calls, factor.plain_calls)
        if model is tm:
            # One loss and gradient, each kernel's count as the card's
            # launches: 4 substitutions forward (two cholesky_solves) and 4
            # backward, the quad-diag forward and backward in each layer,
            # one fused factor slab.
            assert counts == (8, 4, 1)
        else:
            assert counts == (0, 0, 0)
    assert _rel(losses[0], loss_j) <= 1e-5
    assert _rel(losses[0], losses[1]) <= 1e-6
    for path, g in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        got = leaf(tm.params, path).grad
        assert _rel(got, g) <= 2e-3, (jax.tree_util.keystr(path), _rel(got, g))
        assert _rel(got, leaf(tm_default.params, path).grad) <= 1e-4


def test_fit_and_predict_follow_the_default_route():
    """Five Adam steps and the read-out with the opt-ins give what the
    default route gives from the same seed: same function, other route.
    Losses rel 1e-5; predictions rel 1e-4, as Adam's normalized steps turn
    1e-6 gradient differences into larger parameter differences."""
    dd = make_two_view_data(n_per_view=24, n_outputs=3)
    kw = dict(m_X_per_view=8, m_G=8, n_latent_gps={"expression": 2}, fixed_view_idx=0,
              device="cpu")
    base = tp.VariationalGPSA(dd, **kw)
    opt = tp.VariationalGPSA(dd, **kw, **OPT_INS)
    l_base = base.fit(n_epochs=5, S=2)
    l_opt = opt.fit(n_epochs=5, S=2)
    assert np.isfinite(l_opt).all()
    assert _rel(l_opt, l_base) <= 1e-5
    X = dd["expression"]["spatial_coords"]
    for got, want in zip(opt.predict({"expression": X}), base.predict({"expression": X})):
        assert np.isfinite(got["expression"]).all()
        assert _rel(got["expression"], want["expression"]) <= 1e-4
