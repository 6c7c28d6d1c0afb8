"""PyTorch port: the triangular and whitened variational parameterizations,
imputation at chosen coordinates (``forward(G_test=)``), and the options
that run through ported code, against the JAX package on the same numpy
inputs and the JAX package's own Monte-Carlo draws.

Against JAX: ``init_params`` in both modes bit for bit; ``negative_elbo``
and its gradients in both modes and all four solve modes (loss rel 1e-5,
gradients rel 2e-3 per leaf: the triangular factor enters the KL's log
determinant directly, and float32 sums through the solves of 8 x 8
products in another order part the leaves by up to 1e-3, as at m = 48 in
test_torch_optin.py); ``impute_at`` and ``forward(G_test=)`` (rel 1e-5, as
test_torch_model.py holds predictions); checkpoints across the packages;
``reference_sample_scale``, the other mean functions, the Matern kernels
inside the model and two modalities (loss rel 1e-5, gradients rel 2e-3).
Ports of the JAX package's own tests of the two modes
(tests/test_model_core.py) keep its tolerances; its pairwise option matrix
(tests/test_feature_matrix.py, tests/test_solve_mode.py) runs at the same
tiny size. The kernel opt-ins count their plain versions on the CPU, one
count per launch the card would make.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import spatial_alignment_tpu as sat
from spatial_alignment_tpu.models import core as jcore
from spatial_alignment_tpu.models import params as jparams
from spatial_alignment_tpu.models import spec as jspec
import spatial_alignment_tpu_torch as tp
from spatial_alignment_tpu_torch import ops
from spatial_alignment_tpu_torch.models import core as tcore
from spatial_alignment_tpu_torch.models import params as tparams
from spatial_alignment_tpu_torch.models import spec as tspec
from spatial_alignment_tpu_torch.models._trees import leaves, named_leaves, tree_map
from spatial_alignment_tpu_torch.ops import linalg as tlinalg
from spatial_alignment_tpu_torch.ops.kernels import get_kernel

from conftest import make_two_view_data
from test_torch_model import _jit_value_and_grad, _np_tree, _rel, jax_noise, leaf, model_pair

# The suite runs in several worker processes on shared cores; PyTorch's
# default of one intra-op thread per core in each of them oversubscribes
# the machine and slows these tiny problems by orders of magnitude.
torch.set_num_threads(1)

MODES = {"triangular": {"triangular_variational": True},
         "whitened": {"whitened_variational": True}}
OPT_INS = dict(cholesky_impl="pallas", quad_diag_impl="pallas", fused_factor_inverse="fused")
KW = dict(m_X_per_view=8, m_G=8, n_latent_gps={"expression": 2}, fixed_view_idx=0)

_jit_forward = jax.jit(jcore.forward, static_argnums=(0, 4))
_jit_impute = jax.jit(jcore.impute_at, static_argnums=(0, 5))


def _plain_counts():
    return {k.split(".")[0]: v for k, v in ops.read_counters().items()
            if k.endswith("plain_calls") and v}


def _check_grads(grads_j, params_t, tol=2e-3):
    for path, g in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        got = leaf(params_t, path).grad
        assert _rel(got, g) <= tol, (jax.tree_util.keystr(path), _rel(got, g))


def pair(dd, **kw):
    """model_pair, with a whitened model's state moved off its init in both
    packages: there q equals the prior, the warp layer's output does not
    depend on the inducing points, and their gradients are float noise."""
    jm, tm = model_pair(dd, **kw)
    if jm.spec.whitened_variational:
        rng = np.random.default_rng(2)
        moved = {}
        for name in ("delta_G", "Omega_sqt_G"):
            shape = jm.params[name].shape
            moved[name] = (np.tril(np.eye(shape[-1]) + 0.2 * rng.standard_normal(shape))
                           if name.startswith("Omega") else 0.3 * rng.standard_normal(shape))
        for name in ("delta_F", "Omega_sqt_F"):
            moved[name] = {}
            for mod, v in jm.params[name].items():
                moved[name][mod] = (np.tril(np.eye(v.shape[-1]) + 0.2 * rng.standard_normal(v.shape))
                                    if name.startswith("Omega") else rng.standard_normal(v.shape))
        moved = jax.tree.map(lambda a: np.asarray(a, np.float32), moved)
        jm.params = {**jm.params, **jax.tree.map(jnp.asarray, moved)}
        with torch.no_grad():
            for name, v in moved.items():
                if isinstance(v, dict):
                    for mod, a in v.items():
                        tm.params[name][mod].copy_(torch.from_numpy(a))
                else:
                    tm.params[name].copy_(torch.from_numpy(v))
    return jm, tm


def _test_noise(spec, key, S, n_test):
    """The normals JAX's impute_at draws for ``key``."""
    keys = jax.random.split(key, spec.n_modalities)
    return {mod.name: torch.tensor(np.asarray(jax.random.normal(kk, (S, n_test, mod.n_latent))))
            for kk, mod in zip(keys, spec.modalities)}


# ---------------------------------------------------------------------------
# init, loss and gradients against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
def test_init_params_bit_identical_in_both_modes(mode):
    """Triangular mode's chol(a a^T + jitter I) taken in float64 on the
    host, whitened mode's identity factors and zero warp mean: every leaf
    equal to the JAX package's bit for bit."""
    dd = make_two_view_data(n_per_view=20)
    spec_j = jspec.build_spec(dd, **KW, **MODES[mode])
    spec_t = tspec.build_spec(dd, **KW, **MODES[mode])
    pj, cj, _ = jparams.init_params(spec_j, dd, data_init=False, seed=3)
    pt, ct, _ = tparams.init_params(spec_t, dd, data_init=False, seed=3, device="cpu")
    flat_j = dict(jax.tree_util.tree_flatten_with_path((pj, cj))[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path((_np_tree(pt), _np_tree(ct)))[0])
    assert flat_j.keys() == flat_t.keys()
    for path, want in flat_j.items():
        assert flat_t[path].dtype == np.float32
        np.testing.assert_array_equal(flat_t[path], np.asarray(want))
    om = pt["Omega_sqt_G"].numpy()
    np.testing.assert_array_equal(om, np.tril(om))


_SOLVE_MODES = ["solve", "kl_inverse", "inverse", "mixed"]


@pytest.mark.parametrize("solve_mode", _SOLVE_MODES)
@pytest.mark.parametrize("mode", sorted(MODES))
def test_negative_elbo_and_grads_match_jax(mode, solve_mode):
    """Half the cases with a template view and the LMC, half de novo."""
    dd = make_two_view_data(n_per_view=24)
    template = solve_mode in ("solve", "inverse")
    kw = dict(KW, fixed_view_idx=0 if template else None,
              n_latent_gps={"expression": 2 if template else None})
    jm, tm = pair(dd, svgp_solve_mode=solve_mode, **kw, **MODES[mode])
    S, key = 2, jax.random.PRNGKey(7)
    loss_j, grads_j = _jit_value_and_grad(jm.spec, jm.params, jm.consts, jm._batch, key, S, 1.0)
    warp, data = jax_noise(jm.spec, key, S)
    loss_t = tcore.negative_elbo(tm.spec, tm.params, tm.consts, tm._batch, S, 1.0,
                                 warp_noise=warp, data_noise=data)
    loss_t.backward()
    assert _rel(loss_t.detach(), loss_j) <= 1e-5
    _check_grads(grads_j, tm.params)


@pytest.mark.parametrize(
    "mode,solve_mode,layout",
    [("triangular", "kl_inverse", "2d"), ("whitened", "mixed", "reference")],
    ids=["triangular-kl_inverse-2d", "whitened-mixed-reference"],
)
def test_impute_at_and_forward_G_test_match_jax(mode, solve_mode, layout):
    """forward(G_test=) and impute_at on the forward's data factors, with
    JAX's draws, at 7 test points in (n, D) or the reference's (1, n, D)
    layout; the model-level forward returns JAX's six-tuple: the four
    reference-layout dicts, then (S, n, L) latent and (S, n, P) observed
    samples at the test points, as numpy arrays."""
    dd = make_two_view_data(n_per_view=24)
    jm, tm = pair(dd, svgp_solve_mode=solve_mode, **KW, **MODES.get(mode, {}))
    G = np.random.default_rng(5).uniform(0, 10, (7, 2)).astype(np.float32)
    G = G[None] if layout == "reference" else G
    S, key, key2 = 3, jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    hp_j, hp_t = {**jm.consts, **jm.params}, {**tm.consts, **tm.params}
    res_j = _jit_forward(jm.spec, hp_j, jm._batch, key, S, {"expression": jnp.asarray(G)})
    warp, data = jax_noise(jm.spec, key, S)
    test_noise = _test_noise(jm.spec, jax.random.split(key, 3)[2], S, 7)
    G_t = {"expression": torch.from_numpy(G)}
    with torch.no_grad():
        res_t = tcore.forward(tm.spec, hp_t, tm._batch, S, warp_noise=warp, data_noise=data,
                              G_test=G_t, test_noise=test_noise)
        imp_t = tcore.impute_at(tm.spec, hp_t, res_t.data_aux, G_t, S,
                                noise=_test_noise(jm.spec, key2, S, 7))
    imp_j = _jit_impute(jm.spec, hp_j, res_j.data_aux, {"expression": jnp.asarray(G)}, key2, S)
    pairs = [(res_t.F_latent_samples_test, res_j.F_latent_samples_test),
             (res_t.F_observed_samples_test, res_j.F_observed_samples_test),
             (imp_t[0], imp_j[0]), (imp_t[1], imp_j[1])]
    for got, want in pairs:
        assert got["expression"].shape == (S, 7, want["expression"].shape[-1])
        assert _rel(got["expression"], want["expression"]) <= 1e-5
    X = {"expression": dd["expression"]["spatial_coords"]}
    out = tm.forward(X, S=S, G_test={"expression": G})
    want = [(48, 2), (S, 48, 2), (S, 48, 2), (S, 48, 3), (S, 7, 2), (S, 7, 3)]
    assert [o["expression"].shape for o in out] == want
    assert all(isinstance(o["expression"], np.ndarray) for o in out)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_checkpoint_cross_load_in_both_modes(tmp_path, mode):
    """A port checkpoint predicts in the JAX package (aligned coordinates and
    mean within rel 1e-5; the variance within 1e-4, for kff - aKa + aOa
    cancels where the inducing points are dense), and a JAX checkpoint
    loads into the port with its flags and leaves."""
    dd = make_two_view_data(n_per_view=12)
    tm = tp.VariationalGPSA(dd, device="cpu", **KW, **MODES[mode])
    with torch.no_grad():  # well-conditioned Grams, as model_pair sets them
        for name in ("warp_kernel_lengthscales", "data_kernel_lengthscale"):
            tm.params[name].fill_(math.log(2.0))
    tm.fit(n_epochs=3, S=2)
    path = str(tmp_path / "port.npz")
    tm.save(path)
    jm = sat.VariationalGPSA.load(path)
    assert jspec.spec_to_dict(jm.spec) == tspec.spec_to_dict(tm.spec)
    X = {"expression": dd["expression"]["spatial_coords"]}
    for got, want, tol in zip(tm.predict(X), jm.predict(X), (1e-5, 1e-5, 1e-4)):
        assert _rel(got["expression"], want["expression"]) <= tol
    jm2 = sat.VariationalGPSA(dd, **KW, **MODES[mode])
    path2 = str(tmp_path / "jax.npz")
    jm2.save(path2)
    tm2 = tp.VariationalGPSA.load(path2, device="cpu")
    assert tspec.spec_to_dict(tm2.spec) == jspec.spec_to_dict(jm2.spec)
    for p, want in jax.tree_util.tree_flatten_with_path(jm2.params)[0]:
        np.testing.assert_array_equal(leaf(tm2.params, p).detach().numpy(), np.asarray(want))
    assert np.isfinite(tm2.neg_elbo(S=2))


def _two_modalities():
    dd = make_two_view_data(n_per_view=20)
    other = make_two_view_data(n_per_view=15, n_outputs=2, seed=1)["expression"]
    dd["protein"] = other
    return dd


@pytest.mark.parametrize(
    "data,kw",
    [("two_view", dict(reference_sample_scale=True, mean_function="identity_initialized")),
     ("two_view", dict(mean_function="linear", kernel_func_warp="matern32",
                       kernel_func_data="matern32")),
     ("two_view", dict(kernel_func_warp="matern12", kernel_func_data="matern12",
                       triangular_variational=True)),
     ("two_modalities", dict(n_latent_gps={"expression": 2, "protein": None},
                             whitened_variational=True))],
    ids=["reference_sample_scale+identity_initialized", "linear_mean+matern32",
         "matern12+triangular", "two_modalities+whitened"],
)
def test_options_through_ported_code_match_jax(data, kw):
    """Matern-1/2's distance sqrt(|x - z|^2 + 1e-10) has a slope of 5e4 on
    a Gram's diagonal, where the expansion |x|^2 + |z|^2 - 2 x.z leaves a
    float32 rounding residue; its gradient to the inducing points is that
    residue times 5e4 in both packages (terms of 1e6 that cancel), so under
    matern12 those two leaves are not compared."""
    dd = make_two_view_data(n_per_view=24) if data == "two_view" else _two_modalities()
    jm, tm = pair(dd, **{**KW, **kw})
    S, key = 2, jax.random.PRNGKey(7)
    loss_j, grads_j = _jit_value_and_grad(jm.spec, jm.params, jm.consts, jm._batch, key, S, 1.0)
    warp, data_noise = jax_noise(jm.spec, key, S)
    loss_t = tcore.negative_elbo(tm.spec, tm.params, tm.consts, tm._batch, S, 1.0,
                                 warp_noise=warp, data_noise=data_noise)
    loss_t.backward()
    assert _rel(loss_t.detach(), loss_j) <= 1e-5
    if kw.get("kernel_func_data") == "matern12":
        grads_j = {k: v for k, v in grads_j.items() if k not in ("Xtilde", "Gtilde")}
    _check_grads(grads_j, tm.params)


# ---------------------------------------------------------------------------
# The JAX package's own tests of the two modes (tests/test_model_core.py)
# ---------------------------------------------------------------------------


def _tiny(dd, **kw):
    kw = {"m_X_per_view": 8, "m_G": 8, "n_latent_gps": {"expression": None}, "seed": 0, **kw}
    return tp.VariationalGPSA(dd, device="cpu", **kw)


def test_triangular_variational_same_initial_elbo():
    """The stored factors differ, the covariances (with the square mode's
    jitter) agree, and so do the initial losses from one generator state."""
    dd = make_two_view_data()
    m_sq, m_tri = _tiny(dd), _tiny(dd, triangular_variational=True)
    sq, tri = m_sq.params["Omega_sqt_G"].detach().numpy(), m_tri.params["Omega_sqt_G"].detach().numpy()
    assert not np.allclose(sq, tri)
    np.testing.assert_allclose(tri, np.tril(tri))
    cov_sq = sq @ np.swapaxes(sq, -1, -2)
    diag_mean = np.maximum(1.0, np.trace(cov_sq, axis1=-2, axis2=-1) / sq.shape[-1])
    cov_sq = cov_sq + 1e-5 * diag_mean[..., None, None] * np.eye(sq.shape[-1])
    np.testing.assert_allclose(tri @ np.swapaxes(tri, -1, -2), cov_sq, rtol=1e-4, atol=1e-6)
    e = [float(tcore.negative_elbo(m.spec, m.params, m.consts, m._batch, 3,
                                   generator=torch.Generator().manual_seed(3)))
         for m in (m_sq, m_tri)]
    np.testing.assert_allclose(e[0], e[1], rtol=1e-4)


def test_triangular_variational_trains():
    m = _tiny(make_two_view_data(), triangular_variational=True)
    losses = m.fit(n_epochs=60, lr=1e-2, S=3)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    d = np.diagonal(m.params["Omega_sqt_G"].detach().numpy(), axis1=-2, axis2=-1)
    assert np.all(np.abs(d) > 0)


def to_whitened(spec, params, consts):
    """Square-mode parameters as the whitened mode's for the same q:
    w = L^-1 (delta - mu_z), A = L^-1 chol(Omega), with L and chol(Omega)
    the port's own float32 factors (the jitter rung the model takes
    included) and the solves in float64."""
    hp = {**consts, **params}
    f64 = lambda t: t.detach().numpy().astype(np.float64)
    eps = spec.diagonal_offset
    kern_w, kern_d = get_kernel(spec.kernel_warp), get_kernel(spec.kernel_data)
    out = tree_map(lambda t: t.detach().clone(), params)
    with torch.no_grad():
        Xt = hp["Xtilde"]
        Lw = f64(torch.stack([tlinalg.jittered_cholesky(
            kern_w(Xt[v], Xt[v], hp["warp_kernel_lengthscales"][v],
                   hp["warp_kernel_variances"][v]), eps) for v in range(spec.n_views)]))
        mu_z = f64(Xt @ hp["mean_slopes"] + hp["mean_intercepts"][:, None])
        C = f64(tlinalg.factor_psd_cholesky(hp["Omega_sqt_G"], eps))
        L_F = f64(tlinalg.jittered_cholesky(kern_d(
            hp["Gtilde"], hp["Gtilde"], hp["data_kernel_lengthscale"],
            hp["data_kernel_variance"]), eps))
        CF = {mod.name: f64(tlinalg.factor_psd_cholesky(hp["Omega_sqt_F"][mod.name], eps))
              for mod in spec.modalities}
    solve = lambda L, b: sla.solve_triangular(L, b, lower=True)
    delta = f64(hp["delta_G"])
    out["delta_G"] = torch.from_numpy(np.stack([
        solve(Lw[v], delta[v] - mu_z[v]) for v in range(spec.n_views)]).astype(np.float32))
    A = np.stack([[solve(Lw[v], C[v, d]) for d in range(spec.n_spatial_dims)]
                  for v in range(spec.n_views)])
    np.testing.assert_allclose(A, np.tril(A), atol=1e-12)  # L^-1 C stays triangular
    out["Omega_sqt_G"] = torch.from_numpy(A.astype(np.float32))
    for mod in spec.modalities:
        out["delta_F"][mod.name] = torch.from_numpy(
            solve(L_F, f64(hp["delta_F"][mod.name])).astype(np.float32))
        out["Omega_sqt_F"][mod.name] = torch.from_numpy(np.stack([
            solve(L_F, c) for c in CF[mod.name]]).astype(np.float32))
    return out


def test_whitened_variational_elbo_equivalence():
    """Square-mode parameters converted to whitened ones give the same
    negative ELBO under one generator state (rel 1e-4, as JAX holds it)."""
    m = _tiny(make_two_view_data())
    pw = to_whitened(m.spec, m.params, m.consts)
    spec_w = m.spec.replace(whitened_variational=True)
    e = [float(tcore.negative_elbo(s, p, m.consts, m._batch, 4,
                                   generator=torch.Generator().manual_seed(7)))
         for s, p in ((m.spec, m.params), (spec_w, pw))]
    np.testing.assert_allclose(e[0], e[1], rtol=1e-4)


def test_whitened_variational_trains_and_aligns():
    dd = make_two_view_data()
    m = _tiny(dd, whitened_variational=True)
    assert np.allclose(m.params["delta_G"].detach().numpy(), 0.0)
    Om = m.params["Omega_sqt_G"].detach().numpy()
    np.testing.assert_allclose(Om, np.broadcast_to(np.eye(Om.shape[-1]), Om.shape))
    losses = m.fit(n_epochs=60, lr=1e-2, S=3)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for a in m.predict({"expression": dd["expression"]["spatial_coords"]}):
        assert np.isfinite(a["expression"]).all()


# ---------------------------------------------------------------------------
# The kernel opt-ins and the restart axis in both modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "mode,solve_mode,want",
    [("triangular", "mixed", {"cholesky": 1, "factor": 1, "trisolve": 8, "quad": 4}),
     ("whitened", "mixed", {"cholesky": 2, "trisolve": 4, "quad": 4}),
     ("whitened", "inverse", {"cholesky": 1, "factor": 1, "quad": 4})],
    ids=["triangular-mixed", "whitened-mixed", "whitened-inverse"],
)
def test_opt_in_route_matches_jax_and_counts_its_kernels(mode, solve_mode, want):
    """The opt-in model against JAX's default knobs (its opt-in kernels
    cannot run under jit on the CPU, test_torch_optin.py) and the port's
    default route, with one plain call per launch the card would make:
    triangular mode factors and inverts the Kuu slab in the fused factor
    and runs the mixed mode's eight substitutions; whitened mode runs one
    width-N solve a layer (and its transposed solve in the backward) and
    no inverse."""
    dd = make_two_view_data(n_per_view=24)
    template = solve_mode in ("solve", "inverse")
    kw = dict(KW, fixed_view_idx=0 if template else None,
              n_latent_gps={"expression": 2 if template else None},
              svgp_solve_mode=solve_mode, **MODES[mode])
    jm, tm_default = pair(dd, **kw)
    tm = tp.VariationalGPSA(dd, device="cpu", **kw, **OPT_INS)
    copy = lambda t: t.detach().clone().requires_grad_(True)
    tm._set_state(tree_map(copy, tm_default.params), tm_default.consts, tm._batch, 0)
    S, key = 2, jax.random.PRNGKey(7)
    loss_j, grads_j = _jit_value_and_grad(jm.spec, jm.params, jm.consts, jm._batch, key, S, 1.0)
    warp, data = jax_noise(jm.spec, key, S)
    losses = []
    for model in (tm, tm_default):
        ops.set_counters(dict.fromkeys(ops.read_counters(), 0))
        loss = tcore.negative_elbo(model.spec, model.params, model.consts, model._batch, S, 1.0,
                                   warp_noise=warp, data_noise=data)
        loss.backward()
        losses.append(loss.detach())
        counts = _plain_counts()
        assert counts == (want if model is tm else {"cholesky": want["cholesky"] + (
            1 if "factor" in want else 0)})
    assert _rel(losses[0], loss_j) <= 1e-5 and _rel(losses[0], losses[1]) <= 1e-6
    _check_grads(grads_j, tm.params)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_restart_step_calls_each_kernel_once(mode):
    """One R-wide loss and gradient with the opt-ins calls each kernel's
    plain version as often as one restart's does (torch.tril and the
    whitened solve under the restart vmap included), and restart r's loss
    and gradients are restart r's alone from the same draws."""
    dd = make_two_view_data(n_per_view=20)
    m = tp.VariationalGPSA(dd, device="cpu", svgp_solve_mode="mixed", **KW, **MODES[mode],
                           **OPT_INS)
    R, S = 3, 2
    params = m._restart_inits(R, 0)
    gen = torch.Generator().manual_seed(0)
    for name, t in named_leaves(params):  # off the whitened init, where q is the prior
        if "delta" in name or "Omega" in name:
            t.add_(0.2 * torch.randn(t.shape, generator=gen))
            if "Omega" in name:
                t.copy_(torch.tril(t))
    params = tree_map(lambda v: v.requires_grad_(True), params)
    wn, dn, _ = tcore.draw_restart_noise(m.spec, R, S, gen, m.device)
    m._draw_restart_noise = lambda R_, S_: (wn, dn, None)
    ops.set_counters(dict.fromkeys(ops.read_counters(), 0))
    losses = m._restart_step_loss(S, None, R, params)(1.0)
    losses.sum().backward()
    wide = _plain_counts()
    for r in range(R):
        ops.set_counters(dict.fromkeys(ops.read_counters(), 0))
        alone = tree_map(lambda v: v.detach()[r].clone().requires_grad_(True), params)
        loss = tcore.negative_elbo(m.spec, alone, m.consts, m._batch, S, 1.0, warp_noise=wn[r],
                                   data_noise={k: v[r] for k, v in dn.items()})
        loss.backward()
        assert _plain_counts() == wide and wide.get("trisolve")
        assert _rel(losses[r].detach(), loss.detach()) <= 1e-5
        for a, b in zip(leaves(params), leaves(alone)):
            assert _rel(a.grad[r], b.grad) <= 1e-3


# ---------------------------------------------------------------------------
# The pairwise option matrix (tests/test_feature_matrix.py,
# tests/test_solve_mode.py) for the two flags
# ---------------------------------------------------------------------------

COMBOS = [
    ({"triangular_variational": True}, {"minibatch_size": 8}),
    ({"whitened_variational": True}, {"minibatch_size": 8}),
    ({"triangular_variational": True, "analytic_data_likelihood": True}, {}),
    ({"whitened_variational": True, "fixed_view_idx": 0}, {}),
    ({"triangular_variational": True, "fixed_view_idx": 0}, {"recipe": "accurate"}),
    ({"whitened_variational": True, "data_chunk_size": 16}, {"minibatch_size": 8}),
]


@pytest.mark.parametrize(
    "ctor_kw,fit_kw", COMBOS,
    ids=["+".join([k for k in c] + [f"fit:{k}" for k in f]) for c, f in COMBOS],
)
def test_feature_combo_trains_predicts_roundtrips(tmp_path, ctor_kw, fit_kw):
    dd = make_two_view_data()
    kw = {"m_X_per_view": 6, "m_G": 6, "n_latent_gps": {"expression": None}, "seed": 0,
          **ctor_kw}
    model = tp.VariationalGPSA(dd, device="cpu", **kw)
    losses = model.fit(n_epochs=30, lr=1e-2, S=2, **fit_kw)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    X = {"expression": dd["expression"]["spatial_coords"]}
    G, F, Fv = model.predict(X)
    assert np.isfinite(G["expression"]).all() and np.isfinite(F["expression"]).all()
    assert (Fv["expression"] > 0).all()
    path = str(tmp_path / "combo.npz")
    model.save(path)
    model2 = tp.VariationalGPSA.load(path, device="cpu")
    assert model2.spec == model.spec
    for got, want in zip(model2.predict(X)[:2], (G, F)):
        np.testing.assert_allclose(got["expression"], want["expression"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_negative_elbo_parity_between_solve_modes(mode):
    """One function in four solve modes: losses rel 1e-4 and the gradient's
    global norm rel 2e-3, as the JAX package holds its own."""
    dd = make_two_view_data(n_per_view=30, n_outputs=4)
    vals, grads = {}, {}
    for solve_mode in _SOLVE_MODES:
        m = tp.VariationalGPSA(dd, m_X_per_view=8, m_G=8, n_latent_gps={"expression": 3},
                               seed=0, svgp_solve_mode=solve_mode, device="cpu", **MODES[mode])
        loss = tcore.negative_elbo(m.spec, m.params, m.consts, m._batch, 4,
                                   generator=torch.Generator().manual_seed(7))
        loss.backward()
        vals[solve_mode] = float(loss)
        grads[solve_mode] = torch.cat([p.grad.flatten() for p in m.parameters()])
    for other in _SOLVE_MODES[1:]:
        np.testing.assert_allclose(vals["solve"], vals[other], rtol=1e-4)
        diff = torch.linalg.norm(grads["solve"] - grads[other]) / torch.linalg.norm(grads["solve"])
        assert float(diff) < 2e-3, (other, float(diff))
