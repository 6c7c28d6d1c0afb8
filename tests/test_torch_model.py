"""PyTorch port: spec, init, loss and gradients, forward/predict and weight
conversion, against the JAX package on the same data, parameters and noise.

The port cannot reproduce ``jax.random``, so the tests draw the JAX
package's own Monte-Carlo normals from the same keys and splits as
``core.forward`` (split(key, 3): k_warp, k_data; normal(k_warp, (S, V, Ntot,
D)); split(k_data, n_mod); normal(kk, (S, V*Np, L))) and pass them to the
port. Both sides get moderate kernel lengthscales, so every Gram is well
conditioned and float32 parity means something: with the init's saturated
warp Grams (cond ~1e6) any two f32 Cholesky implementations differ at 1e-3.

Tolerances: loss rel 1e-5; gradients rel 1e-4 per parameter leaf
(max-norm), the float32 sums over all points and samples through solves
and Cholesky backward; predictions rel 1e-5.
"""

import json
import math

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import spatial_alignment_tpu as sat
from spatial_alignment_tpu.models import core as jcore
from spatial_alignment_tpu.models import params as jparams
from spatial_alignment_tpu.models import spec as jspec
import spatial_alignment_tpu_torch as tp
from spatial_alignment_tpu_torch.models import core as tcore
from spatial_alignment_tpu_torch.models import params as tparams
from spatial_alignment_tpu_torch.models import spec as tspec
from spatial_alignment_tpu_torch.models.convert import load_jax_checkpoint, params_from_numpy

from conftest import make_two_view_data

# The suite runs in several worker processes on shared cores; PyTorch's
# default of one intra-op thread per core in each of them oversubscribes
# the machine and slows these tiny problems by orders of magnitude.
torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def model_pair(dd, **kw):
    """(JAX model, port model on the CPU) with the JAX model's parameters on
    both; lengthscales set to 2 so the Grams are well conditioned."""
    jm = sat.VariationalGPSA(dd, **kw)
    jm.params = dict(jm.params)
    for name in ("warp_kernel_lengthscales", "data_kernel_lengthscale"):
        jm.params[name] = jnp.full_like(jm.params[name], math.log(2.0))
    tm = tp.VariationalGPSA(dd, device="cpu", **kw)
    params, consts = params_from_numpy(
        jax.tree.map(np.asarray, jm.params), jax.tree.map(np.asarray, jm.consts), "cpu"
    )
    tm._set_state(params, consts, tm._batch, 0)
    return jm, tm


def jax_noise(spec, key, S, analytic=False):
    """The normals core.negative_elbo draws for ``key``, as torch tensors."""
    V, D = spec.n_views, spec.n_spatial_dims
    Ntot = sum(m.n_padded for m in spec.modalities)
    if analytic:
        k_warp = jax.random.split(key, 2)[0]
        return torch.tensor(np.asarray(jax.random.normal(k_warp, (S, V, Ntot, D)))), None
    k_warp, k_data, _ = jax.random.split(key, 3)
    warp = torch.tensor(np.asarray(jax.random.normal(k_warp, (S, V, Ntot, D))))
    keys = jax.random.split(k_data, spec.n_modalities)
    data = {
        mod.name: torch.tensor(
            np.asarray(jax.random.normal(kk, (S, V * mod.n_padded, mod.n_latent)))
        )
        for kk, mod in zip(keys, spec.modalities)
    }
    return warp, data


def leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


_jit_value_and_grad = jax.jit(
    jax.value_and_grad(jcore.negative_elbo, argnums=1), static_argnums=(0, 5)
)
_jit_forward = jax.jit(jcore.forward, static_argnums=(0, 4))
_jit_predict_mean = jax.jit(jcore.predict_mean, static_argnums=(0,))


# ---------------------------------------------------------------------------
# spec and init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n_per_view,m,expect_mode",
    [(30, 8, "kl_inverse"), (1000, 64, "mixed")],
    ids=["small", "large"],
)
def test_build_spec_dict_equal(n_per_view, m, expect_mode):
    dd = make_two_view_data(n_per_view=n_per_view, n_outputs=3)
    kw = dict(m_X_per_view=m, m_G=m, n_latent_gps={"expression": 2}, fixed_view_idx=0)
    want = jspec.spec_to_dict(jspec.build_spec(dd, **kw))
    got = tspec.spec_to_dict(tspec.build_spec(dd, **kw))
    assert got == want
    assert got["svgp_solve_mode"] == expect_mode
    assert tspec.spec_from_dict(json.loads(json.dumps(got))) == tspec.build_spec(dd, **kw)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


@pytest.mark.parametrize("data_init", [False, True])
def test_init_params_bit_identical(data_init):
    dd = make_two_view_data(n_per_view=30, n_outputs=3)
    kw = dict(m_X_per_view=8, m_G=8, n_latent_gps={"expression": 2}, fixed_view_idx=0)
    spec_j = jspec.build_spec(dd, **kw)
    spec_t = tspec.build_spec(dd, **kw)
    pj, cj, _ = jparams.init_params(spec_j, dd, data_init=data_init, seed=3)
    pt, ct, _ = tparams.init_params(spec_t, dd, data_init=data_init, seed=3)
    flat_j = dict(jax.tree_util.tree_flatten_with_path((pj, cj))[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path((_np_tree(pt), _np_tree(ct)))[0])
    assert flat_j.keys() == flat_t.keys()
    kmeans_leaves = {"Xtilde", "Gtilde", "delta_G"}
    for path, want in flat_j.items():
        got = flat_t[path]
        assert got.dtype == np.float32
        if data_init and path[-1].key in kmeans_leaves:
            assert got.shape == want.shape  # own k-means: other centres
        else:
            np.testing.assert_array_equal(got, np.asarray(want))


def test_kmeans_inertia_close_to_sklearn():
    """The port's numpy k-means++ + Lloyd lands within 1.2x of sklearn's
    inertia on the same points."""
    from sklearn.cluster import KMeans

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(c, 0.5, (60, 2)) for c in rng.uniform(0, 10, (6, 2))])
    x = x.astype(np.float32)
    inertia = lambda c: float(((x[:, None] - c[None]) ** 2).sum(-1).min(1).sum())
    ours = tparams.kmeans_centers(x, 12, seed=0)
    theirs = KMeans(n_clusters=12, n_init=10, random_state=0).fit(x).cluster_centers_
    assert ours.shape == (12, 2) and ours.dtype == np.float32
    assert inertia(ours) <= 1.2 * inertia(theirs)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

_ELBO_CASES = [
    ("solve", 0, 2, False),
    ("solve", None, None, False),
    ("kl_inverse", 0, 2, False),
    ("kl_inverse", None, None, True),  # + analytic data likelihood at temperature 0
    ("inverse", 0, 2, False),
    ("inverse", None, None, False),
    ("mixed", 0, 2, False),
    ("mixed", None, None, False),
]


@pytest.mark.parametrize(
    "mode,fixed,lmc,analytic",
    _ELBO_CASES,
    ids=[f"{c[0]}-{'template_lmc' if c[1] is not None else 'denovo'}{'-analytic' if c[3] else ''}"
         for c in _ELBO_CASES],
)
def test_negative_elbo_and_grads_match_jax(mode, fixed, lmc, analytic):
    dd = make_two_view_data(n_per_view=24, n_outputs=3)
    jm, tm = model_pair(
        dd, m_X_per_view=8, m_G=8, n_latent_gps={"expression": lmc}, fixed_view_idx=fixed,
        svgp_solve_mode=mode, analytic_data_likelihood=analytic,
    )
    S, temp = 2, (0.0 if analytic else 1.0)
    key = jax.random.PRNGKey(7)
    loss_j, grads_j = _jit_value_and_grad(
        jm.spec, jm.params, jm.consts, jm._batch, key, S, temp
    )
    warp, data = jax_noise(jm.spec, key, S, analytic=analytic)
    loss_t = tcore.negative_elbo(
        tm.spec, tm.params, tm.consts, tm._batch, S, temp, warp_noise=warp, data_noise=data
    )
    loss_t.backward()
    assert _rel(loss_t.detach(), loss_j) <= 1e-5
    for path, g in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        got = leaf(tm.params, path).grad
        assert _rel(got, g) <= 1e-4, (jax.tree_util.keystr(path), _rel(got, g))


def test_negative_elbo_at_default_init_within_conditioning_bound():
    """The constructor's own parameters, lengthscales untouched: the warp
    Grams (lengthscale 10 over points in [0, 10]^2) are nearly singular, so
    the two packages' float32 Cholesky factors, and the gradients through
    them, part at the level cond * 2^-24. The loss stays at rel 1e-5; the
    gradients are held to rel 2e-3 (the worst leaf, the warp variances,
    differs by about 6e-4)."""
    dd = make_two_view_data(n_per_view=24, n_outputs=3)
    kw = dict(m_X_per_view=8, m_G=8, n_latent_gps={"expression": 2}, fixed_view_idx=0,
              svgp_solve_mode="mixed")
    jm = sat.VariationalGPSA(dd, **kw)
    tm = tp.VariationalGPSA(dd, device="cpu", **kw)
    params, consts = params_from_numpy(
        jax.tree.map(np.asarray, jm.params), jax.tree.map(np.asarray, jm.consts), "cpu"
    )
    tm._set_state(params, consts, tm._batch, 0)
    S, key = 2, jax.random.PRNGKey(7)
    loss_j, grads_j = _jit_value_and_grad(jm.spec, jm.params, jm.consts, jm._batch, key, S, 1.0)
    warp, data = jax_noise(jm.spec, key, S)
    loss_t = tcore.negative_elbo(
        tm.spec, tm.params, tm.consts, tm._batch, S, 1.0, warp_noise=warp, data_noise=data
    )
    loss_t.backward()
    assert _rel(loss_t.detach(), loss_j) <= 1e-5
    for path, g in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        got = leaf(tm.params, path).grad
        assert _rel(got, g) <= 2e-3, (jax.tree_util.keystr(path), _rel(got, g))


def test_forward_and_predict_mean_match_jax():
    dd = make_two_view_data(n_per_view=24, n_outputs=3)
    jm, tm = model_pair(dd, m_X_per_view=8, m_G=8, n_latent_gps={"expression": 2}, fixed_view_idx=0)
    hp_j = {**jm.consts, **jm.params}
    hp_t = {**tm.consts, **tm.params}
    key = jax.random.PRNGKey(11)
    res_j = _jit_forward(jm.spec, hp_j, jm._batch, key, 3)
    warp, data = jax_noise(jm.spec, key, 3)
    with torch.no_grad():
        res_t = tcore.forward(tm.spec, hp_t, tm._batch, 3, warp_noise=warp, data_noise=data)
        pred_t = tcore.predict_mean(tm.spec, hp_t, tm._batch)
    pred_j = _jit_predict_mean(jm.spec, hp_j, jm._batch)
    for field in ("G_means", "G_samples", "F_observed_samples"):
        assert _rel(getattr(res_t, field)["expression"], getattr(res_j, field)["expression"]) <= 1e-5
    for got, want in zip(pred_t, pred_j):
        assert _rel(got["expression"], want["expression"]) <= 1e-5
    # The model-level read-out in the reference layout.
    G_t, F_t, _ = tm.predict({"expression": dd["expression"]["spatial_coords"]})
    assert G_t["expression"].shape == (48, 2)
    for got, want in ((G_t, pred_j[0]), (F_t, pred_j[1])):
        want = jspec.unpack_points(jm.spec, "expression", want["expression"])
        assert _rel(got["expression"], want) <= 1e-5


def test_jax_checkpoint_round_trip(tmp_path):
    dd = make_two_view_data(n_per_view=24, n_outputs=3)
    jm = sat.VariationalGPSA(dd, m_X_per_view=8, m_G=8, n_latent_gps={"expression": 2},
                             fixed_view_idx=0)
    path = str(tmp_path / "model.npz")
    jm.save(path)
    tm = load_jax_checkpoint(path, device="cpu")
    assert tspec.spec_to_dict(tm.spec) == jspec.spec_to_dict(jm.spec)
    for p, want in jax.tree_util.tree_flatten_with_path(jm.params)[0]:
        np.testing.assert_array_equal(leaf(tm.params, p).detach().numpy(), np.asarray(want))
    for name in ("coords", "outputs", "mask"):
        np.testing.assert_array_equal(
            tm._batch["expression"][name].numpy(), np.asarray(jm._batch["expression"][name])
        )
    assert tm.fixed_view_idx == 0
    assert np.isfinite(tm.neg_elbo(S=2))


@pytest.mark.parametrize(
    "kw",
    [
        {"triangular_variational": True},
        {"whitened_variational": True},
        {"data_chunk_size": 16},
        {"quad_diag_impl": "pallas"},
        {"fused_factor_inverse": "fused"},
    ],
    ids=lambda kw: next(iter(kw)),
)
def test_options_outside_the_slice_raise(kw):
    dd = make_two_view_data(n_per_view=12, n_outputs=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tp.VariationalGPSA(dd, m_X_per_view=4, m_G=4, device="cpu", **kw)
