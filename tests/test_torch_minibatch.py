"""PyTorch port: minibatch SVI and the data layer's point-axis chunking,
held against the JAX package (mirrors tests/test_minibatch.py).

The port cannot reproduce ``jax.random``, so the parity tests re-draw the
JAX package's subsample indices and Monte-Carlo normals from the same keys
and splits as ``core.negative_elbo_minibatch`` (split(key): k_idx, k_elbo;
split(k_idx, n_mod); randint(kk, (V, B), 0, N_v); then ``negative_elbo``'s
own draws from k_elbo) and pass them to the port. On the forced route
(``set_gram_force(True)`` on both sides) the JAX side runs its Pallas Gram
kernel in interpret mode and the port its plain version.

Tolerances: the gathered sub-batch exactly; losses rel 1e-5 and gradients
rel 2.5e-4 per parameter leaf (max-norm), for float32 sums over points and
samples in other orders. The worst leaf is the data kernel's lengthscale,
whose gradient sums over all point pairs with cancellation: on the same
inputs the JAX package's own default and forced routes part at 4e-5 on it,
and the two packages' forced routes at 1.2e-4. Chunked against
unchunked rel 1e-5 (the same products at other widths); the unbiasedness
check within 4 standard errors of the mean, as tests/test_minibatch.py.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from spatial_alignment_tpu.models import core as jcore
from spatial_alignment_tpu.models import spec as jspec
from spatial_alignment_tpu.ops import pallas_gram as jpg
import spatial_alignment_tpu_torch as tp
from spatial_alignment_tpu_torch.models import core as tcore
from spatial_alignment_tpu_torch.models import spec as tspec
from spatial_alignment_tpu_torch.ops import gram as tg

from conftest import make_two_view_data
from test_torch_model import _rel, jax_noise, leaf, model_pair

# The suite runs in several worker processes on shared cores; PyTorch's
# default of one intra-op thread per core in each of them oversubscribes
# the machine and slows these tiny problems by orders of magnitude.
torch.set_num_threads(1)


def _uneven_data(n=(20, 12)):
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 10, (sum(n), 2)).astype(np.float32)
    Y = rng.standard_normal((sum(n), 3)).astype(np.float32)
    return {"expression": {"spatial_coords": X, "outputs": Y, "n_samples_list": list(n)}}


def _jax_indices(spec, sub_spec, key):
    """The indices ``negative_elbo_minibatch(key)`` gathers, and its ELBO key."""
    k_idx, k_elbo = jax.random.split(key)
    keys = jax.random.split(k_idx, spec.n_modalities)
    idx = {}
    for kk, mod, smod in zip(keys, spec.modalities, sub_spec.modalities):
        counts = jnp.asarray(mod.n_samples)[:, None]
        drawn = jax.random.randint(kk, (spec.n_views, smod.n_padded), 0, counts)
        idx[mod.name] = torch.from_numpy(np.asarray(drawn).astype(np.int64))
    return idx, k_idx, k_elbo


def test_minibatch_spec_matches_jax():
    dd = _uneven_data()
    kw = dict(m_X_per_view=4, m_G=4, n_latent_gps={"expression": 2}, fixed_view_idx=0)
    want = jspec.spec_to_dict(jcore.minibatch_spec(jspec.build_spec(dd, **kw), 7))
    got = tspec.spec_to_dict(tcore.minibatch_spec(tspec.build_spec(dd, **kw), 7))
    assert got == want
    assert got["modalities"][0]["n_samples"] == (7, 7)
    with pytest.raises(ValueError):
        tcore.minibatch_spec(tspec.build_spec(dd, **kw), 0)


def test_subsample_with_jax_indices_matches_jax():
    jm, tm = model_pair(_uneven_data(), m_X_per_view=4, m_G=4, n_latent_gps={"expression": 2})
    B = 9
    jsub_spec = jcore.minibatch_spec(jm.spec, B)
    idx, k_idx, _ = _jax_indices(jm.spec, jsub_spec, jax.random.PRNGKey(1))
    want = jcore.subsample_batch(jm.spec, jsub_spec, jm._batch, k_idx)["expression"]
    got = tcore.subsample_batch(tm.spec, tcore.minibatch_spec(tm.spec, B), tm._batch,
                                indices=idx)["expression"]
    for name in ("coords", "outputs", "mask"):
        assert got[name].shape == tuple(want[name].shape)
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


def test_own_draws_gather_real_points_of_uneven_views():
    """The port's device draws: every gathered point is one of its view's
    real points (never padding), with the N_v / B weight per view."""
    model = tp.VariationalGPSA(_uneven_data(), m_X_per_view=4, m_G=4, device="cpu")
    B = 200
    sub_spec = tcore.minibatch_spec(model.spec, B)
    gen = torch.Generator().manual_seed(4)
    sub = tcore.subsample_batch(model.spec, sub_spec, model._batch, generator=gen)["expression"]
    full = model._batch["expression"]["coords"].numpy()
    coords = sub["coords"].numpy()
    for v, n_v in enumerate([20, 12]):
        np.testing.assert_allclose(sub["mask"][v].numpy(), n_v / B)
        hit = (np.abs(full[v][None, :, :] - coords[v][:, None, :]).sum(-1) == 0)
        assert hit[:, :n_v].any(axis=1).all()
        assert hit[:, :n_v].any(axis=0).all()  # 200 draws reach every one of <= 20 points


# One jitted function per route: the JAX package reads its Gram switch when
# it traces, so the forced route must not share a trace cache with the
# default one.
_vg = lambda: jax.jit(jax.value_and_grad(jcore.negative_elbo_minibatch, argnums=2),
                      static_argnums=(0, 1, 6))
_jit_vg = {False: _vg(), True: _vg()}


def _jax_forced(fn):
    jpg.set_gram_force(True)
    try:
        with pltpu.force_tpu_interpret_mode():
            return fn()
    finally:
        jpg.set_gram_force(None)


@pytest.mark.parametrize("chunk", [None, 8], ids=["unchunked", "chunked"])
@pytest.mark.parametrize("forced", [False, True], ids=["default", "forced_gram"])
def test_negative_elbo_minibatch_and_grads_match_jax(forced, chunk):
    """JAX's indices and normals through both packages: loss and every
    gradient leaf. On the forced route each Gram takes the plain version of
    the kernel: the warp layer's one and the data layer's one per chunk."""
    dd = make_two_view_data(n_per_view=24, n_outputs=3)
    jm, tm = model_pair(dd, m_X_per_view=8, m_G=8, n_latent_gps={"expression": 2},
                        fixed_view_idx=0, data_chunk_size=chunk)
    B, S, key = 16, 2, jax.random.PRNGKey(5)
    jsub_spec = jcore.minibatch_spec(jm.spec, B)

    def jax_side():
        return _jit_vg[forced](jm.spec, jsub_spec, jm.params, jm.consts, jm._batch, key, S, 1.0)

    loss_j, grads_j = _jax_forced(jax_side) if forced else jax_side()
    idx, _, k_elbo = _jax_indices(jm.spec, jsub_spec, key)
    warp, data = jax_noise(jsub_spec, k_elbo, S)
    tg.plain_calls, tg.launches = 0, 0
    tg.set_gram_force(forced)
    try:
        loss_t = tcore.negative_elbo_minibatch(
            tm.spec, tcore.minibatch_spec(tm.spec, B), tm.params, tm.consts, tm._batch, S, 1.0,
            indices=idx, warp_noise=warp, data_noise=data,
        )
        loss_t.backward()
    finally:
        tg.set_gram_force(None)
    n_chunks = 2 * B // chunk if chunk else 1
    assert (tg.plain_calls, tg.launches) == ((1 + n_chunks if forced else 0), 0)
    assert _rel(loss_t.detach(), loss_j) <= 1e-5
    for path, g in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        got = leaf(tm.params, path).grad
        assert _rel(got, g) <= 2.5e-4, (jax.tree_util.keystr(path), _rel(got, g))


def test_minibatch_elbo_unbiased():
    """E[minibatch loss] over the port's own index draws equals the
    full-batch loss (temperature 0 and the analytic data likelihood, so the
    subsample is the only randomness, and the likelihood is linear in it)."""
    model = tp.VariationalGPSA(make_two_view_data(), m_X_per_view=8, m_G=8,
                               n_latent_gps={"expression": None},
                               analytic_data_likelihood=True, device="cpu")
    spec, params, consts, batch = model.spec, model.params, model.consts, model._batch
    gen = torch.Generator().manual_seed(0)
    sub_spec = tcore.minibatch_spec(spec, 15)
    with torch.no_grad():
        full = float(tcore.negative_elbo(spec, params, consts, batch, 1, 0.0, generator=gen))
        vals = np.array([
            float(tcore.negative_elbo_minibatch(spec, sub_spec, params, consts, batch, 1, 0.0,
                                                generator=gen))
            for _ in range(200)
        ])
    stderr = vals.std(ddof=1) / np.sqrt(len(vals))
    assert abs(vals.mean() - full) < 4.0 * stderr + 1e-6 * abs(full)


def test_minibatch_exact_when_single_point_views():
    """One true point per view: B copies at weight 1/B give the full loss."""
    model = tp.VariationalGPSA(make_two_view_data(n_per_view=1, n_outputs=2), m_X_per_view=1,
                               m_G=2, n_latent_gps={"expression": None},
                               analytic_data_likelihood=True, device="cpu")
    args = (model.params, model.consts, model._batch, 1, 0.0)
    with torch.no_grad():
        full = float(tcore.negative_elbo(model.spec, *args, generator=model._gen))
        mb = float(tcore.negative_elbo_minibatch(
            model.spec, tcore.minibatch_spec(model.spec, 4), *args, generator=model._gen))
    np.testing.assert_allclose(mb, full, rtol=1e-5)


def _grads(hp, out):
    leaves = [hp[k] for k in ("Gtilde", "data_kernel_lengthscale", "delta_F", "Omega_sqt_F")]
    leaves = [v for l in leaves for v in (l.values() if isinstance(l, dict) else [l])]
    return torch.autograd.grad(out, leaves)


def test_chunked_data_layer_matches_unchunked_and_jax():
    """``data_layer`` and ``data_layer_moments`` with the point axis in three
    chunks equal the unchunked port (values and gradients, through the
    recomputed chunks) and JAX's ``lax.map`` path on the same points and
    noise."""
    dd = make_two_view_data(n_per_view=24, n_outputs=3)
    jm, tm = model_pair(dd, m_X_per_view=8, m_G=8, n_latent_gps={"expression": 2},
                        fixed_view_idx=0)
    rng = np.random.default_rng(6)
    S = 2
    G = rng.uniform(0, 10, (S, 2, 24, 2)).astype(np.float32)
    eps = rng.standard_normal((S, 48, 2)).astype(np.float32)
    hp_j = {**jm.consts, **jm.params}
    w = torch.from_numpy(rng.standard_normal((S, 2, 24, 3)).astype(np.float32))
    out = {}
    for chunk in (None, 16):
        js = jm.spec.replace(data_chunk_size=chunk)
        ts = tm.spec.replace(data_chunk_size=chunk)
        j_lat, j_obs, _ = jcore.data_layer(js, hp_j, {"expression": G}, jax.random.PRNGKey(0),
                                           noise={"expression": eps})
        j_mu, j_var, _ = jcore.data_layer_moments(js, hp_j, {"expression": G})
        hp_t = {**tm.consts, **tm.params}
        t_lat, t_obs, _ = tcore.data_layer(ts, hp_t, {"expression": torch.from_numpy(G)},
                                           noise={"expression": torch.from_numpy(eps)})
        t_mu, t_var, _ = tcore.data_layer_moments(ts, hp_t, {"expression": torch.from_numpy(G)})
        got = [t_lat["expression"], t_obs["expression"], t_mu["expression"], t_var["expression"]]
        want = [j_lat["expression"], j_obs["expression"], j_mu["expression"], j_var["expression"]]
        for a, b in zip(got, want):
            assert a.shape == tuple(b.shape)
            assert _rel(a.detach(), b) <= 1e-5
        out[chunk] = [t.detach() for t in got] + list(
            _grads(hp_t, (got[1] * w).sum() + (got[2] * w).sum() + got[3].sum()))
    for a, b in zip(out[16], out[None]):
        assert _rel(a, b) <= 1e-5


@pytest.mark.parametrize("n,requested", [
    (8192, 8192), (8192, 2048), (100000, 8192), (48, 16), (7, 3), (13, 4), (97, 10),
    (10, None), (5, 10),
])
def test_pick_chunk_matches_jax(n, requested):
    assert tcore._pick_chunk(n, requested) == jcore._pick_chunk(n, requested)


def test_fit_minibatch_composes_with_recipe_options():
    """minibatch + accurate recipe + tail averaging + print_every and the
    callback in one fit() call; a minibatch size below 1 raises."""
    model = tp.VariationalGPSA(make_two_view_data(), m_X_per_view=8, m_G=8,
                               n_latent_gps={"expression": None}, device="cpu")
    seen = []
    losses = model.fit(120, S=2, minibatch_size=16, recipe="accurate", average_last=40,
                       print_every=60, callback=lambda m, t, l: seen.append(t))
    assert losses.shape == (120,) and np.isfinite(losses).all()
    assert seen == [0, 60]
    assert all(p.requires_grad and p.is_leaf for p in model.parameters())
    with pytest.raises(ValueError):
        model.fit(10, minibatch_size=0)
