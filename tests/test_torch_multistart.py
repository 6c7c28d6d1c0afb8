"""PyTorch port: ``fit_multistart`` and what it needs, on the CPU, against
the JAX package where the two compute the same thing (mirrors the
multistart tests of tests/test_model_core.py and
tests/test_checkpoint_plotting.py).

Against the JAX package on the same numpy inputs: the numpy copies of
``prealign`` and ``ot`` and the affine seeds built from them (1e-10: the
same float64 numpy code); ``_holdout_split`` with one ``np.random``
seed (exactly); the consistency score and the held-out predictive score of
the same parameters (rel 1e-5, float32 predictions of two libraries, as
test_torch_model.py holds them); the R-wide loss and per-restart gradients
against ``jax.vmap(jax.value_and_grad(negative_elbo))`` with the JAX
package's draws injected (loss rel 1e-5 as test_torch_model.py; gradients
rel 2.5e-4 per leaf, as test_torch_minibatch.py: the data kernel's
lengthscale, whose gradient sums over all point pairs with cancellation,
parts the two packages by 2.4e-4 at one of these restarts' parameters with
no vmap at all); and the winner and top-2 ensemble both packages pick from
the same per-restart parameters and losses.

The restart axis is ``torch.func.vmap``-ed through the loss and folded
into each kernel's batch: one R-wide loss and gradient calls each plain
version (the kernels' stand-ins on the CPU) as often as one restart's does.
Restart r of an R-wide run against that restart alone from the same
parameters and draws: losses rel 1e-5 over 10 Adam steps, parameters rel
1e-4 (float32 batched products in another order; Adam passes a gradient
difference into the update unshrunk).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spatial_alignment_tpu as sat
from spatial_alignment_tpu.models import core as jcore
from spatial_alignment_tpu.utils import ot as jot
from spatial_alignment_tpu.utils import prealign as jprealign
import spatial_alignment_tpu_torch as tp
from spatial_alignment_tpu_torch import ops
from spatial_alignment_tpu_torch.models import core as tcore
from spatial_alignment_tpu_torch.models.convert import params_from_numpy
from spatial_alignment_tpu_torch.models._trees import leaves, tree_map
from spatial_alignment_tpu_torch.ops.gram import set_gram_force
from spatial_alignment_tpu_torch.utils import ot as tot
from spatial_alignment_tpu_torch.utils import prealign as tprealign

from conftest import make_two_view_data
from test_torch_minibatch import _jax_indices
from test_torch_model import _rel, jax_noise, leaf, model_pair

# The suite runs in several worker processes on shared cores; PyTorch's
# default of one intra-op thread per core in each of them oversubscribes
# the machine and slows these tiny problems by orders of magnitude.
torch.set_num_threads(1)

KW = dict(m_X_per_view=6, m_G=6, n_latent_gps={"expression": None})


def _model(dd=None, **kw):
    return tp.VariationalGPSA(dd if dd is not None else make_two_view_data(), device="cpu",
                              **{**KW, **kw})


def _affine_data():
    """View 1 is an exact rotation and shift of view 0 (template)."""
    dd = make_two_view_data()
    X = dd["expression"]["spatial_coords"].copy()
    Y = dd["expression"]["outputs"].copy()
    theta = 0.5
    Rm = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    X[30:] = X[:30] @ Rm.T + np.array([1.5, -0.5])
    Y[30:] = Y[:30]
    return {"expression": {"spatial_coords": X.astype(np.float32), "outputs": Y,
                           "n_samples_list": [30, 30]}}


def _plain_counts():
    return {k: v for k, v in ops.read_counters().items() if k.endswith("plain_calls")}


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def test_prealign_and_ot_copies_match_jax():
    dd = _affine_data()
    X = dd["expression"]["spatial_coords"].astype(np.float64)
    Y = dd["expression"]["outputs"].astype(np.float64)
    for refl in (False, True):
        got = tprealign.moment_align(X[30:], Y[30:], X[:30], Y[:30], allow_reflection=refl)
        want = jprealign.moment_align(X[30:], Y[30:], X[:30], Y[:30], allow_reflection=refl)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)
    got = tprealign.coarse_affine_prealign([X[:30], X[30:]], [Y[:30], Y[30:]])
    want = jprealign.coarse_affine_prealign([X[:30], X[30:]], [Y[:30], Y[30:]])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)
    idx = [np.arange(30), np.arange(30, 60)]
    np.testing.assert_allclose(tot.entropic_ot_align_views(X, Y, idx),
                               jot.entropic_ot_align_views(X, Y, idx), rtol=0, atol=1e-10)
    C = np.abs(np.subtract.outer(Y[:30, 0], Y[30:, 0]))
    np.testing.assert_allclose(tot.sinkhorn(C), jot.sinkhorn(C), rtol=0, atol=1e-10)


@pytest.mark.parametrize("fixed", [0, None], ids=["template", "denovo"])
@pytest.mark.parametrize("method", ["prealign", "ot"])
def test_warp_init_transforms_match_jax(method, fixed):
    """The affine seeds of both packages on the same data (the anchor is the
    template, else view 0); on this data they undo the rotation."""
    dd = _affine_data()
    jm = sat.VariationalGPSA(dd, **KW, fixed_view_idx=fixed)
    tm = _model(dd, fixed_view_idx=fixed)
    got, want = tm._warp_init_transforms(method), jm._warp_init_transforms(method)
    assert got[0] is None and want[0] is None
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)
    X = dd["expression"]["spatial_coords"]
    A_T, b = got[1]
    err = float(np.mean(np.sum((X[30:] @ A_T + b - X[:30]) ** 2, axis=1)))
    assert err < 0.05 * float(np.mean(np.sum((X[30:] - X[:30]) ** 2, axis=1)))
    with pytest.raises(ValueError, match="unknown warp init method"):
        tm._warp_init_transforms("bogus")


def test_apply_warp_seed_sets_delta():
    m = _model()
    A_T, b = 2.0 * np.eye(2), np.array([1.0, -1.0])
    p = m._apply_warp_seed(m.params, [None, (A_T, b)])
    Xt = m.params["Xtilde"].detach().numpy()
    np.testing.assert_allclose(p["delta_G"].numpy()[0], Xt[0])
    np.testing.assert_allclose(p["delta_G"].numpy()[1], Xt[1] @ A_T + b, rtol=1e-6)
    np.testing.assert_allclose(m.params["delta_G"].detach().numpy(), Xt)  # untouched


@pytest.mark.parametrize("fixed", [0, None], ids=["template", "denovo"])
def test_holdout_split_matches_jax(fixed):
    dd = make_two_view_data()
    jm = sat.VariationalGPSA(dd, **KW, fixed_view_idx=fixed)
    tm = _model(dd, fixed_view_idx=fixed)
    got = tm._holdout_split(0.2, np.random.default_rng(3))
    want = jm._holdout_split(0.2, np.random.default_rng(3))
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g["expression"]:
            np.testing.assert_array_equal(np.asarray(g["expression"][k]),
                                          np.asarray(w["expression"][k]))
    counts, h_counts = got[0]["expression"]["n_samples_list"], got[1]["expression"]["counts"]
    if fixed == 0:
        assert counts[0] == 30 and h_counts[0] == 0  # the template is never held out
    assert h_counts[1] == round(0.2 * 30) and counts[1] == 30 - h_counts[1]


def _carried(dd, **kw):
    """(JAX model, port model) holding the same trained-looking parameters:
    the JAX model's, with a per-view random offset on the warp's mean so the
    aligned coordinates move."""
    jm, tm = model_pair(dd, **{**KW, **kw})
    jm.params = dict(jm.params)
    rng = np.random.default_rng(5)
    jm.params["delta_G"] = jm.params["delta_G"] + jnp.asarray(
        0.3 * rng.standard_normal(np.shape(jm.params["delta_G"])), jnp.float32)
    params, _ = params_from_numpy(jax.tree.map(np.asarray, jm.params), {}, "cpu")
    with torch.no_grad():
        for dst, src in zip(tm.parameters(), leaves(params)):
            dst.copy_(src)
    return jm, tm


def test_alignment_consistency_matches_jax():
    dd = make_two_view_data()
    jm, tm = _carried(dd, fixed_view_idx=0)
    X = {"expression": dd["expression"]["spatial_coords"]}
    vi, Ns, _, _ = tm.create_view_idx_dict(dd)
    G_t = tm.forward(X, vi, Ns)[0]
    G_j = {k: np.asarray(v) for k, v in jm.forward(X, vi, Ns)[0].items()}
    assert _rel(G_t["expression"], G_j["expression"]) <= 1e-5
    for cap in (5000, 10):  # whole views, and the fixed-seed subsample
        got, want = tm._alignment_consistency(G_t, max_points=cap), \
            jm._alignment_consistency(G_j, max_points=cap)
        assert np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want)
    assert tm._alignment_consistency(G_t, max_points=10) == \
        tm._alignment_consistency(G_t, max_points=10)
    assert tm._alignment_consistency(G_t, max_points=10) != tm._alignment_consistency(G_t)


def test_predictive_score_matches_jax():
    dd = make_two_view_data()
    jm, tm = _carried(dd, fixed_view_idx=0)
    train_dd, holdout = tm._holdout_split(0.2, np.random.default_rng(0))
    jsub, tsub = _carried(train_dd, fixed_view_idx=0)
    got, want = tm._predictive_score(tsub, holdout), jm._predictive_score(jsub, holdout)
    assert np.isfinite(got) and abs(got - want) <= 1e-5 * abs(want)


def _jax_restart_params(jm, R):
    """R-stacked JAX parameters: the model's (model_pair's parity point of
    test_negative_elbo_and_grads_match_jax), each restart with its own
    offset of the warp's mean and of the noise variance. Other seeds' init
    draws can leave a leaf's float32 gradient parting from JAX's by 5e-4
    through cancellation, one restart alone as much as R of them."""
    rng = np.random.default_rng(4)
    ps = []
    for r in range(R):
        p = dict(jm.params)
        p["delta_G"] = p["delta_G"] + jnp.asarray(
            0.1 * r * rng.standard_normal(np.shape(p["delta_G"])), jnp.float32)
        p["noise_variance"] = p["noise_variance"] + 0.2 * r
        ps.append(p)
    return jax.tree.map(lambda *xs: jnp.stack(xs), *ps)


@pytest.mark.parametrize("minibatch", [None, 10], ids=["full_batch", "minibatch"])
def test_restart_losses_and_grads_match_jax_vmap(minibatch):
    """The port's R-wide step (vmap over R-stacked parameters, the R losses'
    sum differentiated) against jax.vmap(jax.value_and_grad(...)) on the
    same parameters and the JAX package's draws."""
    dd = make_two_view_data(n_per_view=24, n_outputs=3)
    jm, tm = model_pair(dd, m_X_per_view=8, m_G=8, n_latent_gps={"expression": 2},
                        fixed_view_idx=0)
    R, S = 3, 2
    params_j = _jax_restart_params(jm, R)
    keys = jax.random.split(jax.random.PRNGKey(11), R)
    if minibatch is None:
        f = lambda p, k: jcore.negative_elbo(jm.spec, p, jm.consts, jm._batch, k, S, 1.0)
        draws = [jax_noise(jm.spec, k, S) + (None,) for k in keys]
    else:
        jsub = jcore.minibatch_spec(jm.spec, minibatch)
        f = lambda p, k: jcore.negative_elbo_minibatch(jm.spec, jsub, p, jm.consts, jm._batch,
                                                       k, S, 1.0)
        draws = []
        for k in keys:
            idx, _, k_elbo = _jax_indices(jm.spec, jsub, k)
            draws.append(jax_noise(jsub, k_elbo, S) + (idx,))
    losses_j, grads_j = jax.jit(jax.vmap(jax.value_and_grad(f)))(params_j, keys)

    stack = lambda ts: torch.stack(ts)
    warp = stack([d[0] for d in draws])
    data = {k: stack([d[1][k] for d in draws]) for k in draws[0][1]}
    idx = None if minibatch is None else {k: stack([d[2][k] for d in draws]) for k in draws[0][2]}
    tm._draw_restart_noise = lambda R_, S_: (warp, data, idx)
    params_t, _ = params_from_numpy(jax.tree.map(np.asarray, params_j), {}, "cpu")
    params_t = tree_map(lambda v: v.requires_grad_(True), params_t)
    losses_t = tm._restart_step_loss(S, minibatch, R, params_t)(1.0)
    losses_t.sum().backward()
    assert losses_t.shape == (R,)
    for r in range(R):
        assert _rel(losses_t[r].detach(), losses_j[r]) <= 1e-5
    for path, g in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        got = leaf(params_t, path).grad
        for r in range(R):
            assert _rel(got[r], g[r]) <= 2.5e-4, (jax.tree_util.keystr(path), r, _rel(got[r], g[r]))


@pytest.mark.parametrize("select", ["consistency", "loss"])
def test_same_restarts_same_winner_as_jax(select):
    """Both packages' fit_multistart given the same per-restart parameters
    and losses (each package's vectorized trainer replaced by one that
    returns them): the same winner, multistart_winner_ and top-2 ensemble."""
    dd = make_two_view_data()
    jm, tm = model_pair(dd, **KW, fixed_view_idx=0)
    R, T = 3, 8
    params_j = _jax_restart_params(jm, R)
    rng = np.random.default_rng(2)
    params_j = {**params_j, "delta_G": params_j["delta_G"] + jnp.asarray(
        0.4 * rng.standard_normal(np.shape(params_j["delta_G"])), jnp.float32)}
    losses = np.stack([np.linspace(50.0, 10.0 + 3.0 * ((r + 1) % R), T) for r in range(R)])
    params_t, _ = params_from_numpy(jax.tree.map(np.asarray, params_j), {}, "cpu")
    jm._fit_restarts_vectorized = lambda *a, **k: (params_j, losses)
    tm._fit_restarts_vectorized = lambda *a, **k: (params_t, losses)
    kw = dict(n_epochs=T, n_restarts=R, S=2, verbose=False, select=select, ensemble_top_k=2,
              init="mixed")
    got_l, want_l = tm.fit_multistart(**kw), jm.fit_multistart(**kw)
    np.testing.assert_array_equal(got_l, want_l)
    assert tm.multistart_winner_.keys() == jm.multistart_winner_.keys()
    for k, v in jm.multistart_winner_.items():
        got = tm.multistart_winner_[k]
        assert got == v if not isinstance(v, float) else abs(got - v) <= 1e-5 * abs(v)
    if select == "consistency":
        assert _rel(tm.ensemble_G_means_["expression"], jm.ensemble_G_means_["expression"]) \
            <= 1e-5
    else:
        assert tm.ensemble_G_means_ is None and jm.ensemble_G_means_ is None
    r = tm.multistart_winner_["restart"]
    for got, want in zip(tm.parameters(), leaves(params_t)):
        assert torch.equal(got.detach(), want[r])


# ---------------------------------------------------------------------------
# The restart axis through the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "options,minibatch,force",
    [({}, None, None),
     (dict(cholesky_impl="pallas", quad_diag_impl="pallas", fused_factor_inverse="fused"),
      None, None),
     ({}, 10, True),
     (dict(data_chunk_size=10), None, True)],
    ids=["default", "opt_ins", "minibatch_forced_gram", "chunked_forced_gram"],
)
def test_restart_step_calls_each_kernel_once(options, minibatch, force):
    """One R-wide loss and gradient calls each kernel's plain version as
    often as one restart's (the vmapped dim folded into its batch, no loop
    over restarts), and restart r's loss and gradients are restart r's
    alone, from the same parameters and draws. With data_chunk_size the
    restart alone recomputes its chunks in the backward and the R-wide step
    keeps them (no recomputation inside vmap): the same numbers."""
    dd = make_two_view_data(n_per_view=20)
    m = _model(dd, n_latent_gps={"expression": 2}, fixed_view_idx=0, **options)
    R, S = 3, 2
    params = tree_map(lambda v: v.requires_grad_(True), m._restart_inits(R, 0))
    gen = torch.Generator().manual_seed(0)
    sub = tcore.minibatch_spec(m.spec, minibatch) if minibatch else None
    wn, dn, idx = tcore.draw_restart_noise(m.spec, R, S, gen, m.device, sub)
    m._draw_restart_noise = lambda R_, S_: (wn, dn, idx)
    set_gram_force(force)
    try:
        ops.set_counters(dict.fromkeys(ops.read_counters(), 0))
        losses = m._restart_step_loss(S, minibatch, R, params)(1.0)
        losses.sum().backward()
        wide = _plain_counts()
        ops.set_counters(dict.fromkeys(ops.read_counters(), 0))
        for r in range(R):
            alone = tree_map(lambda v: v.detach()[r].clone().requires_grad_(True), params)
            kw = dict(warp_noise=wn[r], data_noise={k: v[r] for k, v in dn.items()})
            if minibatch is None:
                loss = tcore.negative_elbo(m.spec, alone, m.consts, m._batch, S, 1.0, **kw)
            else:
                loss = tcore.negative_elbo_minibatch(
                    m.spec, sub, alone, m.consts, m._batch, S, 1.0,
                    indices={k: v[r] for k, v in idx.items()}, **kw)
            loss.backward()
            if r == 0:
                one = _plain_counts()
            assert _rel(losses[r].detach(), loss.detach()) <= 1e-5
            for a, b in zip(leaves(params), leaves(alone)):
                assert _rel(a.grad[r], b.grad) <= 1e-3
    finally:
        set_gram_force(None)
    assert wide == one and any(wide.values()), (wide, one)


def test_restart_run_equals_each_restart_alone():
    """Ten Adam steps of the R-wide loop against each restart alone
    (make_train_step fed its slice of the same draws)."""
    dd = make_two_view_data(n_per_view=20)
    m = _model(dd, n_latent_gps={"expression": 2}, fixed_view_idx=0)
    R, S, T = 3, 2, 10
    values = m._restart_inits(R, 0)
    gen = torch.Generator().manual_seed(1)
    draws = [tcore.draw_restart_noise(m.spec, R, S, gen, m.device) for _ in range(T)]
    feed = iter(draws)
    m._draw_restart_noise = lambda R_, S_: next(feed)
    losses = m._fit_restarts_vectorized(T, R, 0, S=S)[1]
    params = m._vec_loop_cache["params"]
    del m._draw_restart_noise
    for r in range(R):
        alone = _model(dd, n_latent_gps={"expression": 2}, fixed_view_idx=0)
        with torch.no_grad():
            for dst, src in zip(alone.parameters(), leaves(values)):
                dst.copy_(src[r])
        steps = iter(draws)

        def draw(S_, r=r):
            wn, dn, _ = next(steps)
            return wn[r], {k: v[r] for k, v in dn.items()}

        alone._draw_noise = draw
        got = alone.fit(T, S=S)
        np.testing.assert_allclose(got, losses[r], rtol=1e-5)
        for a, b in zip(alone.parameters(), leaves(params)):
            assert _rel(a.detach(), b.detach()[r]) <= 1e-4


def test_restart_nadam_steps_equal_each_restart_alone():
    """An optimizer whose fresh state is not zero (NAdam's mu_product starts
    at 1) trains vectorized restarts: the R-wide loop restores the state a
    new NAdam starts from, so three R-wide steps equal each restart's three
    steps under a new NAdam from the same parameters and draws: losses rel
    1e-5, as test_restart_run_equals_each_restart_alone holds Adam's (the
    first loss, before any update, already parts by 8e-7: batched float32
    products in another order), parameters rel 1e-4 as there (a leaf that
    starts at 0, the warp variances, is three normalized updates, each
    passing a gradient difference on unshrunk)."""
    dd = make_two_view_data(n_per_view=20)
    m = _model(dd, n_latent_gps={"expression": 2}, fixed_view_idx=0)
    R, S, T = 3, 2, 3
    nadam = lambda p: torch.optim.NAdam(p, lr=1e-2)
    values = m._restart_inits(R, 0)
    gen = torch.Generator().manual_seed(1)
    draws = [tcore.draw_restart_noise(m.spec, R, S, gen, m.device) for _ in range(T)]
    feed = iter(draws)
    m._draw_restart_noise = lambda R_, S_: next(feed)
    losses = m._fit_restarts_vectorized(T, R, 0, S=S, optimizer=nadam)[1]
    params = m._vec_loop_cache["params"]
    for r in range(R):
        alone = _model(dd, n_latent_gps={"expression": 2}, fixed_view_idx=0)
        with torch.no_grad():
            for dst, src in zip(alone.parameters(), leaves(values)):
                dst.copy_(src[r])
        steps = iter(draws)

        def draw(S_, r=r):
            wn, dn, _ = next(steps)
            return wn[r], {k: v[r] for k, v in dn.items()}

        alone._draw_noise = draw
        step, _ = alone.make_train_step(S=S, optimizer=nadam)
        np.testing.assert_allclose([float(step()) for _ in range(T)], losses[r], rtol=1e-5)
        for a, b in zip(alone.parameters(), leaves(params)):
            assert _rel(a.detach(), b.detach()[r]) <= 1e-4


def test_fit_multistart_drops_the_restart_loop():
    """Once fit_multistart returns, the model holds no R-wide loop (its
    graph's pool would be about R times one fit's); fit()'s own stays."""
    m = _model()
    m.fit(3, S=2)
    fit_loop = m._train_loop_cache["loop"]
    m.fit_multistart(n_epochs=5, n_restarts=2, S=2, verbose=False, select="loss",
                     vectorized=True)
    assert "_vec_loop_cache" not in m.__dict__
    assert m._train_loop_cache["loop"] is fit_loop


def _saved_bytes(loss_fn):
    """Bytes of the tensors autograd saves for the backward of ``loss_fn()``."""
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss_fn()
    return sum(saved)


def test_chunks_are_recomputed_outside_the_restart_vmap_only():
    """data_chunk_size bounds what one restart's backward keeps (each
    chunk is recomputed), not what the R-wide step keeps: under the restart
    vmap every chunk's intermediates are saved, as the JAX package's
    lax.map keeps them under its vmap (tools/c3_memory.py prints both)."""
    dd = make_two_view_data(n_per_view=30)
    R, S = 3, 2
    kept = {}
    for chunk in (None, 16):
        m = _model(dd, m_X_per_view=8, m_G=8, n_latent_gps={"expression": 2},
                   fixed_view_idx=0, data_chunk_size=chunk)
        params = tree_map(lambda v: v.requires_grad_(True), m._restart_inits(R, 0))
        wn, dn, _ = tcore.draw_restart_noise(m.spec, R, S, torch.Generator().manual_seed(0),
                                             m.device)
        m._draw_restart_noise = lambda R_, S_: (wn, dn, None)
        alone = tree_map(lambda v: v.detach()[0].clone().requires_grad_(True), params)
        kept[chunk] = (
            _saved_bytes(lambda: m._restart_step_loss(S, None, R, params)(1.0)),
            _saved_bytes(lambda: tcore.negative_elbo(
                m.spec, alone, m.consts, m._batch, S, 1.0, warp_noise=wn[0],
                data_noise={k: v[0] for k, v in dn.items()})),
        )
    (wide_whole, one_whole), (wide_chunked, one_chunked) = kept[None], kept[16]
    assert one_chunked < 0.7 * one_whole
    assert wide_chunked >= wide_whole


# ---------------------------------------------------------------------------
# Behaviour (tests/test_model_core.py, tests/test_checkpoint_plotting.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vectorized", [True, False], ids=["vectorized", "sequential"])
def test_fit_multistart_selects_best_tail_loss(vectorized):
    m = _model()
    losses = m.fit_multistart(n_epochs=60, n_restarts=3, tail=20, verbose=False, lr=1e-2,
                              S=2, select="loss", vectorized=vectorized)
    assert losses.shape == (60,) and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    e = m.neg_elbo(S=2)
    assert np.isfinite(e) and e < losses[0]
    w = m.multistart_winner_
    assert 0 <= w["restart"] < 3 and w["init_family"] == "random"
    assert w["tail_loss"] == pytest.approx(float(np.mean(losses[-20:])))
    assert m._opt_state is None and m._rng_state is None


def test_reinitialize_writes_in_place_and_keeps_the_loop():
    m = _model()
    before = m.params["Omega_sqt_G"].detach().clone()
    tensors = [id(t) for t in m.parameters()]
    m.reinitialize(1)
    assert not torch.allclose(before, m.params["Omega_sqt_G"])
    assert [id(t) for t in m.parameters()] == tensors
    m.fit(10, S=2)
    loop1 = m._train_loop_cache["loop"]
    m.fit(10, S=2)
    assert m._train_loop_cache["loop"] is loop1
    m.fit_multistart(n_epochs=10, n_restarts=2, S=2, verbose=False)  # vectorized
    assert m._train_loop_cache["loop"] is loop1
    m.fit_multistart(n_epochs=10, n_restarts=2, S=2, verbose=False, vectorized=False)
    assert m._train_loop_cache["loop"] is loop1  # each restart's fit() reused it
    m.fit(10, S=3)
    assert m._train_loop_cache["loop"] is not loop1


def test_fit_multistart_predictive_select():
    m = _model(fixed_view_idx=0)
    losses = m.fit_multistart(n_epochs=30, n_restarts=2, S=2, select="predictive",
                              verbose=False)
    assert losses.shape == (30,) and np.isfinite(losses).all()
    assert m._epoch == 30 and m._opt_state is not None  # the winner's full-data fit
    with pytest.raises(ValueError, match="unknown select"):
        m.fit_multistart(n_epochs=5, n_restarts=2, select="bogus")


def test_fit_multistart_consistency_select_and_ensemble():
    m = _model()
    losses = m.fit_multistart(n_epochs=30, n_restarts=2, S=2, verbose=False, ensemble_top_k=2)
    assert losses.shape == (30,) and np.isfinite(losses).all()
    ens = m.ensemble_G_means_["expression"]
    assert ens.shape == (60, 2) and np.isfinite(ens).all()
    assert np.isfinite(m.multistart_winner_["consistency"])
    m.fit_multistart(n_epochs=10, n_restarts=2, S=2, verbose=False)
    assert m.ensemble_G_means_ is None


def test_fit_multistart_adaptive_waves(capsys):
    """A huge rtol stops after the second wave (4 of 6 restarts); rtol
    below zero runs to the cap (waves of 2 and 1)."""
    m = _model()
    losses = m.fit_multistart(n_epochs=20, n_restarts=6, S=2, adaptive_waves=2,
                              adaptive_rtol=0.99, select="consistency", verbose=True)
    out = capsys.readouterr().out
    assert "stabilized" in out and out.count(": consistency ") == 4, out
    assert losses.shape == (20,) and np.isfinite(losses).all()
    m.fit_multistart(n_epochs=20, n_restarts=3, S=2, adaptive_waves=2, adaptive_rtol=-1e9,
                     select="consistency", verbose=True)
    assert capsys.readouterr().out.count(": consistency ") == 3
    with pytest.raises(ValueError, match="consistency selection"):
        m.fit_multistart(n_epochs=5, n_restarts=4, adaptive_waves=2, select="loss")
    with pytest.raises(RuntimeError, match="vectorized restart path"):
        m.fit_multistart(n_epochs=5, n_restarts=4, adaptive_waves=2, vectorized=False)
    with pytest.raises(ValueError, match="adaptive_waves must be"):
        m.fit_multistart(n_epochs=5, n_restarts=4, adaptive_waves=0)


def test_fit_multistart_wave_size_and_partial_wave(capsys):
    """Fixed waves of 2 over 5 restarts: the last wave trains one surplus
    restart and discards it; one captured width serves every wave."""
    m = _model()
    loops = []
    m._restart_loop = lambda *a: loops.append(type(m)._restart_loop(m, *a)) or loops[-1]
    losses = m.fit_multistart(n_epochs=20, n_restarts=5, S=2, verbose=True, wave_size=2)
    assert capsys.readouterr().out.count(": consistency ") == 5
    assert np.isfinite(losses).all() and len(loops) == 3
    assert all(loop is loops[0] for loop in loops) and loops[0].width == 2
    m2 = _model(fixed_view_idx=0)
    losses = m2.fit_multistart(n_epochs=20, n_restarts=4, S=2, verbose=False, wave_size=3,
                               init="mixed")
    assert np.isfinite(losses).all()
    assert m2.multistart_winner_["init_family"] == ["random", "prealign", "ot"][
        m2.multistart_winner_["restart"] % 3]
    with pytest.raises(ValueError, match="mutually exclusive"):
        m.fit_multistart(n_epochs=5, n_restarts=4, wave_size=2, adaptive_waves=2)
    with pytest.raises(ValueError, match="wave_size must be"):
        m.fit_multistart(n_epochs=5, n_restarts=4, wave_size=0)


def test_fit_multistart_vectorized_refusals():
    m = _model()
    with pytest.raises(RuntimeError, match="vectorized=True not supported"):
        m.fit_multistart(n_epochs=5, n_restarts=2, verbose=False, vectorized=True,
                         average_last=3)
    with pytest.raises(ValueError, match="vectorized must be"):
        m.fit_multistart(n_epochs=5, n_restarts=2, verbose=False, vectorized="sometimes")
    damped = lambda p: torch.optim.SGD(p, lr=1e-4, momentum=0.9, dampening=0.5)
    with pytest.raises(RuntimeError, match="not elementwise or cannot be reset"):
        m.fit_multistart(n_epochs=5, n_restarts=2, verbose=False, vectorized=True,
                         optimizer=damped)
    # "auto" trains such a factory sequentially, where fit() refuses it.
    with pytest.raises(ValueError, match="SGD with dampening"):
        m.fit_multistart(n_epochs=5, n_restarts=2, verbose=False, optimizer=damped)


@pytest.mark.parametrize("vectorized", [True, False], ids=["vectorized", "sequential"])
def test_fit_multistart_init_families(vectorized):
    m = _model(fixed_view_idx=0)
    m.fit_multistart(n_epochs=20, n_restarts=3, S=2, verbose=False, init="mixed",
                     vectorized=vectorized)
    w = m.multistart_winner_
    assert w["init_family"] == ["random", "prealign", "ot"][w["restart"]]
    assert np.isfinite(w["consistency"])
    G, _, _ = m.predict({"expression": make_two_view_data()["expression"]["spatial_coords"]})
    assert np.isfinite(G["expression"]).all()
    with pytest.raises(ValueError, match="unknown init"):
        m.fit_multistart(n_epochs=5, n_restarts=2, init="bogus")


def test_multistart_checkpoint_refuses_exact_resume(tmp_path):
    m = _model()
    m.fit(5, S=2)
    m.fit_multistart(n_epochs=10, n_restarts=2, S=2, verbose=False, vectorized=False)
    p = str(tmp_path / "winner.npz")
    m.save(p)
    with pytest.raises(ValueError, match="no optimizer state"):
        _model().fit(5, S=2, resume_from=p)


def test_loaded_model_needs_attach_data(tmp_path):
    dd = make_two_view_data()
    m = _model(dd)
    p = str(tmp_path / "m.npz")
    m.save(p, include_data=False)
    loaded = tp.VariationalGPSA.load(p, device="cpu")
    with pytest.raises(RuntimeError, match="attach_data"):
        loaded.reinitialize(1)
    with pytest.raises(RuntimeError, match="vectorized=True not supported"):
        loaded.fit_multistart(n_epochs=5, n_restarts=2, vectorized=True)
    loaded.attach_data(dd)
    loaded.fit_multistart(n_epochs=10, n_restarts=2, S=2, verbose=False)
    assert loaded.multistart_winner_["init_family"] == "random"
