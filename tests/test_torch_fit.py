"""PyTorch port: the training loop against the JAX package's, and
alignment convergence on the tiny grid.

Five Adam steps: the JAX side runs ``core.negative_elbo`` under
``optax.adam`` with keys it chooses; the port's ``fit`` gets the same
Monte-Carlo normals injected through its per-step noise hook, so both
trajectories see identical data, parameters and noise. ``recipe="accurate"``
is ``optax.cosine_decay_schedule(lr, n, alpha=1e-2)`` on the JAX side and
``CosineAnnealingLR(T_max=n, eta_min=lr/100)`` in the port, with the
temperature-0 warp.

Tolerance: per-step losses rel 1e-5, final parameters rel 1e-4 per leaf
(max-norm). Adam divides each gradient by its own running scale, so the
float32 gradient differences of ~1e-5 carry into the updates unshrunk.
"""

import numpy as np
import pytest
import jax
import optax
import torch

from spatial_alignment_tpu.models import core as jcore
from spatial_alignment_tpu_torch import VariationalGPSA
from spatial_alignment_tpu_torch.data import generate_twod_data
from spatial_alignment_tpu_torch.models.params import init_params
from spatial_alignment_tpu_torch.models.spec import build_spec, pack_batch, pack_coords

from conftest import make_two_view_data
from test_torch_model import _jit_value_and_grad, _rel, jax_noise, leaf, model_pair

# The suite runs in several worker processes on shared cores; PyTorch's
# default of one intra-op thread per core in each of them oversubscribes
# the machine and slows these tiny problems by orders of magnitude.
torch.set_num_threads(1)


@pytest.mark.parametrize("recipe", [None, "accurate"])
def test_five_adam_steps_match_optax(recipe):
    dd = make_two_view_data(n_per_view=24, n_outputs=3)
    jm, tm = model_pair(dd, m_X_per_view=8, m_G=8, n_latent_gps={"expression": 2},
                        fixed_view_idx=0)
    n, lr, S = 5, 1e-2, 2
    temp = 0.0 if recipe == "accurate" else 1.0
    sched = optax.cosine_decay_schedule(lr, n, alpha=1e-2) if recipe else lr
    tx = optax.adam(sched)
    params, state = jm.params, tx.init(jm.params)
    losses_j, noises = [], []
    for t in range(n):
        key = jax.random.PRNGKey(100 + t)
        loss, grads = _jit_value_and_grad(jm.spec, params, jm.consts, jm._batch, key, S, temp)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses_j.append(float(loss))
        noises.append(jax_noise(jm.spec, key, S))

    feed = iter(noises)
    tm._draw_noise = lambda S_: next(feed)
    losses_t = tm.fit(n_epochs=n, lr=lr, S=S, recipe=recipe)
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    for path, want in jax.tree_util.tree_flatten_with_path(params)[0]:
        got = leaf(tm.params, path).detach()
        assert _rel(got, want) <= 1e-4, (jax.tree_util.keystr(path), _rel(got, want))


def test_denovo_alignment_converges_quickly():
    """As tests/test_integration_alignment.py: the aligned error between the
    two views falls below a third of the unaligned error, in 800 steps at
    m = 16 (a few seconds on one CPU thread)."""
    X, Y, nsl, view_idx = generate_twod_data(
        2, 10, grid_size=8, kernel_variance=0.1, kernel_lengthscale=5.0,
        noise_variance=1e-3, fixed_view_idx=0, rng=np.random.default_rng(0),
    )
    X, Y = X.astype(np.float32), Y.astype(np.float32)
    dd = {"expression": {"spatial_coords": X, "outputs": Y, "n_samples_list": nsl}}
    model = VariationalGPSA(dd, m_X_per_view=16, m_G=16, n_latent_gps={"expression": None},
                            seed=0, device="cpu")
    losses = model.fit(n_epochs=800, lr=1e-2, S=3)
    G, _, _, _ = model.forward({"expression": X})
    err = lambda c: float(np.mean(np.sum((c[view_idx[0]] - c[view_idx[1]]) ** 2, axis=1)))
    assert np.isfinite(losses).all()
    assert err(G["expression"]) < err(X) / 3, (err(X), err(G["expression"]))


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dd = make_two_view_data(n_per_view=12, n_outputs=2)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        VariationalGPSA(dd, m_X_per_view=4, m_G=4)


def test_builders_default_to_the_card(monkeypatch):
    """init_params, pack_coords and pack_batch build on the GPU unless asked
    for the CPU: with no CUDA device and no device argument each raises."""
    dd = make_two_view_data(n_per_view=12, n_outputs=2)
    spec = build_spec(dd, m_X_per_view=4, m_G=4, fixed_view_idx=0)
    coords = {"expression": dd["expression"]["spatial_coords"]}
    builders = [lambda **kw: init_params(spec, dd, data_init=False, **kw)[0],
                lambda **kw: pack_coords(spec, coords, **kw),
                lambda **kw: pack_batch(spec, dd, **kw)["expression"]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in builders:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
        tree = build(device="cpu")
        assert all(t.device.type == "cpu" for t in tree.values() if isinstance(t, torch.Tensor))
        assert any(isinstance(t, torch.Tensor) for t in tree.values())


@pytest.mark.parametrize(
    "call",
    [lambda m, dd: VariationalGPSA(dd, m_X_per_view=4, m_G=4, device="cpu",
                                   triangular_variational=True),
     lambda m, dd: m.forward({"expression": np.zeros((24, 2), np.float32)}, G_test=object())],
    ids=["triangular_variational", "forward_G_test"],
)
def test_entry_points_outside_the_slice_raise(call):
    dd = make_two_view_data(n_per_view=12, n_outputs=2)
    model = VariationalGPSA(dd, m_X_per_view=4, m_G=4, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        call(model, dd)


def test_fit_average_last_and_callback():
    dd = make_two_view_data(n_per_view=12, n_outputs=2)
    model = VariationalGPSA(dd, m_X_per_view=4, m_G=4, device="cpu")
    seen = []
    losses = model.fit(n_epochs=20, print_every=10, average_last=10,
                       callback=lambda m, t, l: seen.append((t, len(l))))
    assert losses.shape == (20,) and np.isfinite(losses).all()
    assert seen == [(0, 10), (10, 20)]
    assert all(p.requires_grad and p.is_leaf for p in model.parameters())
