"""PyTorch port: the training step and loop, the optimizer factory,
checkpoints and exact resume, the convergence checkers and the profiling
switches, on the CPU against the JAX package where it has a counterpart.

On the CPU ``fit`` runs the same step as its CUDA graph does, eagerly, so
``make_train_step`` stepped n times equals ``fit(n)`` bit for bit, and a
resumed fit equals the uninterrupted one bit for bit (the Adam moments and
step, the generator's state and the epoch restored). The SGD factory is held
against ``optax.sgd`` on the JAX package's own noise at rel 1e-4 (loss and
parameters), as ``test_torch_fit.py`` holds Adam: float32 gradients that
differ at ~1e-5 move the updates by as much. A port checkpoint read by the
JAX package predicts within rel 1e-5 of the port (float32 predictions of two
libraries, as ``test_torch_model.py`` holds them).
"""


import jax
import numpy as np
import optax
import pytest
import torch

import spatial_alignment_tpu as sat
from spatial_alignment_tpu.utils import convergence as jconv
from spatial_alignment_tpu_torch import VariationalGPSA
from spatial_alignment_tpu_torch.models import core
from spatial_alignment_tpu_torch.models.train import CosineDecayAdam
from spatial_alignment_tpu_torch.models.train import resolve_recipe as _resolve_recipe
from spatial_alignment_tpu_torch.utils import checkpoint as ckpt
from spatial_alignment_tpu_torch.utils import convergence as tconv
from spatial_alignment_tpu_torch.utils import profiling

from conftest import make_two_view_data
from test_torch_model import _jit_value_and_grad, _rel, jax_noise, leaf, model_pair

# The suite runs in several worker processes on shared cores; PyTorch's
# default of one intra-op thread per core in each of them oversubscribes
# the machine and slows these tiny problems by orders of magnitude.
torch.set_num_threads(1)

KW = dict(m_X_per_view=6, m_G=6, n_latent_gps={"expression": 2}, fixed_view_idx=0)


def _model(**kw):
    return VariationalGPSA(make_two_view_data(n_per_view=12), device="cpu", **{**KW, **kw})


def _same_params(a, b) -> bool:
    fa, fb = ckpt.flatten(a.params), ckpt.flatten(b.params)
    return fa.keys() == fb.keys() and all(np.array_equal(fa[k], fb[k]) for k in fa)


@pytest.mark.parametrize("minibatch", [None, 8], ids=["full_batch", "minibatch"])
def test_make_train_step_equals_fit(minibatch):
    fitted, stepped = _model(), _model()
    losses = fitted.fit(n_epochs=5, S=2, minibatch_size=minibatch)
    step, opt = stepped.make_train_step(S=2, minibatch_size=minibatch)
    want = [float(step()) for _ in range(5)]
    assert isinstance(opt, torch.optim.Adam)
    np.testing.assert_array_equal(losses, want)
    assert _same_params(fitted, stepped)


def test_make_train_step_applies_the_factory_schedule():
    """make_train_step writes a factory's lr_schedule into its learning rate
    before each step, as fit() does: n steps under CosineDecayAdam(lr, n) at
    the recipe's temperature 0 equal fit(n, recipe="accurate") bit for bit."""
    fitted, stepped = _model(), _model()
    n = 6
    want = fitted.fit(n_epochs=n, S=2, recipe="accurate")
    step, opt = stepped.make_train_step(S=2, optimizer=CosineDecayAdam(1e-2, n))
    got = [float(step(0.0)) for _ in range(n)]
    np.testing.assert_array_equal(got, want)
    assert _same_params(fitted, stepped)
    assert float(opt.param_groups[0]["lr"]) == CosineDecayAdam(1e-2, n).lr_schedule(n - 1)


def test_make_train_step_schedule_matches_optax():
    """Against the JAX package's make_train_step under
    optax.adam(optax.cosine_decay_schedule(lr, n, alpha=1e-2)), whose
    schedule advances with the optimizer state's count, on the JAX
    package's own noise: losses and parameters rel 1e-4, as
    test_five_adam_steps_match_optax holds fit()."""
    dd = make_two_view_data(n_per_view=24, n_outputs=3)
    jm, tm = model_pair(dd, m_X_per_view=8, m_G=8, n_latent_gps={"expression": 2},
                        fixed_view_idx=0)
    n, lr, S = 5, 1e-2, 2
    jstep, state = jm.make_train_step(
        lr=lr, S=S, optimizer=optax.adam(optax.cosine_decay_schedule(lr, n, alpha=1e-2)))
    params, losses_j, noises = jm.params, [], []
    for t in range(n):
        key = jax.random.PRNGKey(100 + t)
        params, state, loss = jstep(params, state, key)
        losses_j.append(float(loss))
        noises.append(jax_noise(jm.spec, key, S))
    feed = iter(noises)
    tm._draw_noise = lambda S_: next(feed)
    step, _ = tm.make_train_step(lr=lr, S=S, optimizer=CosineDecayAdam(lr, n))
    np.testing.assert_allclose([float(step()) for _ in range(n)], losses_j, rtol=1e-4)
    for path, want in jax.tree_util.tree_flatten_with_path(params)[0]:
        got = leaf(tm.params, path).detach()
        assert _rel(got, want) <= 1e-4, (jax.tree_util.keystr(path), _rel(got, want))


@pytest.mark.parametrize("temp", [1.0, 0.37, 0.0])
def test_tensor_temperature_gives_the_float_loss(temp):
    model = _model()
    loss = lambda t: core.negative_elbo(
        model.spec, model.params, model.consts, model._batch, 3, t,
        generator=torch.Generator().manual_seed(5),
    )
    want = loss(temp)
    got = loss(torch.tensor(temp, dtype=torch.float32))
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["plain", "accurate", "minibatch"])
def test_resume_is_bit_for_bit(tmp_path, mode):
    """fit(2n) == fit(n), save, VariationalGPSA.load, fit(n, resume_from=)."""
    kw = {"recipe": "accurate"} if mode == "accurate" else {}
    if mode == "minibatch":
        kw["minibatch_size"] = 8
    n = 4
    ref = _model()
    full = ref.fit(n_epochs=2 * n, S=2, **kw)
    first = _model()
    # The first segment of an interrupted 2n-step recipe fit runs the
    # recipe's 2n-step horizon, as in the JAX package's test.
    opt, temps = _resolve_recipe(kw.get("recipe"), 1e-2, 2 * n, None, None)
    head = first.fit(n_epochs=n, S=2, optimizer=opt, warp_temperature_schedule=temps,
                     minibatch_size=kw.get("minibatch_size"))
    path = str(tmp_path / "mid.npz")
    first.save(path)
    resumed = VariationalGPSA.load(path, device="cpu")
    assert resumed._epoch == n
    tail = resumed.fit(n_epochs=n, S=2, resume_from=path, **kw)
    np.testing.assert_array_equal(np.concatenate([head, tail]), full)
    assert _same_params(resumed, ref)
    assert resumed._epoch == 2 * n


@pytest.mark.parametrize("how", ["average_last", "include_opt_false"])
def test_checkpoint_without_optimizer_state_refuses_resume(tmp_path, how):
    model = _model()
    model.fit(n_epochs=6, S=2, average_last=3 if how == "average_last" else None)
    path = str(tmp_path / "x.npz")
    model.save(path, include_opt=how != "include_opt_false")
    with pytest.raises(ValueError, match="no optimizer state"):
        _model().fit(n_epochs=2, S=2, resume_from=path)


def test_sgd_factory_matches_optax_sgd():
    dd = make_two_view_data(n_per_view=12, n_outputs=3)
    jm, tm = model_pair(dd, **KW)
    n, lr, S = 5, 1e-3, 2
    tx = optax.sgd(lr)
    params, state = jm.params, tx.init(jm.params)
    losses_j, noises = [], []
    for t in range(n):
        key = jax.random.PRNGKey(200 + t)
        loss, grads = _jit_value_and_grad(jm.spec, params, jm.consts, jm._batch, key, S, 1.0)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses_j.append(float(loss))
        noises.append(jax_noise(jm.spec, key, S))

    feed = iter(noises)
    tm._draw_noise = lambda S_: next(feed)
    losses_t = tm.fit(n_epochs=n, S=S, optimizer=lambda p: torch.optim.SGD(p, lr))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    for path, want in jax.tree_util.tree_flatten_with_path(params)[0]:
        got = leaf(tm.params, path).detach()
        assert _rel(got, want) <= 1e-4, (jax.tree_util.keystr(path), _rel(got, want))


def test_port_checkpoint_predicts_in_the_jax_package(tmp_path):
    dd = make_two_view_data(n_per_view=12, n_outputs=3)
    tm = VariationalGPSA(dd, device="cpu", **KW)
    tm.fit(n_epochs=3, S=2)
    path = str(tmp_path / "port.npz")
    tm.save(path)
    jm = sat.VariationalGPSA.load(path)
    assert jm._epoch == 3
    X = {"expression": dd["expression"]["spatial_coords"]}
    for got, want in zip(tm.predict(X), jm.predict(X)):
        assert _rel(got["expression"], want["expression"]) <= 1e-5


def test_jax_checkpoint_reads_through_the_port(tmp_path):
    dd = make_two_view_data(n_per_view=12, n_outputs=3)
    jm = sat.VariationalGPSA(dd, **KW)
    path = str(tmp_path / "jax.npz")
    jm.save(path, step=7)
    blob = ckpt.load_checkpoint_blob(path)
    assert blob["manifest"]["step"] == 7 and blob["torch_opt"] == {}
    tm = VariationalGPSA.load(path, device="cpu")
    params, consts = ckpt.load_checkpoint(path, tm.params, tm.consts)
    for p, want in jax.tree_util.tree_flatten_with_path(jm.params)[0]:
        np.testing.assert_array_equal(leaf(tm.params, p).detach().numpy(), np.asarray(want))
        np.testing.assert_array_equal(leaf(params, p).numpy(), np.asarray(want))
    for p, want in jax.tree_util.tree_flatten_with_path(jm.consts)[0]:
        np.testing.assert_array_equal(leaf(consts, p).numpy(), np.asarray(want))
    # The instance form copies into the model's own tensors.
    other = _model()
    before = other.parameters()
    other.load(path)
    assert all(a is b for a, b in zip(before, other.parameters()))
    assert _same_params(other, tm) and other._epoch == 7


def test_recipe_learning_rates_are_the_schedulers():
    """The learning rate each step of fit(recipe="accurate") ran at is
    CosineAnnealingLR's after that many steps (T_max = n, eta_min lr/100)."""
    n, lr = 6, 1e-2
    seen = []

    class Recording(CosineDecayAdam):
        def __call__(self, params):
            opt = super().__call__(params)
            step = opt.step
            opt.step = lambda *a, **k: (seen.append(float(opt.param_groups[0]["lr"])),
                                        step(*a, **k))[1]
            return opt

    _model().fit(n_epochs=n, S=2, optimizer=Recording(lr, n))
    ref = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=lr)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(ref, T_max=n, eta_min=lr / 100)
    want = []
    for _ in range(n):
        want.append(np.float32(ref.param_groups[0]["lr"]))
        ref.step()
        sched.step()
    # The first recorded step is the loop's priming step on zero gradients.
    np.testing.assert_array_equal(np.float32(seen[1:]), want)


def test_each_fit_starts_a_fresh_optimizer_state_on_the_cached_loop():
    a, b = _model(), _model()
    a.fit(n_epochs=3, S=2)
    loop = a._train_loop_cache["loop"]
    second = a.fit(n_epochs=3, S=2)
    assert a._train_loop_cache["loop"] is loop
    b.fit(n_epochs=3, S=2)
    step, _ = b.make_train_step(S=2)  # a fresh Adam from the same point
    np.testing.assert_array_equal(second, [float(step()) for _ in range(3)])
    a.fit(n_epochs=4, S=2, average_last=2)  # rebinds the params: a new loop next time
    a.fit(n_epochs=1, S=2)
    assert a._train_loop_cache["loop"] is not loop


# Factories whose fresh state fit() restores in place (the values each state
# tensor was first stored with: zeros, NAdam's mu_product of 1, Rprop's step
# sizes, Adagrad's accumulators); each is one object, so that a second fit()
# reuses its cached loop.
RESETTABLE_FACTORIES = {
    "adam_amsgrad": lambda p: torch.optim.Adam(p, lr=1e-2, amsgrad=True),
    "adamw": lambda p: torch.optim.AdamW(p, lr=1e-2),
    "adamax": lambda p: torch.optim.Adamax(p, lr=1e-2),
    "rmsprop_centered_momentum": lambda p: torch.optim.RMSprop(p, lr=1e-3, momentum=0.9,
                                                               centered=True),
    "adadelta": lambda p: torch.optim.Adadelta(p, lr=1.0),
    "sgd_momentum": lambda p: torch.optim.SGD(p, lr=1e-4, momentum=0.9),
    "sgd_nesterov": lambda p: torch.optim.SGD(p, lr=1e-4, momentum=0.9, nesterov=True),
    "nadam": lambda p: torch.optim.NAdam(p, lr=1e-2),
    "radam": lambda p: torch.optim.RAdam(p, lr=1e-2),
    "adagrad": lambda p: torch.optim.Adagrad(p, lr=1e-2, initial_accumulator_value=0.1),
    "asgd": lambda p: torch.optim.ASGD(p, lr=1e-2),
    "rprop": lambda p: torch.optim.Rprop(p, lr=1e-2),
}


@pytest.mark.parametrize("name", sorted(RESETTABLE_FACTORIES))
def test_each_fit_equals_steps_of_a_new_optimizer(name):
    """Two fit() calls on one cached loop (its state reset in place) against
    make_train_step with a new optimizer each time, bit for bit."""
    factory = RESETTABLE_FACTORIES[name]
    fitted, stepped = _model(), _model()
    got = [fitted.fit(n_epochs=3, S=2, optimizer=factory) for _ in range(2)]
    want = []
    for _ in range(2):
        step, _ = stepped.make_train_step(S=2, optimizer=factory)
        want.append([float(step()) for _ in range(3)])
    np.testing.assert_array_equal(got, want)
    assert _same_params(fitted, stepped)


@pytest.mark.parametrize("name,factory", [
    ("SGD with dampening", lambda p: torch.optim.SGD(p, lr=1e-4, momentum=0.9, dampening=0.5)),
    ("LBFGS", lambda p: torch.optim.LBFGS(p, lr=1e-2)),
], ids=["sgd_dampening", "lbfgs"])
def test_optimizer_without_a_zero_fresh_state_refuses(name, factory):
    """fit() could not reset these in place to the state a new one starts
    from (a damped SGD's missing momentum buffer is not a zero one; LBFGS
    is not elementwise), so it names them and refuses rather than train
    otherwise."""
    with pytest.raises(ValueError, match=f"not for {name}"):
        _model().fit(n_epochs=2, S=2, optimizer=factory)


def test_recipe_fits_of_other_horizons_share_one_loop():
    """The loop of fit(recipe="accurate") serves a later recipe fit of
    another length (the graph reads the learning rate each step); that fit
    runs its own horizon's schedule, as one on a new loop does."""
    a, b = _model(), _model()
    a.fit(n_epochs=3, S=2, recipe="accurate")
    loop = a._train_loop_cache["loop"]
    got = a.fit(n_epochs=5, S=2, recipe="accurate")
    assert a._train_loop_cache["loop"] is loop
    b.fit(n_epochs=3, S=2, recipe="accurate")
    b.__dict__.pop("_train_loop_cache")
    np.testing.assert_array_equal(got, b.fit(n_epochs=5, S=2, recipe="accurate"))


def test_attach_data_restores_training(tmp_path):
    dd = make_two_view_data(n_per_view=12, n_outputs=3)
    path = str(tmp_path / "nodata.npz")
    VariationalGPSA(dd, device="cpu", **KW).save(path, include_data=False)
    model = VariationalGPSA.load(path, device="cpu")
    with pytest.raises(RuntimeError, match="attach_data"):
        model.fit(n_epochs=1)
    bad = {"expression": {**dd["expression"], "n_samples_list": [10, 14]}}
    with pytest.raises(ValueError, match="n_samples_list"):
        model.attach_data(bad)
    assert np.isfinite(model.attach_data(dd).fit(n_epochs=2, S=2)).all()


@pytest.mark.parametrize("checker", ["convergence", "loss_not_decreasing"])
def test_convergence_checkers_match_jax(checker):
    rng = np.random.default_rng(3)
    trace = 100.0 * np.exp(-np.arange(120) / 30.0) + rng.normal(0.0, 0.05, 120)
    if checker == "convergence":
        for span in (4, 10, 25):
            got, want = tconv.ConvergenceChecker(span), jconv.ConvergenceChecker(span)
            np.testing.assert_array_equal(got.relative_change_all(trace),
                                          want.relative_change_all(trace))
            np.testing.assert_array_equal(got.converged_all(trace, tol=1e-3),
                                          want.converged_all(trace, tol=1e-3))
            assert got.converged(trace) == want.converged(trace)
    else:
        got, want = (mod.LossNotDecreasingChecker(120, atol=0.5, window_size=8)
                     for mod in (tconv, jconv))
        assert [got(i, trace) for i in range(120)] == [want(i, trace) for i in range(120)]
        np.testing.assert_array_equal(got.average_decrease_in_loss,
                                      want.average_decrease_in_loss)


def test_fit_stops_on_the_ported_convergence_checker():
    checker = tconv.LossNotDecreasingChecker(200, atol=1e9, window_size=4)
    losses = _model().fit(n_epochs=200, S=2, convergence_checker=checker)
    assert len(losses) == 10  # the first chunk end past the window


def test_profiling_switches(tmp_path):
    timer = profiling.StepTimer(warmup=1)
    for _ in range(3):
        with timer.lap():
            torch.ones(8).sum()
    assert timer.n == 2 and timer.steps_per_sec > 0
    with profiling.trace(str(tmp_path)):
        torch.ones(8).sum()
    assert (tmp_path / "trace.json").is_file()
    profiling.enable_debug()
    try:
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
    finally:
        profiling.enable_debug(False)
    assert not torch.is_anomaly_enabled()
