"""PyTorch port: ``parallel/`` on ``torch.distributed``, in gloo worlds on
the CPU, against one process and against the JAX package.

Counterparts of the 25 tests of ``tests/test_sharding.py``. One world of
four processes runs once for the module (``tests/torch_parallel_worker.py``,
a file store, one thread a process, no JAX), first on a 4 x 1 (data) mesh,
then on a 2 x 2 (data, model) mesh. It writes what it computed to ``.npz``
files and the tests compare; the references here are computed while it
runs. The JAX side runs here, single-device, its Monte-Carlo
normals handed to the workers (the port's injected-noise hooks), so both
packages see one set of draws. A world of one (this process, gloo) holds the
distributed fit bit for bit against the plain fit.

Tolerances: JAX's own for the same comparisons (``tests/test_sharding.py``):
the ELBO rel 1e-5, a step's loss rel 2e-4 and its parameters rtol 5e-3
(atol 1e-5), gradients rtol 5e-3 with JAX's atol. Against the one-process
port the distributed path holds tighter, where it holds: the loss rel 1e-6,
gradients rel 2e-4 a leaf (max-norm: the data lengthscale's gradient, a
sum over points with cancellation, moves 5e-5 when the points are summed in
four blocks), a 30-step fit's losses rel 1e-5, restarts rel
1e-6 (their draws are the one-process draws; a narrower restart vmap rounds
its batched products differently, so not bit for bit), and the replicated
leaves bit-equal across ranks.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import spatial_alignment_tpu as sat

import spatial_alignment_tpu_torch.parallel as tpar
from spatial_alignment_tpu_torch import VariationalGPSA, ops
from spatial_alignment_tpu_torch.models import core as tcore
from spatial_alignment_tpu_torch.models._trees import named_leaves

from test_torch_model import _jit_value_and_grad, _rel, jax_noise
import torch_parallel_worker as W

torch.set_num_threads(1)

_HERE = os.path.dirname(os.path.abspath(__file__))
_KEYS = {"elbo": 11, "whitened": 9, "lmc2d": 1, "nolmc2d": 7}  # JAX keys of the draws
_SHARDED = ("Omega_sqt_F/", "delta_F/", "W/")


def _jax_model(case):
    """The JAX model of ``case`` holding the port's initial parameters (the
    inducing points come from each package's own k-means)."""
    data_kw, kw, _, _ = W.CASES[case]
    jm = sat.VariationalGPSA(W.two_view_data(**data_kw), **{"seed": 0, **kw})
    tm = W.build(case)
    flat = {p: t.detach().numpy() for p, t in named_leaves(tm.params)}
    jm.params = jax.tree_util.tree_map_with_path(
        lambda path, _: jnp.asarray(flat["/".join(k.key for k in path)]), jm.params)
    return jm


class _Worlds:
    """The world, started at construction; ``load(mesh)`` waits for it and
    returns each rank's results on that mesh."""

    def __init__(self, out):
        self.out, self._res = out, None
        self.jax = {case: _jax_model(case) for case in _KEYS}
        inputs = {}
        for case, key in _KEYS.items():
            warp, data = jax_noise(self.jax[case].spec, jax.random.PRNGKey(key), W.CASES[case][3])
            inputs[f"{case}/warp"] = warp.numpy()
            inputs[f"{case}/data"] = data["expression"].numpy()
        np.savez(os.path.join(out, "inputs.npz"), **inputs)
        # A JAX checkpoint of a model whose spec clears merged_factor_dispatch,
        # as the JAX package's model-sharded models save it.
        jm = self.jax["lmc2d"]
        saved_spec = jm.spec
        jm.spec = jm.spec.replace(merged_factor_dispatch=False)
        jm.save(os.path.join(out, "jax_unmerged.npz"))
        jm.spec = saved_spec
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        self.procs = [
            subprocess.Popen([sys.executable, os.path.join(_HERE, "torch_parallel_worker.py"),
                              str(r), str(W.WORLD), out], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(W.WORLD)
        ]

    def load(self, world):
        if self._res is None:
            logs = []
            for p in self.procs:
                try:
                    logs.append(p.communicate(timeout=300)[0])
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    raise
            self._res = {}
            for name in W.MESHES:
                ranks = []
                for r in range(W.WORLD):
                    path = os.path.join(self.out, f"{name}_{r}.npz")
                    assert os.path.exists(path), "\n".join(logs)
                    d = dict(np.load(path))
                    assert "error" not in d, str(d.get("error"))
                    ranks.append(d)
                self._res[name] = ranks
        return self._res[world]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = _Worlds(str(tmp_path_factory.mktemp("worlds")))
    yield w
    for p in w.procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def jax_grads(worlds):
    """{case: (loss, {leaf path: grad})} of the JAX package at the draws the
    workers were given; computed while the worlds run."""
    out = {}
    for case, key in _KEYS.items():
        jm = worlds.jax[case]
        loss, grads = _jit_value_and_grad(jm.spec, jm.params, jm.consts, jm._batch,
                                          jax.random.PRNGKey(key), W.CASES[case][3], 1.0)
        flat = {"/".join(k.key for k in path): np.asarray(g)
                for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
        out[case] = (float(loss), flat)
    return out


def _one_process(worlds, case):
    """The one-process port's loss and gradients at the workers' draws."""
    model = W.build(case)
    warp, data = W.injected(np.load(os.path.join(worlds.out, "inputs.npz")), case)
    loss = tcore.negative_elbo(model.spec, model.params, model.consts, model._batch,
                               W.CASES[case][3], warp_noise=warp, data_noise=data)
    loss.backward()
    return loss.item(), {p: t.grad.numpy() for p, t in named_leaves(model.params)}


@pytest.fixture(scope="module")
def one(worlds):
    """The one-process port's results the tests compare with, computed
    while the world runs."""
    out = {case: _one_process(worlds, case) for case in (*_KEYS, "analytic2d", "quad")}
    model = W.build("elbo")
    model._gen.manual_seed(21)
    step, _ = model.make_train_step(lr=1e-2, S=3)
    out["step"] = (step().item(), {p: t.detach().numpy() for p, t in named_leaves(model.params)})
    model = W.build("fit")
    out["fit"] = (model.fit(n_epochs=W.FIT_STEPS, lr=1e-2, S=2, chunk_size=10),
                  model.predict(_coords("fit"))[0]["expression"])
    out["fit2d"] = W.build("fit2d").fit(n_epochs=W.FIT2D_STEPS, lr=1e-2, S=2)
    data, _ = W.converge_data()
    model = VariationalGPSA(data, device="cpu", seed=0, **W.CONVERGE_KW)
    out["converge"] = (model.fit(n_epochs=W.CONVERGE_STEPS, lr=1e-2, S=3),
                       model.predict({"expression": data["expression"]["spatial_coords"]})[0][
                           "expression"])
    for case in ("mb", "mbpad"):
        model = W.build(case)
        gen = torch.Generator().manual_seed(10_000)
        with torch.no_grad():
            out[f"draws/{case}"] = np.array(
                [tcore.negative_elbo(model.spec, model.params, model.consts, model._batch, 1,
                                     generator=gen).item() for _ in range(W.MB_DRAWS)])
    model = W.build("restarts")
    params_R, losses_RT = model._fit_restarts_vectorized(n_epochs=10, n_restarts=4, seed0=0, S=2)
    out["restarts"] = ({p: t.detach().numpy().copy() for p, t in named_leaves(params_R)},
                       losses_RT)
    out["restarts3"] = model._fit_restarts_vectorized(n_epochs=8, n_restarts=3, seed0=0, S=2)[1]
    losses = model.fit_multistart(n_epochs=60, n_restarts=4, S=2, verbose=False, vectorized=True)
    out["multistart"] = (losses, model.multistart_winner_["restart"],
                         model.predict(_coords("restarts"))[0]["expression"])
    return out


def _coords(case):
    return {"expression": W.two_view_data(**W.CASES[case][0])["expression"]["spatial_coords"]}


@pytest.fixture(scope="module")
def res(worlds, jax_grads, one):
    return {name: worlds.load(name) for name in W.MESHES}


def _jax_step(jm, grads):
    """One ``optax.adam(1e-2)`` step of the JAX model from its gradients:
    from a fresh state Adam's bias-corrected moments are g and g^2, so the
    step is p - lr g / (|g| + eps), optax's eps 1e-8."""
    flat = {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jm.params)[0]}
    return {p: v - np.float32(1e-2) * grads[p] / (np.abs(grads[p]) + np.float32(1e-8))
            for p, v in flat.items()}


def _check_jax_grads(got, want):
    for path, b in want.items():
        a = got[path]
        atol = 1e-4 * (1.0 + np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=atol, err_msg=path)


# ---------------------------------------------------------------------------
# worlds and layouts
# ---------------------------------------------------------------------------


def test_gloo_world_of_four_forms(res):
    data, grid = res["data"], res["grid"]
    assert [int(r["world_size"]) for r in data] == [4] * 4
    assert [list(r["mesh_shape"]) for r in data] == [[4, 1]] * 4
    assert [int(r["data_rank"]) for r in data] == [0, 1, 2, 3]
    assert [int(r["lmc2d/local_L"]) for r in grid] == [2] * 4  # L = 4 on 2 model ranks


def test_pad_multiple_mismatch_raises(res):
    assert "pad_multiple=4" in str(res["data"][0]["pad_error"])


def test_make_mesh_without_a_group_names_torchrun(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        tpar.make_mesh(devices="cpu")


def test_placements_follow_jax_rules():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:  # the two methods the placement rules read
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return (2, 2)[i]

    model = W.build("lmc2d")
    sh = tpar.param_shardings(model.spec, model.params, Mesh())
    assert sh["Omega_sqt_F"]["expression"] == (Replicate(), Shard(0))
    assert sh["delta_F"]["expression"] == (Replicate(), Shard(1))
    assert sh["W"]["expression"] == (Replicate(), Shard(0))
    assert sh["Xtilde"] == (Replicate(), Replicate())
    b = tpar.batch_shardings(model.spec, Mesh())["expression"]
    assert b == {k: (Shard(1), Replicate()) for k in ("coords", "outputs", "mask")}


# ---------------------------------------------------------------------------
# the ELBO and its gradients
# ---------------------------------------------------------------------------


def test_sharded_elbo_matches_single_device(res, one, jax_grads):
    """The model's route (fit's loss) on the 4 x 1 mesh at JAX's draws."""
    loss, _ = one["elbo"]
    got = [float(r["elbo/model_loss"]) for r in res["data"]]
    assert len(set(got)) == 1
    assert _rel(got[0], loss) <= 1e-6
    assert _rel(got[0], jax_grads["elbo"][0]) <= 1e-5


def test_shardmap_elbo_bit_identical_to_single_device(res, one, jax_grads):
    """The executor's ELBO equals the model route's bit for bit, the one
    process's at 1e-6 and JAX's at 1e-5."""
    r0 = res["data"][0]
    assert float(r0["elbo/loss"]) == float(r0["elbo/model_loss"])
    assert _rel(r0["elbo/loss"], one["elbo"][0]) <= 1e-6
    assert _rel(r0["elbo/loss"], jax_grads["elbo"][0]) <= 1e-5


@pytest.mark.parametrize("world,case", [("data", "elbo"), ("grid", "lmc2d"),
                                        ("grid", "nolmc2d"), ("data", "quad")])
def test_sharded_grads_match_single_device(res, one, jax_grads, world, case):
    """Every leaf's gradient, model-sharded leaves gathered, against the one
    process (rel 2e-4) and JAX (rtol 5e-3, JAX's atol); each rank's
    replicated gradients equal bit for bit. ``quad`` is elbo's model with
    quad_diag_impl="pallas", held against JAX's elbo model."""
    ranks = res[world]
    _, want = one[case]
    got = {p: ranks[0][f"{case}/grad/{p}"] for p in want}
    for p in want:
        assert _rel(got[p], want[p]) <= 2e-4, (p, _rel(got[p], want[p]))
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"{case}/grad/{p}"], got[p])
    _check_jax_grads(got, jax_grads[W.NOISE.get(case, case)][1])


def test_distribute_keeps_the_quad_kernel_opt_in(res, one, jax_grads):
    """distribute keeps quad_diag_impl="pallas" (the JAX package sets "xla":
    its partitioner would gather the rows around the Pallas call; here each
    rank runs the kernel on its own rows): on the 4 x 1 mesh the executor's
    loss is the one-process opt-in model's (rel 1e-6) and JAX's (1e-5)."""
    for r in res["data"]:
        assert str(r["quad/impl"]) == "pallas"
        assert _rel(r["quad/loss"], one["quad"][0]) <= 1e-6
        assert _rel(r["quad/loss"], jax_grads["elbo"][0]) <= 1e-5


def test_model_axis_sharding_lmc(res, one, jax_grads):
    """2 x 2 mesh, L = 4 latent GPs over 2 model ranks: the ELBO."""
    got = [float(r["lmc2d/loss"]) for r in res["grid"]]
    assert len(set(got)) == 1
    assert _rel(got[0], one["lmc2d"][0]) <= 1e-6
    assert _rel(got[0], jax_grads["lmc2d"][0]) <= 1e-5
    assert not res["grid"][0]["lmc2d/merged"]


def test_jax_unmerged_checkpoint_distributes(res, jax_grads):
    """A JAX package checkpoint whose spec clears merged_factor_dispatch,
    read by load_jax_checkpoint and distributed on the 2 x 2 mesh: JAX's
    loss at JAX's draws (rel 1e-5)."""
    for r in res["grid"]:
        assert not r["convert/merged"]
        assert _rel(r["convert/loss"], jax_grads["lmc2d"][0]) <= 1e-5


def test_shardmap_elbo_on_2d_mesh(res, one, jax_grads):
    """Without LMC the model axis shards the output channels themselves."""
    got = float(res["grid"][0]["nolmc2d/loss"])
    assert _rel(got, one["nolmc2d"][0]) <= 1e-6
    assert _rel(got, jax_grads["nolmc2d"][0]) <= 1e-5


def test_analytic_likelihood_on_2d_mesh(res, one):
    """analytic_data_likelihood on the 2 x 2 mesh (L = 4 over 2 model ranks;
    the observed moments' mean and variance summed over the model axis):
    the loss at rel 1e-6 and every gradient at rel 2e-4 of one process's."""
    loss, want = one["analytic2d"]
    for r in res["grid"]:
        assert _rel(r["analytic2d/loss"], loss) <= 1e-6
        for p, w in want.items():
            assert _rel(r[f"analytic2d/grad/{p}"], w) <= 2e-4, p


def test_model_sharded_grads_finite_including_fixed_view(res):
    """The fixed view's dead lanes get exactly zero gradients on the 2 x 2
    mesh (merged_factor_dispatch cleared), every gradient finite."""
    for r in res["grid"]:
        for case in ("lmc2d", "nolmc2d"):
            grads = {k: v for k, v in r.items() if k.startswith(f"{case}/grad/")}
            assert all(np.isfinite(v).all() for v in grads.values())
            np.testing.assert_array_equal(grads[f"{case}/grad/Xtilde"][0], 0.0)
            np.testing.assert_array_equal(grads[f"{case}/grad/warp_kernel_lengthscales"][0], 0.0)
    assert W.build("lmc2d").spec.merged_factor_dispatch  # one process keeps the merge


# ---------------------------------------------------------------------------
# steps and fits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["elbo", "whitened"])
def test_sharded_training_step_runs_and_matches(res, worlds, jax_grads, case):
    """One make_train_step step on the 4 x 1 mesh at JAX's draws against
    JAX's step (loss 2e-4, parameters rtol 5e-3 / atol 1e-5)."""
    r0 = res["data"][0]
    jm = worlds.jax[case]
    if case not in jax_grads:
        pytest.fail(case)
    loss, grads = jax_grads[case]
    assert _rel(r0[f"{case}/step_loss"], loss) <= 2e-4
    want = _jax_step(jm, grads)
    for p, w in want.items():
        np.testing.assert_allclose(r0[f"{case}/step_params/{p}"], w, rtol=5e-3, atol=1e-5,
                                   err_msg=p)


def test_shardmap_train_step_matches_single_device_step(res, one):
    """make_shardmap_train_step's step from a generator seeded 21 against
    the one-process make_train_step from the same generator state."""
    loss, params = one["step"]
    r0 = res["data"][0]
    assert _rel(r0["elbo/shardmap_step_loss"], loss) <= 1e-6
    for p, v in params.items():
        assert _rel(r0[f"elbo/shardmap_step_params/{p}"], v) <= 1e-5, p


def test_distributed_aligned_coords_match_single_device(res, one):
    """fit() of 30 steps on the 4 x 1 mesh, then predict and forward: the
    losses at rel 1e-5 of one process's, the aligned coordinates within
    1e-4; distribute() dropped the loop fit() had cached before it."""
    r0 = res["data"][0]
    assert r0["fit/cache_dropped"]
    losses, G = one["fit"]
    assert _rel(r0["fit/losses"], losses) <= 1e-5
    np.testing.assert_allclose(r0["fit/G"], G, atol=1e-4, rtol=0)
    for r in res["data"]:
        np.testing.assert_array_equal(r["fit/G"], r0["fit/G"])
        np.testing.assert_array_equal(r["fit/forward_G"], r0["fit/forward_G"])


def test_distributed_fit_end_to_end_matches_single_device(res, one):
    """fit() on the 2 x 2 mesh (LMC, L = 2 over 2 model ranks) tracks the
    one-process fit step for step (rel 1e-3; JAX compares 5 % tails)."""
    losses = one["fit2d"]
    got = res["grid"][0]["fit2d/losses"]
    assert np.isfinite(got).all()
    assert (np.abs(got - losses) / np.maximum(np.abs(losses), 1.0)).max() <= 1e-3
    assert np.isfinite(res["grid"][0]["fit2d/forward_G"]).all()
    assert res["grid"][0]["fit2d/forward_G"].shape == _coords("fit2d")["expression"].shape


@pytest.mark.parametrize("world,prefix", [("data", "fit/params/"), ("grid", "fit2d/params/")])
def test_replicated_leaves_bit_equal_across_ranks(res, world, prefix):
    """After training, every replicated leaf is the same on every rank, and
    each model rank holds its own latents of the sharded ones."""
    ranks = res[world]
    for key, value in ranks[0].items():
        if not key.startswith(prefix):
            continue
        sharded = key[len(prefix):].startswith(_SHARDED) and world == "grid"
        for r in ranks[1:]:
            if not sharded:
                np.testing.assert_array_equal(r[key], value, err_msg=key)
    if world == "grid":  # rank 1 is (data 0, model 1): other latents, rank 2 the same as 0
        key = prefix + "delta_F/expression"
        assert not np.array_equal(ranks[1][key], ranks[0][key])
        np.testing.assert_array_equal(ranks[2][key], ranks[0][key])


def test_sharded_fit_to_convergence_matches_single_device(res, one):
    """200 steps on the 2 x 2 mesh on the 8 x 8 grid pair: losses fall and
    the aligned error is within 5 % of the one-process fit's."""
    _, view_idx = W.converge_data()
    losses, G = one["converge"]
    got = res["grid"][0]["converge/losses"]
    assert got[-20:].mean() < got[:20].mean()
    err = lambda G: float(np.mean(np.sum((G[view_idx[0]] - G[view_idx[1]]) ** 2, axis=1)))
    e_single = err(G)
    e_dist = err(res["grid"][0]["converge/G"])
    assert abs(e_dist - e_single) <= 0.05 * e_single, (e_dist, e_single)
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("world,prefix", [("data", "ckpt"), ("grid", "ckpt2d")])
def test_distributed_checkpoint_roundtrip_exact(res, world, prefix):
    """fit(14) against fit(7) + save (rank 0, gathered) + load + distribute
    + fit(7, resume_from=): losses and parameters bit for bit, on the 4 x 1
    mesh and on the 2 x 2 one (the LMC latents and their Adam state cut
    per model rank)."""
    for r in res[world]:
        np.testing.assert_array_equal(np.concatenate([r[f"{prefix}/a"], r[f"{prefix}/b"]]),
                                      r[f"{prefix}/full"])
        assert r[f"{prefix}/params_equal"]


# ---------------------------------------------------------------------------
# stratified minibatch SVI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["mb", "mbpad"])
def test_shardmap_minibatch_unbiased(res, one, case):
    """The stratified estimator's mean over 200 draws matches the full-batch
    ELBO's (4 standard errors); ``mbpad`` is 10 real points a view padded
    to 16 on 4 shards (4, 4, 2, 0: the last shard all padding), whose
    gradients stay finite."""
    mb = res["data"][0][f"{case}/draws"]
    full = one[f"draws/{case}"]
    se = np.sqrt(mb.var(ddof=1) / len(mb) + full.var(ddof=1) / len(full))
    assert abs(mb.mean() - full.mean()) < 4.0 * se + 1e-6
    assert all(r[f"{case}/grads_finite"] for r in res["data"])
    if case == "mbpad":
        assert [float(r["mbpad/local_real"]) for r in res["data"]] == [8.0, 8.0, 4.0, 0.0]


def test_shardmap_minibatch_training_improves_elbo(res):
    r0 = res["data"][0]
    assert np.isfinite(r0["mbtrain/last"])
    assert r0["mbtrain/e1"] < r0["mbtrain/e0"] - 1.0


def test_distributed_fit_minibatch_runs_and_improves(res):
    r0 = res["data"][0]
    assert np.isfinite(r0["mbfit/losses"]).all()
    assert r0["mbfit/e1"] < r0["mbfit/e0"] - 1.0


def test_pjit_distribute_composes_with_minibatch(res):
    assert all(np.isfinite(r["mbstep/loss"]) for r in res["data"])


def test_distributed_minibatch_step_has_no_cross_shard_gather(res):
    """A minibatch step issues exactly two all-reduces over the world, the
    loss terms (3 float32) and the replicated gradients (every parameter on
    the 4 x 1 mesh), and nothing else: no all-gather, no barrier."""
    for r in res["data"]:
        counts = {k.split("collectives.")[1]: int(v) for k, v in r.items()
                  if k.startswith("mbstep/counts/")}
        assert counts.pop("all_reduce_world_calls") == 2
        assert counts.pop("all_reduce_world_bytes") == 12 + int(r["mbstep/replicated_bytes"])
        assert not any(counts.values()), counts


# ---------------------------------------------------------------------------
# restarts over ranks
# ---------------------------------------------------------------------------


def test_multistart_restarts_over_devices_matches_single(res, one):
    """4 restarts on 4 ranks, one each: every rank draws the R-wide noise
    and takes its restart's, so each restart's losses and parameters match
    the one-process vectorized path (rel 1e-6 / 1e-5); fit_multistart picks
    the same winner with the same losses, and the committed winner trains."""
    params_R, losses_RT = one["restarts"]
    r0 = res["data"][0]
    assert r0["restarts/losses"].shape == (4, 10)
    assert _rel(r0["restarts/losses"], losses_RT) <= 1e-6
    for p, v in params_R.items():
        assert _rel(r0[f"restarts/params/{p}"], v) <= 1e-5, p
    losses, winner, G = one["multistart"]
    assert int(r0["multistart/winner"]) == winner
    assert _rel(r0["multistart/losses"], losses) <= 1e-5
    np.testing.assert_allclose(r0["multistart/G"], G, atol=1e-4)
    assert all(np.isfinite(r["multistart/next_step"]) for r in res["data"])


def test_multistart_restart_padding_on_mesh(res, one):
    """3 restarts on 4 ranks: padded to 4, sliced back to 3."""
    losses_RT = one["restarts3"]
    r0 = res["data"][0]
    assert r0["restarts3/losses"].shape == (3, 8)
    assert r0["restarts3/params/Xtilde"].shape[0] == 3
    assert _rel(r0["restarts3/losses"], losses_RT) <= 1e-6


def test_multistart_minibatch_on_mesh_is_local(res):
    assert all(np.isfinite(r["multistart_mb/losses"]).all() for r in res["data"])


# ---------------------------------------------------------------------------
# a world of one, in this process
# ---------------------------------------------------------------------------


def test_world_of_one_fit_bit_for_bit(tmp_path):
    """distribute(make_mesh(1)) on gloo: fit() gives the plain fit's losses
    and parameters bit for bit, with 2 all-reduces a step; n_devices other
    than the world size raises."""
    kw = dict(m_X_per_view=6, m_G=6, n_latent_gps={"expression": 2}, fixed_view_idx=0,
              device="cpu")
    dd = W.two_view_data(n_per_view=16, n_outputs=3)
    plain, model = VariationalGPSA(dd, **kw), VariationalGPSA(dd, **kw)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="world"):
            tpar.make_mesh(2, devices="cpu")
        tpar.distribute(model, tpar.make_mesh(1, devices="cpu"))
        want = plain.fit(n_epochs=20, S=2)
        ops.set_counters(dict.fromkeys(ops.read_counters(), 0))
        got = model.fit(n_epochs=20, S=2)
        counts = ops.read_counters()
        np.testing.assert_array_equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(model.parameters(), plain.parameters()))
        assert counts["collectives.all_reduce_world_calls"] == 2 * 20
        assert math.isfinite(model.neg_elbo(S=2))
        assert np.isfinite(model.fit(n_epochs=5, S=2, minibatch_size=8)).all()
    finally:
        dist.destroy_process_group()
