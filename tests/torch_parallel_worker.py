"""One rank of a gloo world on the CPU for ``tests/test_torch_parallel.py``.

``python tests/torch_parallel_worker.py RANK SIZE DIR`` joins a world of
SIZE = 4 processes through a file store in DIR, runs the distributed
computations of a 4 x 1 mesh ("data") and then of a 2 x 2 mesh ("grid") on
the port, and writes what each gave to ``DIR/<mesh>_RANK.npz``; the test
compares them with one process and with the JAX package. It imports no JAX: injected
Monte-Carlo normals come from ``DIR/inputs.npz``. One thread a process.
"""

from __future__ import annotations

import math
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from spatial_alignment_tpu_torch import VariationalGPSA, ops  # noqa: E402
from spatial_alignment_tpu_torch.data import generate_twod_data  # noqa: E402
from spatial_alignment_tpu_torch.models._trees import named_leaves  # noqa: E402
from spatial_alignment_tpu_torch.parallel import (  # noqa: E402
    distribute,
    make_mesh,
    make_shardmap_neg_elbo,
    make_shardmap_train_step,
)

WORLD = 4
MESHES = {"data": 1, "grid": 2}  # mesh: model_parallel

# Each case: (data kwargs, model kwargs, lengthscales set to 2 for
# well-conditioned Grams, S). pad_multiple is the world's data-axis size.
CASES = {
    "elbo": (dict(n_per_view=24, n_outputs=4),
             dict(m_X_per_view=6, m_G=6, n_latent_gps={"expression": 2}, fixed_view_idx=0),
             True, 3),
    # elbo's model with the quad-diag kernel opted in (kept by distribute)
    "quad": (dict(n_per_view=24, n_outputs=4),
             dict(m_X_per_view=6, m_G=6, n_latent_gps={"expression": 2}, fixed_view_idx=0,
                  quad_diag_impl="pallas"), True, 3),
    "whitened": (dict(n_per_view=16, n_outputs=3),
                 dict(m_X_per_view=6, m_G=6, whitened_variational=True), True, 2),
    "lmc2d": (dict(n_per_view=16, n_outputs=6),
              dict(m_X_per_view=6, m_G=6, n_latent_gps={"expression": 4}, fixed_view_idx=0),
              True, 2),
    "nolmc2d": (dict(n_per_view=16, n_outputs=4),
                dict(m_X_per_view=6, m_G=6, fixed_view_idx=0), True, 2),
    "analytic2d": (dict(n_per_view=16, n_outputs=6),
                   dict(m_X_per_view=6, m_G=6, n_latent_gps={"expression": 4}, fixed_view_idx=0,
                        analytic_data_likelihood=True), True, 2),
    "fit": (dict(n_per_view=16, n_outputs=3), dict(m_X_per_view=6, m_G=6, seed=4), False, 2),
    "ckpt": (dict(n_per_view=16, n_outputs=3), dict(m_X_per_view=6, m_G=6, seed=2), False, 2),
    "mb": (dict(n_per_view=24, n_outputs=3), dict(m_X_per_view=6, m_G=6), False, 1),
    "mbpad": (dict(n_per_view=10, n_outputs=3), dict(m_X_per_view=6, m_G=6, pad_multiple=16),
              False, 1),
    "restarts": (dict(n_per_view=24, n_outputs=4, warp_sigma=0.3),
                 dict(m_X_per_view=6, m_G=6, fixed_view_idx=0), False, 2),
    "fit2d": (dict(n_per_view=16, n_outputs=4),
              dict(m_X_per_view=8, m_G=8, n_latent_gps={"expression": 2}, fixed_view_idx=0),
              False, 2),
}
MB_DRAWS = 200
MB_STEPS = 50
FIT_STEPS = 30
FIT2D_STEPS = 60
CONVERGE_STEPS = 200


def two_view_data(n_per_view=30, n_outputs=3, n_views=2, seed=0, warp_sigma=0.1):
    """The tests' tiny two-view dataset (``tests/conftest.py``'s
    ``make_two_view_data``, copied so this process imports no JAX)."""
    rng = np.random.default_rng(seed)
    X1 = rng.uniform(0, 10, (n_per_view, 2)).astype(np.float32)
    Y1 = np.stack(
        [np.sin(X1[:, 0] * (j + 1) / 3.0) + np.cos(X1[:, 1]) for j in range(n_outputs)],
        axis=1,
    ).astype(np.float32)
    Xs, Ys = [X1], [Y1]
    for _ in range(n_views - 1):
        Xs.append(X1 + warp_sigma * rng.standard_normal(X1.shape).astype(np.float32))
        Ys.append(Y1)
    return {"expression": {"spatial_coords": np.concatenate(Xs, 0),
                           "outputs": np.concatenate(Ys, 0),
                           "n_samples_list": [n_per_view] * n_views}}


def converge_data():
    X, Y, nsl, view_idx = generate_twod_data(
        2, 10, grid_size=8, n_latent_gps=None, kernel_variance=0.5, kernel_lengthscale=5.0,
        noise_variance=1e-3, fixed_view_idx=0, rng=np.random.default_rng(0))
    X, Y = X.astype(np.float32), Y.astype(np.float32)
    return {"expression": {"spatial_coords": X, "outputs": Y, "n_samples_list": nsl}}, view_idx


CONVERGE_KW = dict(m_X_per_view=16, m_G=16, n_latent_gps={"expression": None}, fixed_view_idx=0)


def build(case: str, pad_multiple: int = 1) -> VariationalGPSA:
    """The case's model on the CPU; lengthscales 2 where the case says."""
    data_kw, kw, ls2, _ = CASES[case]
    kw = {"seed": 0, "pad_multiple": pad_multiple, **kw}
    model = VariationalGPSA(two_view_data(**data_kw), device="cpu", **kw)
    with torch.no_grad():
        if ls2:
            for name in ("warp_kernel_lengthscales", "data_kernel_lengthscale"):
                model.params[name].fill_(math.log(2.0))
        if model.spec.whitened_variational:
            # Off the whitened init, where q is the prior, the warp output does
            # not depend on the inducing points and their gradients are noise.
            rng = np.random.default_rng(2)
            for name in ("delta_G", "Omega_sqt_G", "delta_F", "Omega_sqt_F"):
                for t in ([model.params[name]] if name.endswith("G")
                          else model.params[name].values()):
                    r = rng.standard_normal(tuple(t.shape))
                    t.copy_(torch.from_numpy(
                        (np.tril(np.eye(t.shape[-1]) + 0.2 * r) if name.startswith("Omega")
                         else 0.3 * r).astype(np.float32)))
    return model


# The draws each case takes from inputs.npz (the analytic case samples only
# the warp layer: lmc2d's warp normals, of its shape; quad is elbo's model).
NOISE = {"analytic2d": "lmc2d", "quad": "elbo"}


def injected(inputs, case):
    """(warp, {mod: data} or None) normals for ``case`` from inputs.npz."""
    key = NOISE.get(case, case)
    warp = torch.from_numpy(inputs[f"{key}/warp"])
    if CASES[case][1].get("analytic_data_likelihood"):
        return warp, None
    return warp, {"expression": torch.from_numpy(inputs[f"{key}/data"])}


def grads_full(model) -> dict:
    """{leaf path: full gradient} of a distributed model (sharded leaves'
    gradients gathered like the leaves)."""
    from spatial_alignment_tpu_torch.parallel.sharding import gather_block

    placed = dict(named_leaves(model._placements()))
    return {p: gather_block(t.grad, placed[p], model._mesh, model._comms).numpy()
            for p, t in named_leaves(model.params) if t.grad is not None}


def put(res, prefix, tree):
    for k, v in tree.items():
        res[f"{prefix}/{k}"] = np.asarray(v)


def loss_and_grads(res, case, model, inputs):
    """Value and every leaf's gradient of the executor at injected noise."""
    S = CASES[case][3]
    wn, dn = injected(inputs, case)
    neg = make_shardmap_neg_elbo(model.spec, model._mesh, model.consts, S)
    loss = neg(model.params, model._batch, warp_noise=wn, data_noise=dn)
    loss.backward()
    res[f"{case}/loss"] = loss.item()
    put(res, f"{case}/grad", grads_full(model))
    put(res, f"{case}/local_grad", {p: t.grad.numpy() for p, t in named_leaves(model.params)})
    for t in model.parameters():
        t.grad = None


def one_step(res, case, model, inputs):
    """One make_train_step step (Adam, lr 1e-2) at injected noise."""
    wn, dn = injected(inputs, case)
    model._draw_noise = lambda S_: (wn, dn)
    step, _ = model.make_train_step(lr=1e-2, S=CASES[case][3])
    res[f"{case}/step_loss"] = step().item()
    model._draw_noise = None
    put(res, f"{case}/step_params", {p: t.detach().numpy() for p, t in
                                     named_leaves(model._full_params())})


def world_data(rank, size, out, inputs):
    res = {"world_size": dist.get_world_size()}
    mesh = make_mesh(size, model_parallel=MESHES["data"], devices="cpu")
    res["mesh_shape"] = np.array(mesh.mesh.shape)
    res["data_rank"] = mesh.get_local_rank("data")

    model = distribute(build("elbo", 4), mesh)
    wn, dn = injected(inputs, "elbo")
    with torch.no_grad():  # the model's own route (fit's loss) at the same draws
        res["elbo/model_loss"] = model._loss_fn(None)(model.params, 3, 1.0, wn, dn).item()
    loss_and_grads(res, "elbo", model, inputs)
    one_step(res, "elbo", model, inputs)
    model = distribute(build("elbo", 4), mesh)
    step, init = make_shardmap_train_step(model.spec, mesh, model.consts, S=3, lr=1e-2)
    _, _, loss = step(model.params, init(model.params), model._batch,
                      torch.Generator().manual_seed(21))
    res["elbo/shardmap_step_loss"] = loss.item()
    put(res, "elbo/shardmap_step_params", {p: t.detach().numpy() for p, t in
                                           named_leaves(model.params)})
    model = distribute(build("whitened", 4), mesh)
    one_step(res, "whitened", model, inputs)
    model = distribute(build("quad", 4), mesh)
    res["quad/impl"] = model.spec.quad_diag_impl
    loss_and_grads(res, "quad", model, inputs)

    try:  # n_padded = 30 is not a multiple of 4
        distribute(VariationalGPSA(two_view_data(n_per_view=30), m_X_per_view=6, m_G=6,
                                   device="cpu"), mesh)
        res["pad_error"] = ""
    except ValueError as e:
        res["pad_error"] = str(e)

    # fit + predict, against one process in the test
    model = build("fit", 4)
    model.fit(n_epochs=5, lr=1e-2, S=2)  # a cached loop before distribute
    cached = model.__dict__.get("_train_loop_cache")
    distribute(model, mesh)
    res["fit/cache_dropped"] = cached is not None and "_train_loop_cache" not in model.__dict__
    with torch.no_grad():
        for t, v in zip(model.parameters(), build("fit", 4).parameters()):
            t.copy_(v)  # the fit starts from the constructor's parameters
    model._gen.manual_seed(4)
    res["fit/losses"] = model.fit(n_epochs=FIT_STEPS, lr=1e-2, S=2, chunk_size=10)
    X = {"expression": two_view_data(**CASES["fit"][0])["expression"]["spatial_coords"]}
    res["fit/G"] = model.predict(X)[0]["expression"]
    res["fit/forward_G"] = model.forward(X, S=1)[0]["expression"]
    put(res, "fit/params", {p: t.detach().numpy() for p, t in named_leaves(model.params)})

    # checkpoint round trip: fit(14) against fit(7) + save + load + fit(7)
    full = distribute(build("ckpt", 4), mesh)
    res["ckpt/full"] = full.fit(n_epochs=14, lr=1e-2, S=2, chunk_size=7)
    a = distribute(build("ckpt", 4), mesh)
    res["ckpt/a"] = a.fit(n_epochs=7, lr=1e-2, S=2, chunk_size=7)
    path = os.path.join(out, "dist.npz")
    a.save(path)
    b = distribute(VariationalGPSA.load(path, device="cpu"), mesh)
    res["ckpt/b"] = b.fit(n_epochs=7, lr=1e-2, S=2, chunk_size=7, resume_from=path)
    res["ckpt/params_equal"] = all(torch.equal(x, y) for x, y in
                                   zip(full.parameters(), b.parameters()))

    # stratified minibatch estimates (unbiasedness; all-padding shards)
    for case in ("mb", "mbpad"):
        model = distribute(build(case, 4), mesh)
        neg = make_shardmap_neg_elbo(model.spec, mesh, model.consts, S=1, minibatch_size=16)
        gen = torch.Generator().manual_seed(0)
        loss = neg(model.params, model._batch, gen)
        loss.backward()
        res[f"{case}/grads_finite"] = all(bool(torch.isfinite(t.grad).all())
                                          for t in model.parameters())
        with torch.no_grad():
            res[f"{case}/draws"] = np.array(
                [neg(model.params, model._batch, gen).item() for _ in range(MB_DRAWS)])
    res["mbpad/local_real"] = model._batch["expression"]["mask"].sum().item()

    # the executor's minibatch train step, and the model's minibatch fit
    model = distribute(build("mb", 4), mesh)
    step, init = make_shardmap_train_step(model.spec, mesh, model.consts, S=2, lr=1e-2,
                                          minibatch_size=16)
    gen = torch.Generator().manual_seed(0)
    full = make_shardmap_neg_elbo(model.spec, mesh, model.consts, S=3)
    at = lambda: full(model.params, model._batch, torch.Generator().manual_seed(1)).item()
    res["mbtrain/e0"] = at()
    opt = init(model.params)
    for _ in range(MB_STEPS):
        _, opt, loss = step(model.params, opt, model._batch, gen)
    res["mbtrain/last"] = loss.item()
    res["mbtrain/e1"] = at()

    model = distribute(build("mb", 4), mesh)
    res["mbfit/e0"] = model.neg_elbo(S=3)
    res["mbfit/losses"] = model.fit(n_epochs=MB_STEPS, lr=1e-2, S=2, minibatch_size=16)
    res["mbfit/e1"] = model.neg_elbo(S=3)
    step, _ = model.make_train_step(lr=1e-2, S=2, minibatch_size=12)
    step()
    ops.set_counters(dict.fromkeys(ops.read_counters(), 0))
    res["mbstep/loss"] = step().item()
    put(res, "mbstep/counts", {k: v for k, v in ops.read_counters().items()
                               if k.startswith("collectives.")})
    res["mbstep/replicated_bytes"] = 4 * sum(
        t.numel() for t in model.parameters())

    # restarts over the ranks
    model = distribute(build("restarts", 4), mesh)
    params_R, losses_RT = model._fit_restarts_vectorized(n_epochs=10, n_restarts=4, seed0=0,
                                                          S=2)
    res["restarts/losses"] = losses_RT
    put(res, "restarts/params", {p: t.numpy() for p, t in named_leaves(params_R)})
    params_R, losses_RT = model._fit_restarts_vectorized(n_epochs=8, n_restarts=3, seed0=0,
                                                          S=2)
    res["restarts3/losses"] = losses_RT
    put(res, "restarts3/params", {p: t.numpy() for p, t in named_leaves(params_R)})
    res["multistart/losses"] = model.fit_multistart(n_epochs=60, n_restarts=4, S=2,
                                                    verbose=False, vectorized=True)
    res["multistart/winner"] = model.multistart_winner_["restart"]
    X = {"expression": two_view_data(**CASES["restarts"][0])["expression"]["spatial_coords"]}
    res["multistart/G"] = model.predict(X)[0]["expression"]
    step, _ = model.make_train_step(lr=1e-2, S=2)
    res["multistart/next_step"] = step().item()
    res["multistart_mb/losses"] = model.fit_multistart(
        n_epochs=20, n_restarts=4, S=2, verbose=False, vectorized=True, minibatch_size=8)
    return res


def world_grid(rank, size, out, inputs):
    res = {}
    mesh = make_mesh(size, model_parallel=MESHES["grid"], devices="cpu")
    for case in ("lmc2d", "nolmc2d", "analytic2d"):
        model = distribute(build(case, 2), mesh)
        res[f"{case}/merged"] = model.spec.merged_factor_dispatch
        res[f"{case}/local_L"] = model.params["delta_F"]["expression"].shape[1]
        loss_and_grads(res, case, model, inputs)

    from spatial_alignment_tpu_torch import load_jax_checkpoint

    model = distribute(load_jax_checkpoint(os.path.join(out, "jax_unmerged.npz"), device="cpu"),
                       mesh)
    res["convert/merged"] = model.spec.merged_factor_dispatch
    wn, dn = injected(inputs, "lmc2d")
    with torch.no_grad():
        res["convert/loss"] = model._loss_fn(None)(model.params, 2, 1.0, wn, dn).item()

    model = build("fit2d", 2)
    distribute(model, mesh)
    res["fit2d/losses"] = model.fit(n_epochs=FIT2D_STEPS, lr=1e-2, S=2)
    put(res, "fit2d/params", {p: t.detach().numpy() for p, t in named_leaves(model.params)})
    X = {"expression": two_view_data(**CASES["fit2d"][0])["expression"]["spatial_coords"]}
    res["fit2d/forward_G"] = model.forward(X, S=1)[0]["expression"]

    # checkpoint round trip with model-sharded leaves (their Adam state cut
    # and gathered like them)
    full = distribute(build("fit2d", 2), mesh)
    res["ckpt2d/full"] = full.fit(n_epochs=14, lr=1e-2, S=2, chunk_size=7)
    a = distribute(build("fit2d", 2), mesh)
    res["ckpt2d/a"] = a.fit(n_epochs=7, lr=1e-2, S=2, chunk_size=7)
    path = os.path.join(out, "dist2d.npz")
    a.save(path)
    b = distribute(VariationalGPSA.load(path, device="cpu"), mesh)
    res["ckpt2d/b"] = b.fit(n_epochs=7, lr=1e-2, S=2, chunk_size=7, resume_from=path)
    res["ckpt2d/params_equal"] = all(torch.equal(x, y) for x, y in
                                     zip(full.parameters(), b.parameters()))

    data, _ = converge_data()
    model = VariationalGPSA(data, device="cpu", pad_multiple=2, seed=0, **CONVERGE_KW)
    distribute(model, mesh)
    res["converge/losses"] = model.fit(n_epochs=CONVERGE_STEPS, lr=1e-2, S=3)
    res["converge/G"] = model.predict(
        {"expression": data["expression"]["spatial_coords"]})[0]["expression"]
    return res


def main(rank, size, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(out, 'store')}",
                            rank=rank, world_size=size)
    inputs = dict(np.load(os.path.join(out, "inputs.npz")))
    for world, run in (("data", world_data), ("grid", world_grid)):
        try:
            res = run(rank, size, out, inputs)
        except Exception:
            res = {"error": traceback.format_exc()}
        np.savez(os.path.join(out, f"{world}_{rank}.npz"), **res)
        if "error" in res:
            break
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
