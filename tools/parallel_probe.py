#!/usr/bin/env python3
"""Distributed fits of the port (``spatial_alignment_tpu_torch.parallel``)
on the card against one process.

Four cards, NCCL, one process a card:

    torchrun --nproc-per-node 4 tools/parallel_probe.py [--steps 200] [--out DIR]

runs fit_m200's model (``chip_smoke.two_view_data(45, 10)``: N = 4,050,
m = 200, 10-latent LMC) on the 4 x 1 mesh (``pad_multiple=4``) and on the
2 x 2 mesh (``pad_multiple=2``; L = 10 as 5 + 5), each a captured
``fit()`` of ``--steps`` steps, and on rank 0's card the one-process fit of
the same model and seed, and that fit again from every parameter one ulp up:
the first 20 losses held at rel 2e-4 (JAX's limit for a sharded train step)
or, where float32 spreads wider, within twice the one-ulp gap (``hold``);
ms a step of each, the Cholesky launches and the collectives (calls and
bytes) a step, and the replicated parameters bit-equal across the ranks.
Before training, each case holds the gradient rule directly: one
distributed loss and backward at the constructor's parameters and the
draws of a generator seeded ``GRAD_SEED``, against the one-process loss
and gradients at the same parameters and draws: the loss at rel 2e-4 and
every leaf's gradient (each rank's own block of it) at JAX's rtol 5e-3 and
atol 1e-4 (1 + max |g|), the atol widened where float32 spreads wider to
twice the gap one ulp up opens in that leaf (``hold_grads``).

Two ranks on one card (NCCL refuses two ranks on one device, so gloo with
CUDA tensors, whose steps run eagerly), as ``chip_smoke.py`` runs it:

    python tools/parallel_probe.py --rank R --world 2 --store FILE \\
        --cases data2,model2,restarts2 [--device cuda] [--out DIR]

``data2``: the 2 x 1 mesh on fit_m200's data (``pad_multiple=2``), with
``quad_diag_impl="pallas"`` (the quad-diag kernels on each rank's block of
rows: their launches counted, no plain call);
``model2``: the 1 x 2 mesh (L = 10 as 5 + 5); ``restarts2``: the 16
restarts of ``multistart_m50``'s harness (m = 50, 5 latents, the accurate
recipe) spread 8 + 8 over the ranks. 20 steps each, against the one-process
steps (restarts: the one-process R-wide loop) as above, and the replicated
parameters (restarts: every gathered parameter) bit-equal across ranks.

Rank 0 prints one JSON object (with nvidia-smi's name and power limit on
the card) as its last line and writes it to ``DIR/parallel_probe.json``
(DIR: ``--out``, default ``spatial_alignment_tpu_torch/_build/parallel_probe``);
every rank writes ``DIR/<case>_rank<R>.npz``. Exits non-zero on a failed
check. Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STEPS_HELD = 20
GRAD_SEED = 7
RESTARTS, RESTART_STEPS = 16, 20


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except OSError as e:
        return f"nvidia-smi failed: {e}"


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--out", type=Path,
                        default=ROOT / "spatial_alignment_tpu_torch" / "_build" / "parallel_probe")
    parser.add_argument("--rank", type=int)
    parser.add_argument("--world", type=int)
    parser.add_argument("--store", type=Path, help="file store of a world without torchrun")
    parser.add_argument("--cases", default="fit_4x1,fit_2x2")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    import torch.distributed as dist

    if args.device == "cuda" and not torch.cuda.is_available():
        print("parallel_probe: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import two_view_data
    from spatial_alignment_tpu_torch import VariationalGPSA, ops
    from spatial_alignment_tpu_torch.models import core
    from spatial_alignment_tpu_torch.models._trees import named_leaves
    from spatial_alignment_tpu_torch.models.train import resolve_recipe
    from spatial_alignment_tpu_torch.parallel import distribute, make_mesh, make_shardmap_neg_elbo

    backend = None
    if args.store is not None:  # the two ranks on one card: gloo, no torchrun
        backend = "gloo"
        dist.init_process_group("gloo", init_method=f"file://{args.store}", rank=args.rank,
                                world_size=args.world)
    else:
        make_mesh(devices=args.device)  # the group from torchrun's environment
    rank, world = dist.get_rank(), dist.get_world_size()
    args.out.mkdir(parents=True, exist_ok=True)
    dev = args.device
    dd200, X200, vi200 = two_view_data(45, 10)
    kw200 = dict(m_X_per_view=200, m_G=200, n_latent_gps={"expression": 10}, fixed_view_idx=0,
                 mean_function="identity_fixed", device=dev)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)

    def counts():
        c = ops.read_counters()
        return {k: v for k, v in c.items() if v}

    def replicated(model):
        placed = dict(named_leaves(model._placements()))
        return {p: t.detach().cpu().numpy() for p, t in named_leaves(model.params)
                if all(not x.is_shard() for x in placed[p])}

    def barrier_then_ranks(case):
        dist.barrier()
        return [dict(np.load(args.out / f"{case}_rank{r}.npz")) for r in range(world)]

    def hold_ranks_equal(case, ranks):
        for key in ranks[0]:
            if key.startswith("param/"):
                for r in ranks[1:]:
                    check(np.array_equal(r[key], ranks[0][key]),
                          f"{case}: {key} differs between rank 0 and another rank")

    def warm(model):
        """One fit step outside the timed run (a process's first optimizer
        imports torch._dynamo; fit() captures its step), then the parameters
        and the generator put back."""
        params = {p: t.detach().clone() for p, t in named_leaves(model._full_params())}
        gen = model._gen.get_state()
        model.fit(n_epochs=1, S=5)
        with torch.no_grad():
            full = model._full_params()
            for p, t in named_leaves(full):
                t.copy_(params[p])
        model._commit_params_to_mesh(full)
        model._gen.set_state(gen)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)

    ulp_up = lambda t: torch.nextafter(t, torch.full_like(t, float("inf")))

    def grads_at_start(model):
        """{"loss0", "grad0/<leaf>"}: the executor's loss and this rank's
        gradient blocks at the model's parameters and GRAD_SEED's draws."""
        neg = make_shardmap_neg_elbo(model.spec, model._mesh, model.consts, S=5)
        loss = neg(model.params, model._batch, torch.Generator(dev).manual_seed(GRAD_SEED))
        loss.backward()
        out = {"loss0": loss.item()}
        for p, t in named_leaves(model.params):
            if t.grad is not None:
                out[f"grad0/{p}"] = t.grad.cpu().numpy()
            t.grad = None
        return out

    def plain_grads(plain):
        """The one-process loss and {leaf: gradient} at GRAD_SEED's draws."""
        loss = core.negative_elbo(plain.spec, plain.params, plain.consts, plain._batch, 5,
                                  generator=torch.Generator(dev).manual_seed(GRAD_SEED))
        loss.backward()
        grads = {p: t.grad.double().cpu().numpy() for p, t in named_leaves(plain.params)
                 if t.grad is not None}
        for t in plain.parameters():
            t.grad = None
        return loss.item(), grads

    def hold_grads(case, row, model, plain, ranks):
        """Every rank's loss and gradient blocks at the start against the
        one-process ones at the same parameters and draws: the loss at rel
        2e-4, each leaf within rtol 5e-3 and JAX's atol 1e-4 (1 + max |g|)
        or, where float32 spreads wider (a sum over points that cancels, as
        Xtilde's), twice the largest gap the one-process gradient opens
        from parameters one ulp up."""
        loss, want = plain_grads(plain)
        with torch.no_grad():
            start = {p: t.detach().clone() for p, t in named_leaves(plain.params)}
            for p, t in named_leaves(plain.params):
                t.copy_(ulp_up(start[p]))
        _, up = plain_grads(plain)
        with torch.no_grad():
            for p, t in named_leaves(plain.params):
                t.copy_(start[p])
        placed = dict(named_leaves(model._placements()))
        sizes = [model._mesh.size(i) for i in range(2)]
        worst, worst_leaf, gaps = 0.0, None, {}
        for p, g in want.items():
            gaps[p] = max(1e-4 * (1.0 + np.abs(g).max()), 2.0 * np.abs(up[p] - g).max())
        for r, got in enumerate(ranks):
            check({k[len("grad0/"):] for k in got if k.startswith("grad0/")} == set(want),
                  f"{case}: rank {r}'s gradients reach other leaves than one process's")
            coords = (r // sizes[1], r % sizes[1])  # row-major ranks (make_mesh)
            for p, b in want.items():
                for i, pl in enumerate(placed[p]):
                    if pl.is_shard():
                        n = b.shape[pl.dim] // sizes[i]
                        b = np.take(b, range(coords[i] * n, (coords[i] + 1) * n), axis=pl.dim)
                a = got[f"grad0/{p}"].astype(np.float64)
                excess = float((np.abs(a - b) / (gaps[p] + 5e-3 * np.abs(b))).max())
                if excess > worst:
                    worst, worst_leaf = excess, p
            row.setdefault("loss0_rel", []).append(float(rel(got["loss0"], loss)))
        row.update(grad0_worst_ratio=worst, grad0_worst_leaf=worst_leaf,
                   grad0_atol_of_worst_leaf=float(gaps.get(worst_leaf, 0.0)),
                   grad0_max_of_worst_leaf=float(np.abs(want[worst_leaf]).max())
                   if worst_leaf else 0.0)
        check(max(row["loss0_rel"]) <= 2e-4, f"{case}: loss at the start, rel {row['loss0_rel']}")
        check(worst <= 1.0, f"{case}: gradient of {worst_leaf} outside its limit "
                            f"({worst} of it)")

    def hold(case, row, got, want, ulp):
        """The distributed losses against one process's: within rel 2e-4
        (JAX's limit for a sharded step), or where float32 itself spreads
        wider (this model at its constructor's parameters: a loss near 1e8,
        Grams of cond ~1e6), within twice the gap the one-process run opens
        from parameters one ulp up."""
        r, u = rel(got, want), rel(ulp, want)
        limit = max(2e-4, 2.0 * float(u[..., :STEPS_HELD].max()))
        row.update(loss_first=float(np.ravel(got)[0]), plain_loss_first=float(np.ravel(want)[0]),
                   max_rel_first_20=float(r[..., :STEPS_HELD].max()), max_rel_all=float(r.max()),
                   ulp_max_rel_first_20=float(u[..., :STEPS_HELD].max()), limit=limit)
        check(bool(np.isfinite(got).all()), f"{case}: non-finite loss")
        check(row["max_rel_first_20"] <= limit,
              f"{case}: losses against one process, rel {row['max_rel_first_20']} > {limit}")

    result = {"nvidia_smi": smi() if dev == "cuda" else None, "world": world,
              "backend": dist.get_backend(), "device": dev, "cases": {}}
    for case in args.cases.split(","):
        t_case = time.perf_counter()
        row = {}
        if case in ("fit_4x1", "fit_2x2", "data2", "model2"):
            mp = 2 if case in ("fit_2x2", "model2") else 1
            n_data = world // mp
            pad = n_data if n_data > 1 else 1
            kw = dict(kw200, quad_diag_impl="pallas") if case == "data2" else kw200
            model = VariationalGPSA(dd200, pad_multiple=pad, **kw)
            plain = VariationalGPSA(dd200, pad_multiple=pad, **kw) if rank == 0 else None
            distribute(model, make_mesh(world, model_parallel=mp, devices=dev, backend=backend))
            eager = case in ("data2", "model2")
            steps = STEPS_HELD if eager else args.steps
            start = grads_at_start(model)
            warm(model)  # the optimizer's first build, the capture, the communicators
            ops.set_counters(dict.fromkeys(ops.read_counters(), 0))
            sync()
            t0 = time.perf_counter()
            losses = model.fit(n_epochs=steps, S=5)
            sync()
            dt = time.perf_counter() - t0
            c = counts()
            loop = model._train_loop_cache["loop"]
            np.savez(args.out / f"{case}_rank{rank}.npz", losses=losses, **start,
                     **{f"param/{p}": v for p, v in replicated(model).items()})
            row.update(captured=loop.graph is not None, steps=steps,
                       ms_per_step=dt * 1e3 / steps,
                       launches_per_step={k: v / steps for k, v in c.items()},
                       local_latents=int(model.params["delta_F"]["expression"].shape[1]),
                       local_points=int(model._batch["expression"]["mask"].shape[1]))
            ranks = barrier_then_ranks(case)
            if rank == 0:
                hold_ranks_equal(case, ranks)
                hold_grads(case, row, model, plain, ranks)
                warm(plain)
                start = {p: t.detach().clone() for p, t in named_leaves(plain.params)}
                gen = plain._gen.get_state()
                sync()
                t0 = time.perf_counter()
                want = plain.fit(n_epochs=steps, S=5)
                sync()
                row["plain_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / steps
                with torch.no_grad():  # the same fit from every parameter one ulp up
                    for p, t in named_leaves(plain.params):
                        t.copy_(ulp_up(start[p]))
                plain._gen.set_state(gen)
                hold(case, row, losses, want, plain.fit(n_epochs=steps, S=5))
                check(c.get("cholesky.plain_calls", 0) == 0 or dev != "cuda",
                      f"{case}: plain Cholesky on the card")
                if case == "data2" and dev == "cuda":
                    check(c.get("quad.fwd_launches", 0) > 0 and c.get("quad.bwd_launches", 0) > 0
                          and c.get("quad.plain_calls", 0) == 0,
                          f"{case}: quad-diag kernels on the distributed path: {c}")
                check(row["captured"] == (dist.get_backend() == "nccl" and dev == "cuda"),
                      f"{case}: captured {row['captured']}")
        elif case == "restarts2":
            dd, X, vi = two_view_data(10, 5)
            kw = dict(m_X_per_view=50, m_G=50, n_latent_gps={"expression": 5},
                      mean_function="identity_fixed", fixed_view_idx=None, seed=0, device=dev)
            opt, temps = resolve_recipe("accurate", 1e-2, 10_000, None, None)
            run = dict(n_epochs=RESTART_STEPS, n_restarts=RESTARTS, seed0=0, lr=1e-2, S=5,
                       optimizer=opt, warp_temperature_schedule=temps)
            model = VariationalGPSA(dd, **kw)
            distribute(model, make_mesh(world, devices=dev, backend=backend))
            model._fit_restarts_vectorized(**{**run, "n_epochs": 1})  # its capture
            sync()
            t0 = time.perf_counter()
            params_R, losses_RT = model._fit_restarts_vectorized(**run)
            sync()
            dt = time.perf_counter() - t0
            np.savez(args.out / f"{case}_rank{rank}.npz", losses=losses_RT,
                     **{f"param/{p}": t.detach().cpu().numpy()
                        for p, t in named_leaves(params_R)})
            row.update(restarts_per_rank=RESTARTS // world, seconds=dt,
                       restart_step_ms=dt * 1e3 / RESTART_STEPS)
            ranks = barrier_then_ranks(case)
            if rank == 0:
                hold_ranks_equal(case, ranks)
                one = VariationalGPSA(dd, **kw)
                _, want = one._fit_restarts_vectorized(**run)
                inits = one._restart_inits
                one._restart_inits = lambda *a, **k: {  # every initial value one ulp up
                    n: {m: ulp_up(v) for m, v in t.items()} if isinstance(t, dict) else ulp_up(t)
                    for n, t in inits(*a, **k).items()}
                _, spread = one._fit_restarts_vectorized(**run)
                row["shape"] = list(losses_RT.shape)
                check(losses_RT.shape == (RESTARTS, RESTART_STEPS), f"{case}: shape")
                hold(case, row, losses_RT, want, spread)
        else:
            raise ValueError(f"unknown case {case!r}")
        row["seconds"] = time.perf_counter() - t_case
        result["cases"][case] = row
        if rank == 0:
            print(json.dumps({case: row}), flush=True)
        # A captured graph holds the NCCL communicator: free every model and
        # loop (and their graphs) before the group goes.
        model = plain = one = loop = None
        gc.collect()
    if rank == 0:
        (args.out / "parallel_probe.json").write_text(json.dumps(result))
        print(result["nvidia_smi"], flush=True)
        print(json.dumps(result), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
