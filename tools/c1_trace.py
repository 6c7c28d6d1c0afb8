#!/usr/bin/env python3
"""The 100k-spot model's first minibatch loss in four ways, on the CPU: the
JAX package in float32 and with ``jax_enable_x64`` (in a second process),
the PyTorch port in float32 and in float64, all at the JAX model's initial
parameters and at one draw of indices and noise, with the jitter rung each
factorization picks (``ops/linalg.py`` ``_probed_jitter``: 1, 10 or 100
times the base jitter).

    JAX_PLATFORMS=cpu python3 tools/c1_trace.py [--seed 7]

Data and model are ``bench.py``'s 100k configuration (``chip_smoke.py``
copies its data): two views of 50,000 spots, 10 genes, m = 100, LMC 10,
minibatches of 4,096 a view, S = 5. The float64 JAX process reads the
parameters and the float32 process's draws from a temporary file (under
x64 the same key draws other bits). Prints one JSON object. Needs both
packages, so it is a tool beside the tests, not part of the port.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

KW = dict(m_X_per_view=100, m_G=100, n_latent_gps={"expression": 10},
          mean_function="identity_fixed", fixed_view_idx=0, data_chunk_size=8192)
B, S = 4096, 5


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def unflat(d, prefix):
    tree = {}
    for k, v in d.items():
        if k.startswith(prefix):
            *path, last = k[len(prefix):].split("/")
            t = tree
            for p in path:
                t = t.setdefault(p, {})
            t[last] = v
    return tree


def jax_side(x64: bool, state_file: str, seed: int) -> dict:
    """The JAX package's loss and rungs. In float32 it also writes its
    parameters and draws to ``state_file``; under x64 it reads them."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    if x64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import spatial_alignment_tpu as sat
    from spatial_alignment_tpu.models import core as jcore
    from spatial_alignment_tpu.ops import linalg as jlin
    from chip_smoke import minibatch_100k_data

    rungs = []
    probed = jlin._probed_jitter

    def spy(mat, eps, impl=None):
        j = probed(mat, eps, impl)
        rungs.append(np.asarray(j / jlin._base_jitter(mat, eps)).ravel().tolist())
        return j

    jlin._probed_jitter = spy
    X, Y, nsl = minibatch_100k_data()
    dd = {"expression": {"spatial_coords": X, "outputs": Y, "n_samples_list": nsl}}
    jm = sat.VariationalGPSA(dd, **KW)
    sub_spec = jcore.minibatch_spec(jm.spec, B)
    key = jax.random.PRNGKey(seed)
    if not x64:
        loss = float(jcore.negative_elbo_minibatch(
            jm.spec, sub_spec, jm.params, jm.consts, jm._batch, key, S))
        # The draws negative_elbo_minibatch made from this key (core.py:
        # subsample_batch, negative_elbo).
        k_idx, k_elbo = jax.random.split(key)
        counts = jnp.asarray(nsl)[:, None]
        idx = jax.random.randint(jax.random.split(k_idx, 1)[0], (2, B), 0, counts)
        k_warp, k_data, _ = jax.random.split(k_elbo, 3)
        warp = jax.random.normal(k_warp, (S, 2, B, 2))
        data = jax.random.normal(jax.random.split(k_data, 1)[0], (S, 2 * B, 10))
        np.savez(state_file, **{"p/" + k: v for k, v in flat(jm.params).items()},
                 **{"c/" + k: v for k, v in flat(jm.consts).items()},
                 idx=np.asarray(idx), warp=np.asarray(warp), data=np.asarray(data))
        return {"loss": loss, "rungs": rungs}
    st = dict(np.load(state_file))

    def f64(t):
        return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                            if np.issubdtype(np.asarray(a).dtype, np.floating) else jnp.asarray(a), t)

    # The float32 process's draws, not the bits x64 would draw from the key.
    def randint(k, shape, *a, **kw):
        assert tuple(shape) == st["idx"].shape, shape
        return jnp.asarray(st["idx"])

    def normal(k, shape=(), dtype=None):
        for name in ("warp", "data"):
            if tuple(shape) == st[name].shape:
                return jnp.asarray(st[name], jnp.float64)
        raise AssertionError(f"unexpected normal draw {shape}")

    jax.random.randint, jax.random.normal = randint, normal
    loss = float(jcore.negative_elbo_minibatch(
        jm.spec, sub_spec, f64(unflat(st, "p/")), f64(unflat(st, "c/")), f64(jm._batch), key, S))
    return {"loss": loss, "rungs": rungs}


def port_side(state_file: str) -> dict:
    """The port's float32 and float64 losses and rungs on the CPU."""
    import torch
    import spatial_alignment_tpu_torch as tp
    from spatial_alignment_tpu_torch.models import core as tcore
    from spatial_alignment_tpu_torch.models.convert import params_from_numpy
    from spatial_alignment_tpu_torch.ops import linalg as tlin
    from chip_smoke import minibatch_100k_data

    rungs = []
    probed = tlin._probed_jitter

    def spy(mat, eps):
        j = probed(mat, eps)
        rungs.append((j / tlin._base_jitter(mat, eps)).ravel().tolist())
        return j

    tlin._probed_jitter = spy
    X, Y, nsl = minibatch_100k_data()
    dd = {"expression": {"spatial_coords": X, "outputs": Y, "n_samples_list": nsl}}
    tm = tp.VariationalGPSA(dd, device="cpu", **KW)
    st = dict(np.load(state_file))
    params, consts = params_from_numpy(unflat(st, "p/"), unflat(st, "c/"), "cpu")
    sub = tcore.minibatch_spec(tm.spec, B)

    def dbl(t):
        if isinstance(t, dict):
            return {k: dbl(v) for k, v in t.items()}
        return t.double() if t.is_floating_point() else t

    draws = dict(indices={"expression": torch.from_numpy(st["idx"].astype(np.int64))},
                 warp_noise=torch.from_numpy(st["warp"]),
                 data_noise={"expression": torch.from_numpy(st["data"])})
    out = {}
    with torch.no_grad():
        for name, cast in (("f32", lambda t: t), ("f64", dbl)):
            rungs.clear()
            loss = tcore.negative_elbo_minibatch(
                tm.spec, sub, cast(params), cast(consts), cast(tm._batch), S,
                indices=draws["indices"], warp_noise=cast(draws["warp_noise"]),
                data_noise=cast(draws["data_noise"]))
            out[name] = {"loss": float(loss), "rungs": list(rungs)}
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=7, help="the JAX key of the draw")
    parser.add_argument("--x64-worker", metavar="STATE", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.x64_worker:
        print(json.dumps(jax_side(True, args.x64_worker, args.seed)))
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "state.npz")
        j32 = jax_side(False, state, args.seed)
        run = subprocess.run([sys.executable, __file__, "--x64-worker", state,
                              "--seed", str(args.seed)], capture_output=True, text=True,
                             check=True)
        j64 = json.loads(run.stdout.strip().splitlines()[-1])
        port = port_side(state)
    rel = lambda a, b: abs(a - b) / abs(b)
    print(json.dumps({
        "losses": {"jax_f32": j32["loss"], "jax_f64": j64["loss"],
                   "port_f32": port["f32"]["loss"], "port_f64": port["f64"]["loss"]},
        "rel": {"jax_f32_vs_f64": rel(j32["loss"], j64["loss"]),
                "port_f32_vs_f64": rel(port["f32"]["loss"], port["f64"]["loss"]),
                "port_f32_vs_jax_f32": rel(port["f32"]["loss"], j32["loss"]),
                "port_f64_vs_jax_f64": rel(port["f64"]["loss"], j64["loss"])},
        "rungs": {"jax_f32": j32["rungs"], "jax_f64": j64["rungs"],
                  "port_f32": port["f32"]["rungs"], "port_f64": port["f64"]["rungs"]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
