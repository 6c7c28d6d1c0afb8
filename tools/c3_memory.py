#!/usr/bin/env python3
"""What the backward of R restarts keeps with and without the data layer's
chunks, on the CPU, in both packages: the JAX package's compiled
``jax.jit(jax.vmap(jax.value_and_grad(negative_elbo)))`` temp bytes
(``memory_analysis()``), and the bytes of the tensors the port's autograd
saves for the R-wide loss (``torch.autograd.graph.saved_tensors_hooks``),
each beside the same for one restart without the vmap.

    JAX_PLATFORMS=cpu python3 tools/c3_memory.py

The model is tiny (two views of 30 points, m = 8, LMC 2, a template view,
R = 3, S = 2); ``data_chunk_size=16`` cuts the 60 points into 4 chunks of
15. Prints one JSON object. Needs both packages, so it is a tool beside the
tests, not part of the port.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

R, S = 3, 2


def main() -> int:
    import jax
    import jax.numpy as jnp
    import torch

    torch.set_num_threads(1)
    import spatial_alignment_tpu as sat
    from spatial_alignment_tpu.models import core as jcore
    import spatial_alignment_tpu_torch as tp
    from spatial_alignment_tpu_torch.models import core as tcore
    from spatial_alignment_tpu_torch.models._trees import tree_map
    from conftest import make_two_view_data

    dd = make_two_view_data(n_per_view=30)
    out = {}
    for chunk in (None, 16):
        kw = dict(m_X_per_view=8, m_G=8, n_latent_gps={"expression": 2}, fixed_view_idx=0,
                  data_chunk_size=chunk)
        jm = sat.VariationalGPSA(dd, **kw)
        keys = jax.random.split(jax.random.PRNGKey(0), R)
        loss = lambda p, k: jcore.negative_elbo(jm.spec, p, jm.consts, jm._batch, k, S, 1.0)
        params_R = jax.tree.map(lambda x: jnp.stack([x] * R), jm.params)
        wide_j = jax.jit(jax.vmap(jax.value_and_grad(loss))).lower(params_R, keys).compile()
        one_j = jax.jit(jax.value_and_grad(loss)).lower(jm.params, keys[0]).compile()

        tm = tp.VariationalGPSA(dd, device="cpu", **kw)
        params = tree_map(lambda v: v.requires_grad_(True), tm._restart_inits(R, 0))
        wn, dn, _ = tcore.draw_restart_noise(tm.spec, R, S, torch.Generator().manual_seed(0),
                                             tm.device)
        tm._draw_restart_noise = lambda R_, S_: (wn, dn, None)
        alone = tree_map(lambda v: v.detach()[0].clone().requires_grad_(True), params)
        saved = []

        def pack(t):
            saved.append(t.numel() * t.element_size())
            return t

        def saved_bytes(fn):
            saved.clear()
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                fn()
            return sum(saved)

        out[f"chunk_{chunk}"] = {
            "jax_vmap_temp_bytes": wide_j.memory_analysis().temp_size_in_bytes,
            "jax_one_temp_bytes": one_j.memory_analysis().temp_size_in_bytes,
            "port_vmap_saved_bytes": saved_bytes(
                lambda: tm._restart_step_loss(S, None, R, params)(1.0)),
            "port_one_saved_bytes": saved_bytes(lambda: tcore.negative_elbo(
                tm.spec, alone, tm.consts, tm._batch, S, 1.0, warp_noise=wn[0],
                data_noise={k: v[0] for k, v in dn.items()})),
        }
    whole, chunked = out["chunk_None"], out["chunk_16"]
    out["chunked_over_whole"] = {k: chunked[k] / whole[k] for k in whole}
    print(json.dumps({"restarts": R, "S": S, "points": 60, "m": 8, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
