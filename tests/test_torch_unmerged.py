"""PyTorch port: ``merged_factor_dispatch=False`` in one process.

The JAX package's ``parallel.distribute`` clears the option when the model
axis shards the variational state, and its checkpoints carry it: each
modality's ``Omega_sqt_F`` slab is then factored in its own call
(``core.compute_factors``) and its KL terms taken in a call of their own
(``core.kl_divergence``), while the replicated Grams still merge. Here, on
two modalities (one with the LMC) and in the square, triangular and whitened
parameterizations, the port's loss and gradients with the option cleared
hold against JAX's at JAX's draws (loss rel 1e-5, gradients rel 2e-3 a
leaf, as ``tests/test_torch_variational.py``), and against the port's own
merged dispatch (loss rel 1e-6, gradients rel 1e-5).
"""

import dataclasses

import jax
import pytest
import torch

from spatial_alignment_tpu_torch.models import core as tcore

from test_torch_model import _jit_value_and_grad, _rel, jax_noise, leaf
from test_torch_variational import KW, _two_modalities, pair

torch.set_num_threads(1)

MODES = {"square": {}, "triangular": {"triangular_variational": True},
         "whitened": {"whitened_variational": True}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_unmerged_loss_and_grads_match_jax_and_merged(mode):
    kw = {**KW, "n_latent_gps": {"expression": 2, "protein": None}, **MODES[mode]}
    jm, tm = pair(_two_modalities(), **kw)
    jm.spec = dataclasses.replace(jm.spec, merged_factor_dispatch=False)
    merged_spec = tm.spec
    tm.spec = dataclasses.replace(tm.spec, merged_factor_dispatch=False)
    S, key = 2, jax.random.PRNGKey(3)
    loss_j, grads_j = _jit_value_and_grad(jm.spec, jm.params, jm.consts, jm._batch, key, S, 1.0)
    warp, data = jax_noise(jm.spec, key, S)

    def loss_grads(spec):
        for t in tm.parameters():
            t.grad = None
        loss = tcore.negative_elbo(spec, tm.params, tm.consts, tm._batch, S, 1.0,
                                   warp_noise=warp, data_noise=data)
        loss.backward()
        return loss.item(), {id(t): t.grad.clone() for t in tm.parameters()}

    loss_m, grads_m = loss_grads(merged_spec)
    loss_u, grads_u = loss_grads(tm.spec)
    assert _rel(loss_u, loss_j) <= 1e-5
    assert _rel(loss_u, loss_m) <= 1e-6
    for path, g in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        t = leaf(tm.params, path)
        assert _rel(grads_u[id(t)], g) <= 2e-3, (jax.tree_util.keystr(path), _rel(grads_u[id(t)], g))
        assert _rel(grads_u[id(t)], grads_m[id(t)]) <= 1e-5, jax.tree_util.keystr(path)


def test_unmerged_kl_parts_name_each_modality():
    """Cleared, the KL comes in one term for the warp and one a modality,
    each named by its modality; their sum is kl_divergence's bit for bit."""
    jm, tm = pair(_two_modalities(), **{**KW, "n_latent_gps": {"expression": 2, "protein": None}})
    spec = dataclasses.replace(tm.spec, merged_factor_dispatch=False)
    hp = {**tm.consts, **tm.params}
    with torch.no_grad():
        res = tcore.forward(spec, hp, tm._batch, 1, generator=torch.Generator().manual_seed(0))
        parts = tcore.kl_parts(spec, hp, res.warp_aux, res.data_aux)
        total = tcore.kl_divergence(spec, hp, res.warp_aux, res.data_aux)
    assert [name for name, _ in parts] == [None, "expression", "protein"]
    acc = torch.zeros(())
    for _, p in parts:
        acc = acc + p
    assert torch.equal(acc, total)
