"""Carry weights across from the JAX package.

``params_from_numpy`` turns the JAX package's parameter and constant trees
(nested dicts of numpy arrays, e.g. ``jax.tree.map(np.asarray,
model.params)``) into the port's tensors; ``params_into`` writes such trees
into a port model's own tensors in place, for a ``VariationalGPSA`` or a
``WarpGPMLE`` (whose params carry the aligned coordinates ``G``) built on
the same data. ``load_jax_checkpoint`` rebuilds a
port ``VariationalGPSA`` from a self-contained checkpoint written by the JAX
package's ``save()`` (an ``.npz`` with ``params/``, ``consts/`` and
``data/`` sections and a ``.json`` manifest holding the spec), read through
:mod:`..utils.checkpoint`, the format both packages write.

A checkpoint of a model the JAX package distributed over a model axis
carries ``merged_factor_dispatch=False`` in its spec; the port loads it
like any other (each modality's ``Omega_sqt_F`` slab then factored in its
own call), and the loaded model distributes like any other
(:func:`..parallel.distribute`).

Optimizer state and RNG keys do not carry over: optax moments and
``jax.random`` keys have no counterpart in ``torch.optim`` and
``torch.Generator``, so a loaded model starts a fresh optimizer and a
generator seeded from the manifest's ``seed`` (0 if absent).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["params_from_numpy", "params_into", "load_jax_checkpoint", "tensors_from_numpy"]


def tensors_from_numpy(tree, device):
    """A nested dict of arrays as float32 tensors on ``device`` (copies)."""
    if isinstance(tree, dict):
        return {k: tensors_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def params_from_numpy(params: dict, consts: dict, device=None) -> Tuple[dict, dict]:
    """(params, consts) as float32 tensors on ``device`` (None = "cuda")."""
    dev = resolve_device(device)
    return tensors_from_numpy(params, dev), tensors_from_numpy(consts, dev)


def params_into(model, params: dict, consts: dict) -> None:
    """Write the JAX package's (params, consts) trees into ``model``'s
    tensors in place, leaf by leaf path. The trees must hold the model's
    leaves with their shapes (a JAX model of the same class built on the
    same data and options)."""
    from ._trees import named_leaves

    for name, mine, theirs in (("params", model.params, params), ("consts", model.consts, consts)):
        got = dict(named_leaves(tensors_from_numpy(theirs, "cpu")))
        want = dict(named_leaves(mine))
        shapes = lambda d: sorted((k, tuple(t.shape)) for k, t in d.items())
        if shapes(got) != shapes(want):
            raise ValueError(f"{name}: {shapes(got)} does not match the model's {shapes(want)}")
        with torch.no_grad():
            for path, dst in want.items():
                dst.copy_(got[path])


def load_jax_checkpoint(path: str, device=None):
    """A port ``VariationalGPSA`` rebuilt from a JAX ``save()`` checkpoint
    (``VariationalGPSA.load``). Needs the spec in the manifest (a
    self-contained checkpoint). Without a ``data/`` section the model can
    predict but not fit."""
    from .vgpsa import VariationalGPSA

    return VariationalGPSA.load(path, device=device)
