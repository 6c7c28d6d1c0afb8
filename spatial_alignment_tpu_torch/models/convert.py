"""Carry weights across from the JAX package.

``params_from_numpy`` turns the JAX package's parameter and constant trees
(nested dicts of numpy arrays, e.g. ``jax.tree.map(np.asarray,
model.params)``) into the port's tensors. ``load_jax_checkpoint`` rebuilds a
port ``VariationalGPSA`` from a self-contained checkpoint written by the JAX
package's ``save()``: an ``.npz`` with ``params/``, ``consts/`` and
``data/`` sections and a ``.json`` manifest holding the spec. It reads them
with ``np.load`` and ``json`` only.

Optimizer state and RNG keys do not carry over: optax moments and
``jax.random`` keys have no counterpart in ``torch.optim`` and
``torch.Generator``, so a loaded model starts a fresh optimizer and a
generator seeded from the manifest's ``seed`` (0 if absent).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch

from .._device import resolve_device
from .spec import check_supported, spec_from_dict

__all__ = ["params_from_numpy", "load_jax_checkpoint"]


def _tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32), device=device)  # copies


def params_from_numpy(params: dict, consts: dict, device=None) -> Tuple[dict, dict]:
    """(params, consts) as float32 tensors on ``device`` (None = "cuda")."""
    dev = resolve_device(device)
    return _tensors(params, dev), _tensors(consts, dev)


def _nest(flat: Dict[str, np.ndarray]) -> dict:
    """Nested dict from slash-joined paths."""
    out: dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = np.asarray(arr)
    return out


def _paths(path: str) -> Tuple[str, str]:
    npz = path if path.endswith(".npz") else path + ".npz"
    for manifest in (npz + ".json", path + ".json"):
        if os.path.exists(manifest):
            return npz, manifest
    raise FileNotFoundError(f"no manifest {npz}.json beside the checkpoint")


def load_jax_checkpoint(path: str, device=None):
    """A port ``VariationalGPSA`` rebuilt from a JAX ``save()`` checkpoint.

    Needs the spec in the manifest (a self-contained checkpoint). Without a
    ``data/`` section the model can predict but not fit.
    """
    from .vgpsa import VariationalGPSA

    npz, manifest_path = _paths(path)
    with open(manifest_path) as f:
        manifest = json.load(f)
    if manifest.get("spec") is None:
        raise ValueError(f"{path} is not self-contained (no spec in its manifest)")
    spec = spec_from_dict(manifest["spec"])
    check_supported(spec)
    sections = {"params": {}, "consts": {}, "data": {}}
    with np.load(npz) as data:
        for k in data.files:
            sec, _, rest = k.partition("/")
            if sec in sections:
                sections[sec][rest] = data[k]
    dev = resolve_device(device)
    params, consts = params_from_numpy(
        _nest(sections["params"]), _nest(sections["consts"]), dev
    )
    params.setdefault("W", {})  # an empty subtree (no LMC) has no npz entries
    batch = _tensors(_nest(sections["data"]), dev) if sections["data"] else None

    model = VariationalGPSA.__new__(VariationalGPSA)
    model.device = dev
    model.spec = spec
    model._set_state(params, consts, batch, int(manifest.get("seed", 0)))
    fixed = [i for i, b in enumerate(spec.fixed_view_mask) if b]
    model.fixed_view_idx = None if not fixed else (fixed[0] if len(fixed) == 1 else fixed)
    model.n_latent_gps = {m.name: (m.n_latent if m.use_lmc else None) for m in spec.modalities}
    return model
