"""Checkpoints: a flat ``.npz`` of the model's trees and a ``.json`` manifest.

The format is the JAX package's (``spatial_alignment_tpu/utils/checkpoint.py``),
copied here because the port imports nothing of that package. Keys of the
npz are ``<section>/<slash-joined path>``; the sections ``params/``,
``consts/`` and ``data/`` (the packed training batch) mean the same in both
packages, so each reads the other's parameters. The port writes its own
training state in sections the JAX loader skips: ``torch_opt/<leaf
path>/<state name>`` (the optimizer's per-parameter state, e.g. Adam's
``exp_avg``, ``exp_avg_sq`` and ``step``) and ``torch_rng/state`` (the
model generator's ``get_state()`` bytes). The JAX package's ``opt/`` and
``rng/key`` (optax moments, a ``jax.random`` key) are read into the blob
but have no counterpart in ``torch.optim`` or ``torch.Generator``.

The manifest sits beside the npz as ``<file>.npz.json`` and holds ``step``
(the epoch the training state belongs to), ``seed`` and, for a
self-contained checkpoint, the serialized ``spec``.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "flatten",
    "load_checkpoint",
    "load_checkpoint_blob",
    "nest",
    "read_manifest",
    "save_checkpoint",
    "unflatten_into",
]


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def flatten(tree, prefix: str = "") -> dict:
    """{slash-joined path: numpy array} of a nested dict of arrays/tensors
    (an empty subtree has no entries)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: _numpy(tree)}


def nest(flat: dict) -> dict:
    """The nested dict of slash-joined paths (inverse of :func:`flatten`)."""
    out: dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = arr
    return out


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(
    path: str,
    params,
    consts=None,
    step: Optional[int] = None,
    extra: Optional[dict] = None,
    spec=None,
    batch=None,
    opt_state: Optional[dict] = None,
    rng_state=None,
):
    """Write params (and consts) to ``path`` (.npz) with its manifest.

    Optional sections: ``spec`` (a ModelSpec, into the manifest), ``batch``
    (the packed training batch, ``data/``), ``opt_state`` ({leaf path:
    {state name: tensor}}, ``torch_opt/``) and ``rng_state`` (a generator's
    ``get_state()``, ``torch_rng/state``).
    """
    npz = _npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(npz)) or ".", exist_ok=True)
    sections = (("params", params), ("consts", consts), ("data", batch),
                ("torch_opt", opt_state))
    payload = {}
    for name, tree in sections:
        if tree is not None:
            payload.update({f"{name}/{k}": v for k, v in flatten(tree).items()})
    if rng_state is not None:
        payload["torch_rng/state"] = _numpy(rng_state)
    np.savez(npz, **payload)
    manifest = {"step": step, "n_leaves": len(payload)}
    if spec is not None:
        from ..models.spec import spec_to_dict

        manifest["spec"] = spec_to_dict(spec)
    if extra:
        manifest.update(extra)
    with open(npz + ".json", "w") as f:
        json.dump(manifest, f, indent=2)


def read_manifest(path: str) -> dict:
    """The manifest beside the checkpoint ({} if there is none). The JAX
    package writes it as ``<path>.json`` when ``path`` lacks ``.npz``, so
    that name is tried second."""
    for mpath in (_npz_path(path) + ".json", path + ".json"):
        if os.path.exists(mpath):
            with open(mpath) as f:
                return json.load(f)
    return {}


def load_checkpoint_blob(path: str) -> dict:
    """Raw contents: {"params", "consts", "data", "opt", "torch_opt": flat
    {path: array}, "rng_key", "torch_rng": array or None, "manifest": dict}."""
    blob = {"params": {}, "consts": {}, "data": {}, "opt": {}, "torch_opt": {}}
    blob["rng_key"] = blob["torch_rng"] = None
    with np.load(_npz_path(path)) as data:
        for k in data.files:
            if k == "rng/key":
                blob["rng_key"] = np.asarray(data[k])
            elif k == "torch_rng/state":
                blob["torch_rng"] = np.asarray(data[k])
            else:
                sec, _, rest = k.partition("/")
                if sec in blob:
                    blob[sec][rest] = data[k]
    blob["manifest"] = read_manifest(path)
    return blob


def unflatten_into(template, flat: dict, prefix: str = ""):
    """A tree shaped like ``template`` (nested dict of tensors) from a flat
    {path: array}, each leaf on its template's device and dtype; raises on
    a missing leaf or a shape that differs."""
    if isinstance(template, dict):
        return {k: unflatten_into(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = np.asarray(flat[key])
    if arr.shape != tuple(template.shape):
        raise ValueError(
            f"checkpoint leaf {key!r} shape {arr.shape} != model {tuple(template.shape)}"
        )
    return torch.as_tensor(arr, dtype=template.dtype).to(template.device)


def load_checkpoint(path: str, params_template, consts_template=None) -> Tuple:
    """(params[, consts]) shaped like the templates, read from ``path``."""
    blob = load_checkpoint_blob(path)
    params = unflatten_into(params_template, blob["params"])
    if consts_template is None:
        return params
    return params, unflatten_into(consts_template, blob["consts"])
