"""The benchmark's inputs, made from ``--seed`` on the device by the
generator a configuration names under ``"data": {"generator": ...}``.

The configuration's schema for its modalities:

- ``model.n_latent_gps`` is an integer, the one modality ``expression``
  through that many LMC latent GPs, or an object ``{modality: int | null}``
  in the model's modality order, where null is a modality without LMC (one
  GP per output);
- ``model.n_noise_variance_params`` is optional (the constructor's default,
  2); modality mm of M reads its noise from entry ``-M + mm``;
- ``data.n_outputs`` is the one modality's P, or ``{modality: P}``.

A generator is ``generators/<name>.py`` with

- ``make(data, gen, device)`` -> float32 coordinates (N, D), float32
  outputs (N, P) and per-view counts for the one modality, or
  ``{modality: (coordinates, outputs, counts)}`` in the model's modality
  order, all modalities over the same views (each modality's points view
  after view);
- ``points_per_view(data)`` -> the counts, or ``{modality: counts}``, as
  ``make`` gives them;
- ``SPATIAL_DIMS``, the coordinates' D.

The same seed gives the same arrays on the same device."""

from __future__ import annotations

import torch

from gpsa_bench import byname

__all__ = ["modalities", "n_outputs", "make_data", "points_per_view", "spatial_dims"]

# The modality of a configuration whose n_latent_gps is an integer.
EXPRESSION = "expression"


def _generator(cfg: dict):
    return byname.load("generators", cfg["data"]["generator"])


def modalities(cfg: dict) -> dict:
    """{modality: its LMC latent count, or None without LMC}, in the
    model's order."""
    n = cfg["model"]["n_latent_gps"]
    if isinstance(n, dict):
        return {k: None if v is None else int(v) for k, v in n.items()}
    return {EXPRESSION: int(n)}


def _by_modality(cfg: dict, made) -> dict:
    """A generator's (or the configuration's) one value or {modality: value}
    as {modality: value} in the model's order."""
    names = list(modalities(cfg))
    if not isinstance(made, dict):
        if len(names) != 1:
            raise ValueError(f"one value where the model has modalities {names}")
        return {names[0]: made}
    if list(made) != names:
        raise ValueError(f"values of modalities {list(made)}; the model has {names}")
    return made


def n_outputs(cfg: dict) -> dict:
    """{modality: P} of configuration ``cfg``'s data."""
    return {k: int(v) for k, v in _by_modality(cfg, cfg["data"]["n_outputs"]).items()}


def points_per_view(cfg: dict) -> dict:
    """{modality: per-view counts} of configuration ``cfg``'s data."""
    gen = _generator(cfg)
    return {k: list(v) for k, v in _by_modality(cfg, gen.points_per_view(cfg["data"])).items()}


def spatial_dims(cfg: dict) -> int:
    """D of configuration ``cfg``'s coordinates."""
    return int(_generator(cfg).SPATIAL_DIMS)


def make_data(cfg: dict, seed: int, device) -> dict:
    """{modality: (coords (N, D) float32, outputs (N, P) float32, per-view
    counts)} of configuration ``cfg`` from ``seed``, made on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) * 2 + 1)
    data = _by_modality(cfg, _generator(cfg).make(cfg["data"], gen, torch.device(device)))
    # The work counts (work/step.py) read these shapes from the configuration.
    want = {mod: (sum(nsl), spatial_dims(cfg), n_outputs(cfg)[mod], nsl)
            for mod, nsl in points_per_view(cfg).items()}
    got = {mod: (X.shape[0], X.shape[1], Y.shape[1], list(nsl))
           for mod, (X, Y, nsl) in data.items()}
    if got != want:
        raise ValueError(f"the generator made (points, D, P, counts) {got}; "
                         f"the configuration states {want}")
    return data
