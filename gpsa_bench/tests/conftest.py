"""Shared set-up of the benchmark's own tests (run them from the repo root:
``python -m pytest gpsa_bench/tests -q``; the card-only test skips without
a card). The small cells here keep every shape of a cell and shrink its
sizes so that a CPU run takes a few seconds."""

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small(resolved: dict, grid: int = 12, m: int = 24, latent: int = 3, outputs: int = 6,
          samples: int = 2, epochs: int = 3, minibatch: int = 48) -> dict:
    """A resolved cell at CPU-test sizes: fewer spots, inducing points,
    latents, outputs, samples and epochs a call; the rest as the cell. Where
    ``n_latent_gps`` is an object, each LMC modality gets ``latent`` and a
    modality without LMC keeps none."""
    r = copy.deepcopy(resolved)
    data = r["config"]["data"]
    if "grid_size" in data:
        data.update(grid_size=grid, n_outputs=outputs, n_latent=latent)
    else:
        data.update(n_per_view=4 * grid * grid, n_outputs=outputs)
    model = r["config"]["model"]
    n = model["n_latent_gps"]
    lmc = {k: None if v is None else latent for k, v in n.items()} if isinstance(n, dict) \
        else latent
    model.update(m_X_per_view=m, m_G=m, n_latent_gps=lmc, data_chunk_size=None)
    r["config"]["train"]["S"] = samples
    r["traffic"]["n_epochs"] = epochs
    if r["traffic"].get("minibatch_size"):
        r["traffic"]["minibatch_size"] = minibatch
    return r


@pytest.fixture(scope="session")
def harness():
    from gpsa_bench import harness

    return harness


# Faults planted in the program's timed path; a run with any of them is not
# correct.


@pytest.fixture
def unchanged_state(monkeypatch):
    """Each training step hands back the parameters it was given."""
    from spatial_alignment_tpu_torch.models import train

    step = train.TrainLoop._step

    def frozen(self):
        saved = [leaf.detach().clone() for leaf in self.leaves]
        step(self)
        self._put_back(saved)

    monkeypatch.setattr(train.TrainLoop, "_step", frozen)


@pytest.fixture
def half_batch(monkeypatch):
    """The likelihood over the first half of each view's points, doubled."""
    from spatial_alignment_tpu_torch.models import core

    def half(y, f, scale, mask):
        h = y.shape[-2] // 2
        return 2.0 * core.gaussian_loglik_sum.__wrapped__(
            y[..., :h, :], f[..., :h, :], scale, mask[..., :h])

    half.__wrapped__ = core.gaussian_loglik_sum
    monkeypatch.setattr(core, "gaussian_loglik_sum", half)


@pytest.fixture
def warp_mean_altered(monkeypatch):
    """The warp layer's aligned coordinates moved by 0.01 where they are
    produced."""
    from spatial_alignment_tpu_torch.models import core

    layer = core.warp_layer

    def moved(spec, *args, **kwargs):
        mu, samples, aux = layer(spec, *args, **kwargs)
        keep = torch.tensor([1.0 if f else 0.0 for f in spec.fixed_view_mask],
                            dtype=mu.dtype, device=mu.device)[:, None, None]
        return mu + 0.01 * (1 - keep), samples + 0.01 * (1 - keep), aux

    monkeypatch.setattr(core, "warp_layer", moved)
