"""Shared set-up of the benchmark's own tests (run them from the repo root:
``python -m pytest gpsa_bench/tests -q``; the card-only test skips without
a card). The small cells here keep every shape of a cell and shrink its
sizes so that a CPU run takes a few seconds."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small(resolved: dict, grid: int = 12, m: int = 24, latent: int = 3, outputs: int = 6,
          samples: int = 2, epochs: int = 3, minibatch: int = 48) -> dict:
    """A resolved cell at CPU-test sizes: fewer spots, inducing points,
    latents, outputs, samples and epochs a call; the rest as the cell."""
    r = copy.deepcopy(resolved)
    data = r["config"]["data"]
    if "grid_size" in data:
        data.update(grid_size=grid, n_outputs=outputs, n_latent=latent)
    else:
        data.update(n_per_view=4 * grid * grid, n_outputs=outputs)
    r["config"]["model"].update(m_X_per_view=m, m_G=m, n_latent_gps=latent,
                                data_chunk_size=None)
    r["config"]["train"]["S"] = samples
    r["traffic"]["n_epochs"] = epochs
    if r["traffic"].get("minibatch_size"):
        r["traffic"]["minibatch_size"] = minibatch
    return r


@pytest.fixture(scope="session")
def harness():
    from gpsa_bench import harness

    return harness
