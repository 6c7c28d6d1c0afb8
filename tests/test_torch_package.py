"""PyTorch port: the package stands alone, and its data generator is the
JAX package's.

The port may import torch, numpy and scipy only. A fresh interpreter
imports it and lists what got loaded: no jax, optax, sklearn or h5py, and
no module of the JAX package (``spatial_alignment_tpu`` itself or anything
under ``spatial_alignment_tpu.``; the port's own name starts with the same
letters, so the match is exact).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from spatial_alignment_tpu.data import simulated as jsim
from spatial_alignment_tpu_torch.data import generate_twod_data

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, sys
import spatial_alignment_tpu_torch
import spatial_alignment_tpu_torch.data
import spatial_alignment_tpu_torch.models.convert
import spatial_alignment_tpu_torch.ops.cholesky
import spatial_alignment_tpu_torch.models.train
import spatial_alignment_tpu_torch.utils.checkpoint
import spatial_alignment_tpu_torch.utils.convergence
import spatial_alignment_tpu_torch.utils.profiling
import spatial_alignment_tpu_torch.utils.prealign
import spatial_alignment_tpu_torch.utils.ot
import spatial_alignment_tpu_torch.models.multistart
import spatial_alignment_tpu_torch.models.mle
import spatial_alignment_tpu_torch.ops.precision
import spatial_alignment_tpu_torch.ops.quad
import spatial_alignment_tpu_torch.utils
import spatial_alignment_tpu_torch.utils.preprocess
import spatial_alignment_tpu_torch.utils.metrics
import spatial_alignment_tpu_torch.utils.gsea
print(json.dumps(sorted(sys.modules)))
"""


def test_import_loads_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _ROOT
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=_ROOT, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    roots = {name.split(".")[0] for name in loaded}
    for banned in ("jax", "jaxlib", "optax", "sklearn", "h5py"):
        assert banned not in roots, banned
    jax_pkg = [
        name for name in loaded
        if name == "spatial_alignment_tpu" or name.startswith("spatial_alignment_tpu.")
    ]
    assert jax_pkg == []
    assert "spatial_alignment_tpu_torch" in loaded


@pytest.mark.parametrize(
    "kw",
    [
        dict(n_views=2, n_outputs=4, grid_size=6, fixed_view_idx=0),
        dict(n_views=2, n_outputs=5, grid_size=5, n_latent_gps=2, kernel_lengthscale=5.0,
             kernel_variance=0.5, noise_variance=0.001, fixed_view_idx=0),
    ],
    ids=["plain", "lmc"],
)
def test_generate_twod_data_identical_to_jax_package(kw):
    got = generate_twod_data(rng=np.random.default_rng(0), **kw)
    want = jsim.generate_twod_data(rng=np.random.default_rng(0), **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert list(got[2]) == list(want[2])
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(want[3]))
