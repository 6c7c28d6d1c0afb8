"""PyTorch port: the package stands alone, and its data generator is the
JAX package's.

The port may import torch, numpy and scipy only. A fresh interpreter
imports it and lists what got loaded: no jax, optax, sklearn, h5py, pandas
or matplotlib, and no module of the JAX package (``spatial_alignment_tpu``
itself or anything under ``spatial_alignment_tpu.``; the port's own name
starts with the same letters, so the match is exact). Another, where
sklearn, pandas, h5py and matplotlib cannot be imported, runs the metrics,
the k-NN filters, the CSV loaders and the command line's ``align`` and
``predict``; ``load_h5ad`` and the callbacks raise ``ImportError`` naming
their package.
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
import spatial_alignment_tpu_torch.data.realdata
import spatial_alignment_tpu_torch.plotting
import spatial_alignment_tpu_torch.cli
import spatial_alignment_tpu_torch.__main__
import spatial_alignment_tpu_torch.parallel
import spatial_alignment_tpu_torch.parallel.sharding
import spatial_alignment_tpu_torch.parallel.shardmap
import torch.distributed
assert not torch.distributed.is_initialized()
print(json.dumps(sorted(sys.modules)))
"""


def _run(code, cwd=_ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _ROOT
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )


def test_import_loads_no_jax_and_no_jax_package():
    out = _run(_PROBE)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    roots = {name.split(".")[0] for name in loaded}
    for banned in ("jax", "jaxlib", "optax", "sklearn", "h5py", "pandas", "matplotlib"):
        assert banned not in roots, banned
    jax_pkg = [
        name for name in loaded
        if name == "spatial_alignment_tpu" or name.startswith("spatial_alignment_tpu.")
    ]
    assert jax_pkg == []
    assert "spatial_alignment_tpu_torch" in loaded


_BLOCKED = """
import sys
for name in ("sklearn", "pandas", "h5py", "matplotlib"):
    sys.modules[name] = None  # import raises ImportError
import json, os
import numpy as np
import torch
torch.set_num_threads(1)
from spatial_alignment_tpu_torch.utils.metrics import morans_i, morans_i_test
from spatial_alignment_tpu_torch.data import (
    knn_r2_gene_filter, load_csv_expression, load_h5ad, load_st_data, remove_outlier_spots)
from spatial_alignment_tpu_torch.plotting import callback_twod
from spatial_alignment_tpu_torch.cli import main

rng = np.random.default_rng(0)
X = rng.uniform(0, 10, (40, 2))
Y = np.column_stack([X[:, 0] / 10, rng.standard_normal(40)])
done = {"morans_i": morans_i(X, Y).tolist(),
        "morans_i_test": morans_i_test(X, Y)["I"].tolist(),
        "knn_r2": knn_r2_gene_filter(X, Y, 1, n_neighbors=3).tolist(),
        "outliers": int(remove_outlier_spots(X, quantile=0.9).sum())}
args = ["align"]
for v, x in enumerate((X[:20], X[:20] + 0.05)):
    np.savetxt(f"xy{v}.csv", x, delimiter=",", header="x,y", comments="")
    np.savetxt(f"y{v}.csv", np.column_stack([np.arange(20), Y[:20]]), delimiter=",",
               header="spot,g0,g1", comments="")
    args += ["--coords", f"xy{v}.csv", "--counts", f"y{v}.csv"]
with open("st.csv", "w") as f:
    f.write(",g0,g1\\n1x2,3,4.5\\n2x2,1,0.5\\n")
done["csv"] = [a.shape for a in load_csv_expression("xy0.csv", "y0.csv")]
done["st"] = [a[0].shape for a in load_st_data(["st.csv"], n_genes=1)]
done["align"] = main(args + ["--template", "0", "--m", "5", "--epochs", "5",
                             "--print-every", "5", "--out", "out", "--device", "cpu"])
done["predict"] = main(["predict", "--checkpoint", "out/model.npz", "--out", "pred",
                        "--device", "cpu"])
for name, call in (("h5py", lambda: load_h5ad("none.h5ad")),
                   ("matplotlib", lambda: callback_twod(None, X, Y, {}, None, None))):
    try:
        call()
    except ImportError as e:
        done[name] = str(e)
print(json.dumps(done))
"""


def test_cli_and_host_functions_run_without_sklearn_pandas_h5py_matplotlib(tmp_path):
    out = _run(_BLOCKED, cwd=str(tmp_path))
    done = json.loads(out.stdout.strip().splitlines()[-1])
    assert np.isfinite(done["morans_i"]).all() and done["morans_i"] == done["morans_i_test"]
    assert done["knn_r2"] == [0] and 0 < done["outliers"] < 40
    assert done["csv"] == [[20, 2], [20, 2]] and done["st"] == [[2, 2], [2, 1], [1]]
    assert done["align"] == 0 and done["predict"] == 0
    assert len(np.loadtxt(tmp_path / "out" / "losses.csv", skiprows=1)) == 5
    assert np.loadtxt(tmp_path / "pred" / "pred_mean.csv", delimiter=",").shape == (40, 2)
    assert "h5py" in done["h5py"] and "matplotlib" in done["matplotlib"]


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
