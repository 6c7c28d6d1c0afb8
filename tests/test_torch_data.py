"""PyTorch port: ``data/`` against the JAX package's.

The generators, warps and synthetic_*_like stand-ins give identical arrays
for the same ``default_rng`` seed (the same numpy code). ``load_h5ad`` gives
the same dict key by key. The CSV loaders read without pandas, with
``np.loadtxt``'s correctly rounded parse, where pandas's default float
converter is not always correctly rounded: their numbers are pandas's
within rel 1e-12 in float64 and bit for bit after the command line's
float32 cast, so its float32 data is the JAX package's. The k-NN filters run on ``cKDTree`` where JAX's use sklearn, and agree
on tie-free coordinates. 1-D generated data trains the port's model on the
CPU.
"""

import csv
import os

import numpy as np
import pandas as pd
import pytest
import torch

import spatial_alignment_tpu.data as jdata
import spatial_alignment_tpu_torch.data as tdata
from spatial_alignment_tpu_torch import VariationalGPSA
from spatial_alignment_tpu_torch.data import realdata as trealdata

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "tiny_sparse.h5ad")


def _grid(n=5):
    ax = np.linspace(0, 10, n)
    a, b = np.meshgrid(ax, ax)
    return np.stack([a.ravel(), b.ravel()], 1)


def _outputs(x, p=3):
    return np.stack([np.sin(x[:, 0] * (j + 1) / 3.0) + np.cos(x[:, 1]) for j in range(p)], 1)


# (name, call(module, rng) -> result); each runs on both packages' data modules.
_GENERATORS = [
    ("oned_affine", lambda m, r: m.generate_oned_data_affine_warp(2, 3, 15, rng=r)),
    ("oned_affine_lmc", lambda m, r: m.generate_oned_data_affine_warp(
        3, 4, 12, noise_variance=0.01, n_latent_gps=2, rng=r)),
    ("oned_gp", lambda m, r: m.generate_oned_data_gp_warp(2, 3, 20, rng=r)),
    ("oned_gp_lmc", lambda m, r: m.generate_oned_data_gp_warp(
        2, 5, 20, n_latent_gps=3, noise_variance=0.01, mean_slope=0.9, rng=r)),
    ("oned_gp_two_output_lmc", lambda m, r: m.generate_oned_data_gp_warp(
        2, 2, 20, n_latent_gps=1, rng=r)),
    ("twod_fixed_view", lambda m, r: m.generate_twod_data(2, 3, 5, fixed_view_idx=0, rng=r)),
    ("twod_lmc", lambda m, r: m.generate_twod_data(
        3, 4, 4, n_latent_gps=2, noise_variance=0.001, rng=r)),
    ("twod_partial_overlap", lambda m, r: m.generate_twod_data_partial_overlap(2, 3, 6, rng=r)),
    ("twod_partial_overlap_lmc", lambda m, r: m.generate_twod_data_partial_overlap(
        2, 4, 6, n_latent_gps=2, rng=r)),
    ("gp_warp", lambda m, r: m.apply_gp_warp(_grid(), _outputs(_grid()), 2,
                                            noise_variance=0.01, rng=r)),
    ("gp_warp_multimodal", lambda m, r: m.apply_gp_warp_multimodal(
        [_grid(4), _grid(3) + 1.0], [_outputs(_grid(4)), _outputs(_grid(3), 2)], 2,
        noise_variance=0.01, kernel_lengthscale=3.0, rng=r)),
    ("linear_warp", lambda m, r: m.apply_linear_warp(_grid(), _outputs(_grid()), 3, rng=r)),
    ("polar_warp", lambda m, r: m.apply_polar_warp(_grid(), _outputs(_grid()), 2,
                                                  linear_slope_variance=0.3, rng=r)),
    ("synthetic_visium_like", lambda m, r: m.synthetic_visium_like(
        n_spots=60, n_genes=4, n_slices=3, seed=3)),
    ("synthetic_slideseq_like", lambda m, r: m.synthetic_slideseq_like(
        n_beads=250, n_genes=3, seed=2)),
    ("synthetic_st_like", lambda m, r: m.synthetic_st_like(
        n_slices=3, grid_size=5, n_genes=4, seed=1)),
]


def _assert_identical(got, want):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_identical(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("call", [c for _, c in _GENERATORS], ids=[n for n, _ in _GENERATORS])
def test_generators_identical_to_jax(call):
    got = call(tdata, np.random.default_rng(0))
    want = call(jdata, np.random.default_rng(0))
    _assert_identical(got, want)


def test_data_exports_every_jax_name():
    from spatial_alignment_tpu.data import realdata, simulated, warps

    for mod in (realdata, simulated, warps):
        for name in mod.__all__:
            assert callable(getattr(tdata, name)), name
    assert sorted(tdata.__all__) == sorted(
        realdata.__all__ + simulated.__all__ + warps.__all__)


# ---------------------------------------------------------------------------
# load_h5ad
# ---------------------------------------------------------------------------


def _write_h5ad(path, layout, rng):
    """An anndata-0.8-style file: X dense, CSR or CSC, a categorical and a
    plain obs column (the categorical with a missing code), var names."""
    import h5py
    from scipy import sparse

    X = rng.poisson(1.0, (14, 6)).astype(np.float32)
    with h5py.File(path, "w") as f:
        if layout == "dense":
            f.create_dataset("X", data=X)
        else:
            mat = sparse.csr_matrix(X) if layout == "csr" else sparse.csc_matrix(X)
            g = f.create_group("X")
            g.attrs["encoding-type"] = f"{layout}_matrix".encode()
            g.attrs["shape"] = X.shape
            g.create_dataset("data", data=mat.data)
            g.create_dataset("indices", data=mat.indices)
            g.create_dataset("indptr", data=mat.indptr)
        f.create_dataset("obsm/spatial", data=rng.uniform(0, 10, (14, 2)).astype(np.float32))
        batch = f.create_group("obs/batch")
        batch.create_dataset("codes", data=np.array([0] * 6 + [1] * 7 + [-1], np.int8))
        batch.create_dataset("categories", data=np.array([b"s1", b"s2"], dtype="S2"))
        f.create_dataset("obs/depth", data=X.sum(1).astype(np.float64))
        f.create_dataset("obs/_index", data=np.array([f"c{i}".encode() for i in range(14)]))
        f.create_dataset("var/_index", data=np.array([f"g{i}".encode() for i in range(6)]))


@pytest.mark.parametrize("layout", ["committed", "dense", "csr", "csc"])
def test_load_h5ad_equals_jax(tmp_path, layout):
    if layout == "committed":
        path = FIXTURE
    else:
        path = str(tmp_path / f"{layout}.h5ad")
        _write_h5ad(path, layout, np.random.default_rng(4))
    got, want = tdata.load_h5ad(path), jdata.load_h5ad(path)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])


# ---------------------------------------------------------------------------
# CSV loaders without pandas
# ---------------------------------------------------------------------------


def _values(rng, kind, shape):
    """Numbers as the files carry them: float64, float32, integers."""
    if kind == "int":
        return rng.poisson(4.0, shape)
    x = rng.standard_normal(shape) * 10.0 ** rng.integers(-6, 6, shape)
    return x.astype(np.float32) if kind == "float32" else x


def _write_counts(path, values, fmt, index, names):
    """Spots x genes under a header, the spot label first: ``np.savetxt``
    with ``fmt`` or, with ``fmt=None``, the ``csv`` module's ``str``."""
    if fmt is None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["spot"] + names)
            for label, row in zip(index, values):
                w.writerow([label] + [str(v) for v in row])
        return
    body = np.column_stack([np.asarray(index, object), values.astype(object)])
    np.savetxt(path, body, delimiter=",", header=",".join(["spot"] + names), comments="",
               fmt=["%s"] + [fmt] * values.shape[1])


# (values kind, coords format, counts format): np.savetxt's default %.18e,
# float32 at %.9g, csv's repr-like str, integers.
_CSV_CASES = [("float64", "%.18e", "%.18e"), ("float32", "%.9g", "%.9g"),
              ("float64", None, None), ("int", "%d", "%d"), ("float64", "%.17g", "%.6f")]


@pytest.mark.parametrize("kind,cfmt,yfmt", _CSV_CASES,
                         ids=["savetxt", "float32", "csv_str", "int", "mixed_formats"])
def test_load_csv_expression_equals_jax(tmp_path, kind, cfmt, yfmt):
    rng = np.random.default_rng(5)
    coords, counts = _values(rng, kind, (23, 3)), _values(rng, kind, (23, 7))
    cpath, ypath = str(tmp_path / "xy.csv"), str(tmp_path / "y.csv")
    if cfmt is None:
        with open(cpath, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["x", "y", "z"])
            w.writerows([[str(v) for v in row] for row in coords])
    else:
        np.savetxt(cpath, coords, delimiter=",", header="x,y,z", comments="", fmt=cfmt)
    _write_counts(ypath, counts, yfmt, [f"s{i}" for i in range(23)],
                  [f"g{j}" for j in range(7)])
    got, want = trealdata.load_csv_expression(cpath, ypath), jdata.load_csv_expression(
        cpath, ypath)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64 and g.shape == w.shape
        # pandas's numbers within the float parsers' rel 1e-12, and bit for
        # bit after the command line's float32 cast
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
        np.testing.assert_array_equal(g.astype(np.float32), w.astype(np.float32))
    if kind == "float32":
        np.testing.assert_array_equal(got[1].astype(np.float32), counts)


def _write_st_slices(tmp_path, rng):
    """Three ST slices over overlapping gene sets, 'AxB' spot labels; some
    genes integer, some float, the integer ones with tied totals."""
    genes = [f"G{i:02d}" for i in range(40)]
    paths = []
    for s in range(3):
        names = genes[s:] if s else genes[:-2]
        cols = []
        for g in names:
            i = int(g[1:])
            if i % 3 == 0:
                cols.append(np.full(20, i % 4))  # tied totals within each slice
            else:
                cols.append(np.round(rng.gamma(2.0, 3.0, 20), 3))
        values = np.column_stack(cols).astype(object)
        index = [f"{i}.5x{j}" for i in range(4) for j in range(5)]
        path = str(tmp_path / f"slice{s}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow([""] + names)
            for label, row in zip(index, values):
                w.writerow([label] + [str(v) for v in row])
        paths.append(path)
    return paths


@pytest.mark.parametrize("n_genes", [None, 4, 21, 36])
def test_load_st_data_equals_jax(tmp_path, n_genes):
    paths = _write_st_slices(tmp_path, np.random.default_rng(6))
    got = trealdata.load_st_data(paths, n_genes=n_genes)
    want = jdata.load_st_data(paths, n_genes=n_genes)
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list) == 3
        for g, w in zip(g_list, w_list):
            assert g.dtype == w.dtype and g.shape == w.shape
            if g.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
                np.testing.assert_array_equal(g.astype(np.float32), w.astype(np.float32))
            else:
                np.testing.assert_array_equal(g, w)
    assert got[0][0].shape == (20, 2)


def test_csv_numbers_match_pandas_within_tolerance(tmp_path):
    """The reader against pandas on numbers spelled every way numpy and
    Python spell them, and past the 17 digits pandas keeps."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(3000) * 10.0 ** rng.integers(-300, 300, 3000)
    fields = [f % v for v in x for f in ("%.18e", "%.17g", "%.9g", "%.3f")]
    fields += [repr(float(v)) for v in x] + [
        "1", "-0", "0.5", ".5", "5.", "+3.25", "1E-5", "7e+02",
        "123456789012345678901234", "0.0000000000000000000000001234567890123456789"]
    path = tmp_path / "v.csv"
    path.write_text("v\n" + "\n".join(fields) + "\n")
    want = pd.read_csv(str(path)).to_numpy(float)[:, 0]
    got = trealdata._read_csv(str(path), index_col=False).values()[:, 0]
    # Correctly rounded, as Python's float; pandas's converter is not: on
    # the random fields the two differ in float64, by rel 1e-12 at most,
    # and never in float32. pandas's 17 digits count zeros after the point:
    # the last field reads 0 there.
    exact = np.array([float(f) for f in fields])
    np.testing.assert_array_equal(got.view(np.int64), exact.view(np.int64))
    n = len(fields) - 1
    assert (got[:n] != want[:n]).sum() > n // 10
    np.testing.assert_allclose(got[:n], want[:n], rtol=1e-12, atol=0)
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(got[:n].astype(np.float32), want[:n].astype(np.float32))
    assert want[-1] == 0.0 and got[-1] > 0.0


@pytest.mark.parametrize("body,message", [
    ("a,b\n1,\n", "could not convert string ''"),
    ("a,b\n1,NA\n", "could not convert string 'NA'"),
    ("a,b\n1,2,3\n", "have 3 fields"),
    ("a,b\n1,2\n3,4,5\n", "number of columns changed"),
    ("a,a\n1,2\n", "duplicate column names"),
], ids=["empty", "na", "ragged", "ragged_rows", "duplicate"])
def test_csv_reader_refuses_what_it_does_not_read(tmp_path, body, message):
    path = tmp_path / "t.csv"
    path.write_text(body)
    with pytest.raises(ValueError, match=message):
        trealdata._read_csv(str(path), index_col=False)


# ---------------------------------------------------------------------------
# k-NN filters and rotation
# ---------------------------------------------------------------------------

_FILTERS = [
    ("knn_r2_1", lambda m, X, Y: m.knn_r2_gene_filter(X, Y, n_genes=5)),
    ("knn_r2_3", lambda m, X, Y: m.knn_r2_gene_filter(X, Y, n_genes=8, n_neighbors=3)),
    ("outliers", lambda m, X, Y: m.remove_outlier_spots(X, n_neighbors=10, quantile=0.95)),
    ("outliers_default", lambda m, X, Y: m.remove_outlier_spots(X)),
    ("rotate", lambda m, X, Y: m.rotate_coords(X, 33.0)),
]


@pytest.mark.parametrize("call", [c for _, c in _FILTERS], ids=[n for n, _ in _FILTERS])
def test_knn_filters_and_rotation_equal_jax(call):
    rng = np.random.default_rng(8)
    X = rng.uniform(0, 10, (150, 2))  # continuous draws: no tied distances
    X[:3] += 60.0
    Y = np.column_stack([np.sin(X[:, 0]), rng.standard_normal((150, 7)), np.cos(X[:, 1])])
    got, want = call(trealdata, X, Y), call(jdata, X, Y)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_oned_generated_data_trains_the_port_model():
    X, Y, nsl, _ = tdata.generate_oned_data_gp_warp(2, 3, 20, rng=np.random.default_rng(9))
    dd = {"expression": {"spatial_coords": X.astype(np.float32),
                         "outputs": Y.astype(np.float32), "n_samples_list": nsl}}
    model = VariationalGPSA(dd, m_X_per_view=6, m_G=6, fixed_view_idx=0, device="cpu")
    losses = model.fit(n_epochs=1, lr=1e-2, S=2)
    assert losses.shape == (1,) and np.isfinite(losses).all()
    assert model.spec.n_spatial_dims == 1
