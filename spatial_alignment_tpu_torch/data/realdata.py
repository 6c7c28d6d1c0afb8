"""Real-data loaders and experiment preprocessing (numpy and scipy, host side).

The port's own copy of ``spatial_alignment_tpu/data/realdata.py``: an
AnnData ``.h5ad`` reader, the Spatial Transcriptomics and generic CSV
loaders, the experiment-level filters the reference scripts write inline
(k-NN R^2 gene selection, k-NN distance outlier removal, a coarse rotation)
and the ``synthetic_*_like`` stand-ins for the reference's datasets.

It needs no pandas and no scikit-learn: the CSV loaders read with
``np.loadtxt`` (its C parser), and the neighbour searches run on
``scipy.spatial.cKDTree``.
Only ``load_h5ad`` needs an optional package, ``h5py``, imported when it is
called; without it that call raises ``ImportError``.
"""

from __future__ import annotations

import csv
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..ops.kernels import rbf_kernel_numpy
from ..utils.preprocess import get_st_coordinates

__all__ = [
    "load_h5ad",
    "load_st_data",
    "load_csv_expression",
    "knn_r2_gene_filter",
    "remove_outlier_spots",
    "rotate_coords",
    "synthetic_visium_like",
    "synthetic_slideseq_like",
    "synthetic_st_like",
]


def _read_sparse_group(g) -> np.ndarray:
    """Densify an AnnData sparse-encoded group (CSR or CSC)."""
    from scipy.sparse import csc_matrix, csr_matrix

    enc = g.attrs.get("encoding-type", "csr_matrix")
    if isinstance(enc, bytes):
        enc = enc.decode()
    shape = tuple(g.attrs["shape"])
    cls = csc_matrix if str(enc).startswith("csc") else csr_matrix
    return np.asarray(
        cls((g["data"][:], g["indices"][:], g["indptr"][:]), shape=shape).todense()
    )


def load_h5ad(path: str) -> Dict[str, np.ndarray]:
    """Minimal AnnData .h5ad reader (h5py): X, obs columns, obsm['spatial'].

    Handles dense, CSR- and CSC-encoded ``X``, and both plain and
    categorical (codes + categories groups, anndata >= 0.8 encoding) obs
    columns; categorical columns are returned as their decoded values. Keys:
    ``X``, ``spatial``, ``obs/<column>``, ``var_names``. Needs ``h5py``.
    """
    import h5py

    out: Dict[str, np.ndarray] = {}
    with h5py.File(path, "r") as f:
        X = f["X"]
        out["X"] = _read_sparse_group(X) if isinstance(X, h5py.Group) else np.asarray(X)
        if "obsm" in f and "spatial" in f["obsm"]:
            out["spatial"] = np.asarray(f["obsm"]["spatial"])
        if "obs" in f:
            for key in f["obs"]:
                if key == "_index":
                    continue
                node = f["obs"][key]
                if isinstance(node, h5py.Dataset):
                    out[f"obs/{key}"] = np.asarray(node)
                elif isinstance(node, h5py.Group) and "codes" in node and (
                    "categories" in node
                ):
                    codes = np.asarray(node["codes"])
                    cats = np.asarray(node["categories"]).astype(str)
                    vals = np.where(codes >= 0, cats[np.maximum(codes, 0)], "")
                    out[f"obs/{key}"] = vals
        if "var" in f and "_index" in f["var"]:
            out["var_names"] = np.asarray(f["var"]["_index"]).astype(str)
    return out


# ---------------------------------------------------------------------------
# CSV without pandas
# ---------------------------------------------------------------------------


class _Frame(NamedTuple):
    """A numeric CSV table: the header's names, the first column's labels
    (with an index column) and the numbers, (rows, columns) float64."""

    columns: List[str]
    index: Optional[List[str]]
    data: np.ndarray

    def values(self, names: Optional[Sequence[str]] = None) -> np.ndarray:
        """(rows, columns) float64, as ``DataFrame.to_numpy(dtype=float)``."""
        if names is None:
            return np.ascontiguousarray(self.data)
        pos = {name: j for j, name in enumerate(self.columns)}
        return self.data[:, [pos[name] for name in names]]


def _read_csv(path: str, index_col: bool) -> _Frame:
    """Read a comma-separated table as ``pd.read_csv(path)`` (with
    ``index_col=0`` when ``index_col``) reads a numeric one.

    The numbers go through ``np.loadtxt``'s C parser, which rounds each
    field correctly to float64. pandas's default converter does not always
    (it keeps 17 digits and scales by a power of ten in float64): the two
    differ in float64 by rel 1e-12 at most, and not at all after a cast to
    float32, on the fields ``tests/test_torch_data.py`` spells every way;
    and pandas reads a number with 17 zeros after the point before its first
    digit as 0. Integer columns are read as float64, exactly below 2**53.

    The first row is the header; an empty name becomes ``"Unnamed: <i>"``,
    as in pandas. Blank lines are skipped and a field may be quoted with
    ``"`` (not across lines). Every row must have the header's number of
    fields and every field but the index must be a number (``nan`` and
    ``inf`` read as such). Not supported, each raising ``ValueError``:
    missing values (empty, ``NA``), duplicate column names (pandas renames
    them), other delimiters, comment lines and a header one field shorter
    than the rows (pandas's implicit index).
    """
    with open(path) as f:
        line = f.readline()
        while line and not line.strip():
            line = f.readline()
        if not line:
            raise ValueError(f"{path}: empty file")
        names = next(csv.reader([line]))
        header = [name if name else f"Unnamed: {i}" for i, name in enumerate(names)]
        start = 1 if index_col else 0
        columns = header[start:]
        if len(set(columns)) != len(columns):
            raise ValueError(f"{path}: duplicate column names are not supported")
        labels: List[str] = []

        def label(field: str) -> float:
            # called once a row, for the index column only
            labels.append(field)
            return 0.0

        try:
            data = np.loadtxt(f, delimiter=",", comments=None, quotechar='"', ndmin=2,
                              dtype=np.float64, converters={0: label} if index_col else None)
        except ValueError as e:
            raise ValueError(f"{path}: {e} (only numbers are supported)") from None
    if data.shape[1] != len(header):
        raise ValueError(f"{path}: the rows have {data.shape[1]} fields, the header {len(header)}")
    return _Frame(columns, labels if index_col else None, data[:, start:])


def _descending(totals: np.ndarray) -> np.ndarray:
    """Indices of ``totals`` largest first, ties in the order
    ``Series.sort_values(ascending=False)`` gives them: pandas reverses the
    array, argsorts it with numpy's quicksort, and reverses the result."""
    idx = np.arange(len(totals))[::-1]
    return idx[np.array(totals)[::-1].argsort(kind="quicksort")][::-1]


def load_st_data(
    paths: Sequence[str], n_genes: Optional[int] = None
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """Load classic Spatial Transcriptomics CSV layers (genes in columns,
    'AxB'-format spot index), the loader the reference's ST experiments
    import but never shipped.

    Returns per-slice (coords_list, counts_list, gene_names_list), keeping
    only genes common to all slices, sorted by name; with ``n_genes`` the
    top ``n_genes`` by total count over the slices, ties in pandas's order
    (float totals can differ from pandas's in their last bits, as the
    fields do). Reads the files as ``_read_csv`` describes.
    """
    frames = [_read_csv(p, index_col=True) for p in paths]
    common = set(frames[0].columns)
    for fr in frames[1:]:
        common &= set(fr.columns)
    common = sorted(common)
    if n_genes is not None:
        # A column's total is summed as pandas sums it: numpy's pairwise sum
        # of the one column, then over the slices in order.
        totals = 0
        for fr in frames:
            pos = {name: j for j, name in enumerate(fr.columns)}
            totals = totals + np.array([fr.data[:, pos[g]].sum() for g in common])
        common = [common[i] for i in _descending(totals)[:n_genes]]
    coords, counts, names = [], [], []
    for fr in frames:
        coords.append(get_st_coordinates(fr))
        counts.append(fr.values(common))
        names.append(np.asarray(common))
    return coords, counts, names


def load_csv_expression(
    coords_path: str, counts_path: str
) -> Tuple[np.ndarray, np.ndarray]:
    """Generic loader: coords CSV (x, y the first two columns, under a
    header) + counts CSV (spots x genes, the first column the spot index).
    Reads the files as ``_read_csv`` describes."""
    coords = _read_csv(coords_path, index_col=False).values()[:, :2]
    counts = _read_csv(counts_path, index_col=True).values()
    return coords, counts


# ---------------------------------------------------------------------------
# Experiment-level preprocessing
# ---------------------------------------------------------------------------


def knn_r2_gene_filter(
    X: np.ndarray, Y: np.ndarray, n_genes: int, n_neighbors: int = 1
) -> np.ndarray:
    """Rank genes by spatial predictability: R^2 of k-NN regression of each
    gene on spatial coordinates (the reference's spatially-variable-gene
    filter), fitted on a random half of the spots (``default_rng(0)``) and
    scored on the other. Returns indices of the top genes.

    The prediction is the mean of the ``n_neighbors`` nearest training
    spots' values (``cKDTree``), as sklearn's ``KNeighborsRegressor`` with
    uniform weights gives it; where two training spots tie in distance the
    two may keep different ones.
    """
    from scipy.spatial import cKDTree

    n = X.shape[0]
    half = n // 2
    rng = np.random.default_rng(0)
    perm = rng.permutation(n)
    tr, te = perm[:half], perm[half:]
    _, idx = cKDTree(X[tr]).query(X[te], k=n_neighbors)
    idx = np.asarray(idx).reshape(len(te), n_neighbors)
    preds = Y[tr][idx].mean(axis=1)
    resid = np.sum((Y[te] - preds) ** 2, axis=0)
    total = np.sum((Y[te] - Y[te].mean(axis=0)) ** 2, axis=0)
    total = np.where(total == 0, 1.0, total)
    r2 = 1.0 - resid / total
    return np.argsort(-r2)[:n_genes]


def remove_outlier_spots(
    coords: np.ndarray, n_neighbors: int = 10, quantile: float = 0.99
) -> np.ndarray:
    """Boolean keep-mask dropping spots whose mean distance to their
    ``n_neighbors`` nearest neighbours (the point itself left out) is above
    the given quantile. Neighbours from ``cKDTree``; ties in distance leave
    the mean unchanged."""
    from scipy.spatial import cKDTree

    dists, _ = cKDTree(coords).query(coords, k=n_neighbors + 1)
    mean_d = dists[:, 1:].mean(axis=1)
    return mean_d <= np.quantile(mean_d, quantile)


def rotate_coords(coords: np.ndarray, degrees: float) -> np.ndarray:
    """Rotate 2-D coords about their centroid (coarse manual pre-alignment)."""
    theta = np.deg2rad(degrees)
    R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    c = coords.mean(axis=0, keepdims=True)
    return (coords - c) @ R.T + c


# ---------------------------------------------------------------------------
# Synthetic stand-ins (same shapes and structure as the real datasets)
# ---------------------------------------------------------------------------


def _gp_expression(coords: np.ndarray, n_genes: int, rng, lengthscale=1.0, noise=0.1):
    K = rbf_kernel_numpy(coords, coords, np.array([np.log(1.0), np.log(lengthscale)]))
    L = np.linalg.cholesky(K + 1e-4 * np.eye(coords.shape[0]))
    F = L @ rng.standard_normal((coords.shape[0], n_genes))
    return F + noise * rng.standard_normal(F.shape)


def synthetic_visium_like(
    n_spots: int = 800, n_genes: int = 50, n_slices: int = 2, seed: int = 0
):
    """Slices of shared GP expression with a smooth warp between them, a
    stand-in for the Visium mouse-brain pair."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 10, (n_spots, 2))
    # Short-lengthscale expression: sharp spatial structure pins the warp.
    Y0 = _gp_expression(base / 2.0, n_genes, rng, lengthscale=0.5)
    coords_list, counts_list = [], []
    for s in range(n_slices):
        if s == 0:
            coords_list.append(base.copy())
        else:
            Kw = rbf_kernel_numpy(base, base, np.array([np.log(0.5), np.log(5.0)]))
            Lw = np.linalg.cholesky(Kw + 1e-8 * np.eye(n_spots))
            coords_list.append(base + Lw @ rng.standard_normal((n_spots, 2)))
        counts_list.append(Y0 + 0.05 * rng.standard_normal(Y0.shape))
    return coords_list, counts_list


def synthetic_slideseq_like(
    n_beads: int = 3000, n_genes: int = 30, seed: int = 0, rotation: float = 20.0
):
    """Two dense circular pucks with a rotation, a smooth warp and a few
    far-flung outlier beads, a stand-in for the Slide-seq hippocampus pair."""
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(0, 1, n_beads)) * 5.0
    th = rng.uniform(0, 2 * np.pi, n_beads)
    base = np.stack([5 + r * np.cos(th), 5 + r * np.sin(th)], 1)
    Y0 = _gp_expression(base / 2.0, n_genes, rng, lengthscale=1.0)
    coords2 = rotate_coords(base, rotation)
    sub = rng.choice(n_beads, max(200, n_beads // 10), replace=False)
    Kw = rbf_kernel_numpy(base[sub], base[sub], np.array([np.log(0.3), np.log(5.0)]))
    # A smooth warp drawn on a subset and interpolated (keeps the MVN small).
    Lw = np.linalg.cholesky(Kw + 1e-8 * np.eye(len(sub)))
    w_sub = Lw @ rng.standard_normal((len(sub), 2))
    from scipy.interpolate import RBFInterpolator

    warp = RBFInterpolator(base[sub], w_sub, smoothing=1e-3)
    coords2 = coords2 + warp(coords2)
    n_out = n_beads // 100
    out_idx = rng.choice(n_beads, n_out, replace=False)
    coords2[out_idx] += rng.uniform(8, 15, (n_out, 2))
    return [base, coords2], [Y0, Y0 + 0.05 * rng.standard_normal(Y0.shape)]


def synthetic_st_like(
    n_slices: int = 4, grid_size: int = 12, n_genes: int = 40, seed: int = 0
):
    """Serial sections sharing expression with per-slice GP warps, a
    stand-in for the 4-layer breast-cancer ST stack."""
    rng = np.random.default_rng(seed)
    ax = np.linspace(0, 10, grid_size)
    G1, G2 = np.meshgrid(ax, ax)
    base = np.stack([G1.ravel(), G2.ravel()], 1)
    Y0 = _gp_expression(base / 2.0, n_genes, rng, lengthscale=1.0)
    coords_list, counts_list = [], []
    for s in range(n_slices):
        Kw = rbf_kernel_numpy(base, base, np.array([np.log(0.5), np.log(5.0)]))
        Lw = np.linalg.cholesky(Kw + 1e-8 * np.eye(base.shape[0]))
        warp = Lw @ rng.standard_normal((base.shape[0], 2)) if s else 0.0
        coords_list.append(base + warp)
        counts_list.append(Y0 + 0.05 * rng.standard_normal(Y0.shape))
    return coords_list, counts_list
