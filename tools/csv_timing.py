#!/usr/bin/env python3
"""The port's CSV loaders against pandas's ``read_csv``, on the host.

    python3 tools/csv_timing.py [--visium 4000 18000] [--st 4 260 15000]

Writes, in a temporary directory, a Visium-size counts table (spots x
genes, a spot label column, and its ``x,y`` coordinate file) and a stack of
classic Spatial Transcriptomics layers ('AxB' spot labels, genes in
columns), each once with integer counts (Poisson, mostly zeros) and once
with float expression (``log1p`` of counts per 10,000, float32 written at
9 significant digits). It then times, each in a new process so that the
peak resident memory is the loader's own:

- ``port``: ``spatial_alignment_tpu_torch.data.load_csv_expression`` on the
  Visium files and ``load_st_data(paths, n_genes=200)`` on the ST layers,
  as the command line and the ST experiments call them;
- ``pandas``: the same two loaders as the JAX package writes them, on
  ``pd.read_csv`` (copied here, so that nothing of JAX is imported).

Each process reads its file twice (the page cache is warm both times) and
reports both wall times, its peak resident memory (``ru_maxrss``) after
its imports (the port's import PyTorch) and at the end, and a digest of
its float32 result; the two loaders must give the same digest. Prints one
JSON line.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _counts(rng, spots, genes, kind):
    counts = rng.poisson(rng.gamma(0.3, 1.0, genes), (spots, genes))
    if kind == "int":
        return counts
    per = np.maximum(counts.sum(1, keepdims=True), 1)
    return np.log1p(counts / per * 1e4).astype(np.float32)


def _write_table(path, labels, names, values, kind):
    fmt = (lambda v: str(v)) if kind == "int" else (lambda v: "%.9g" % v)
    with open(path, "w") as f:
        f.write(",".join([""] + names) + "\n")
        for label, row in zip(labels, values.tolist()):
            f.write(label + "," + ",".join(map(fmt, row)) + "\n")


def write_files(tmp, kind, visium, st, seed=0):
    rng = np.random.default_rng(seed)
    spots, genes = visium
    names = [f"Gene{j}" for j in range(genes)]
    xy = rng.uniform(0, 100, (spots, 2)).astype(np.float32)
    coords = os.path.join(tmp, f"visium_xy_{kind}.csv")
    np.savetxt(coords, xy, delimiter=",", header="x,y", comments="", fmt="%.9g")
    counts = os.path.join(tmp, f"visium_counts_{kind}.csv")
    _write_table(counts, [f"spot{i}" for i in range(spots)], names,
                 _counts(rng, spots, genes, kind), kind)
    slices, st_spots, st_genes = st
    side = int(np.ceil(np.sqrt(st_spots)))
    labels = [f"{i % side}x{i // side}" for i in range(st_spots)]
    layers = []
    for s in range(slices):
        path = os.path.join(tmp, f"st{s}_{kind}.csv")
        # the layers share most genes, not all
        _write_table(path, labels, [f"Gene{j}" for j in range(s, st_genes + s)],
                     _counts(rng, st_spots, st_genes, kind), kind)
        layers.append(path)
    return {"visium": [coords, counts], "st": layers}


def _pandas_csv_expression(coords_path, counts_path):
    import pandas as pd

    coords = pd.read_csv(coords_path).to_numpy(dtype=float)[:, :2]
    counts = pd.read_csv(counts_path, index_col=0).to_numpy(dtype=float)
    return coords, counts


def _pandas_st_data(paths, n_genes):
    import pandas as pd

    dfs = [pd.read_csv(p, index_col=0) for p in paths]
    common = set(dfs[0].columns)
    for df in dfs[1:]:
        common &= set(df.columns)
    common = sorted(common)
    totals = sum(df[common].sum(axis=0) for df in dfs)
    common = list(totals.sort_values(ascending=False).index[:n_genes])
    coords = [np.array([[float(t) for t in s.split("x")] for s in df.index]) for df in dfs]
    return coords, [df[common].to_numpy(dtype=float) for df in dfs], [np.asarray(common)] * len(dfs)


def _digest(arrays, names=()):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a, np.float32).tobytes())
    for n in names:
        h.update("\n".join(map(str, n)).encode())
    return h.hexdigest()[:16]


def _peak_rss_gib():
    """This process's peak resident memory. ``ru_maxrss`` starts from the
    parent's resident memory at the fork, so the parent that starts the
    loaders stays small: it writes no file itself."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def child(loader, layout, paths):
    """One loader on one file set, twice; prints a JSON line."""
    if loader == "port":
        sys.path.insert(0, str(ROOT))
        from spatial_alignment_tpu_torch.data import realdata

        load_csv, load_st = realdata.load_csv_expression, realdata.load_st_data
    else:
        import pandas  # noqa: F401  (imported before the baseline, as the port's is)

        load_csv, load_st = _pandas_csv_expression, _pandas_st_data
    base = _peak_rss_gib()
    seconds = []
    for _ in range(2):
        t0 = time.perf_counter()
        if layout == "visium":
            coords, counts = load_csv(*paths)
            digest = _digest([coords, counts])
            shape = list(counts.shape)
        else:
            coords, counts, names = load_st(paths, n_genes=200)
            digest = _digest(coords + counts, names)
            shape = [len(counts)] + list(counts[0].shape)
        seconds.append(time.perf_counter() - t0)
    peak = _peak_rss_gib()
    print(json.dumps({"seconds": seconds, "rss_after_imports_gib": base,
                      "peak_rss_gib": peak, "digest": digest,
                      "shape": shape}))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--visium", type=int, nargs=2, default=[4000, 18000],
                        metavar=("SPOTS", "GENES"))
    parser.add_argument("--st", type=int, nargs=3, default=[4, 260, 15000],
                        metavar=("SLICES", "SPOTS", "GENES"))
    parser.add_argument("--child", nargs="+", help=argparse.SUPPRESS)
    parser.add_argument("--write", nargs=2, metavar=("DIR", "KIND"), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        child(args.child[0], args.child[1], args.child[2:])
        return 0
    if args.write:
        print(json.dumps(write_files(*args.write, args.visium, args.st)))
        return 0
    result = {"visium": args.visium, "st": args.st, "cpu_count": os.cpu_count(), "runs": []}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for kind in ("int", "float"):
            t0 = time.perf_counter()
            sizes = [str(v) for v in ["--visium", *args.visium, "--st", *args.st]]
            out = subprocess.run([sys.executable, __file__, "--write", tmp, kind, *sizes],
                                 capture_output=True, text=True, check=True)
            files = json.loads(out.stdout)
            write_s = time.perf_counter() - t0
            for layout, paths in files.items():
                mib = sum(os.path.getsize(p) for p in paths) / 2**20
                digests = {}
                for loader in ("port", "pandas"):
                    out = subprocess.run(
                        [sys.executable, __file__, "--child", loader, layout, *paths],
                        capture_output=True, text=True, check=False)
                    if out.returncode:
                        print(out.stderr[-4000:], file=sys.stderr)
                        return 1
                    rec = json.loads(out.stdout.strip().splitlines()[-1])
                    digests[loader] = rec["digest"]
                    result["runs"].append({"kind": kind, "layout": layout, "loader": loader,
                                           "file_mib": mib, "write_seconds": write_s, **rec})
                ok &= digests["port"] == digests["pandas"]
            for p in sum(files.values(), []):
                os.remove(p)
    result["float32_equal"] = ok
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
