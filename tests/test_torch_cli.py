"""PyTorch port: the command line against the JAX package's.

``python -m spatial_alignment_tpu_torch`` has the JAX package's subcommands,
flags, artifacts and messages, plus ``--device``. Every run here passes
``--device cpu``. The port's ``align`` writes the JAX package's headers,
shapes and ``summary.json`` keys; a checkpoint from either package's
``align`` gives the same ``predict`` output through either package's
command line (rel 1e-5, and 1e-5 of the array's largest entry for entries
near zero: two float32 implementations of one posterior).
The JAX side's runs happen once, in a module-scoped fixture.
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spatial_alignment_tpu import cli as jcli
from spatial_alignment_tpu_torch import VariationalGPSA
from spatial_alignment_tpu_torch import cli as tcli
from spatial_alignment_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "tiny_sparse.h5ad")
CPU = ("--device", "cpu")


def _write_views(d, n_genes=3, g=6, warp_sigma=0.1, seed=0):
    """Two views of a g x g grid (the second jittered) as per-view CSVs, the
    JAX package's CLI test data."""
    rng = np.random.default_rng(seed)
    ax = np.linspace(0, 10, g)
    X1, X2 = np.meshgrid(ax, ax)
    X0 = np.stack([X1.ravel(), X2.ravel()], 1)
    Y0 = np.stack(
        [np.sin(X0[:, 0] * (j + 1) / 3.0) + np.cos(X0[:, 1]) for j in range(n_genes)], 1
    )
    X1w = X0 + warp_sigma * rng.standard_normal(X0.shape)
    paths = {}
    for name, x, y in [("a", X0, Y0), ("b", X1w, Y0)]:
        cpath = d / f"{name}_xy.csv"
        np.savetxt(cpath, x, delimiter=",", header="x,y", comments="")
        ypath = d / f"{name}.csv"
        with open(ypath, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["spot"] + [f"g{i}" for i in range(n_genes)])
            for i, row in enumerate(y):
                w.writerow([f"s{i}"] + list(row))
        paths[name] = (str(cpath), str(ypath))
    return paths, X0


def _views(paths, names=("a", "b")):
    out = []
    for n in names:
        out += ["--coords", paths[n][0], "--counts", paths[n][1]]
    return out


def _align(paths, out, extra=()):
    return ["align", *_views(paths), "--template", "0", "--m", "10", "--epochs", "150",
            "--print-every", "100", "--out", str(out), *extra]


def _read(out, name):
    with open(os.path.join(out, name)) as f:
        head = f.readline().strip()
    skip = 1 if name in ("aligned_coords.csv", "losses.csv") else 0
    return head, np.loadtxt(os.path.join(out, name), delimiter=",", skiprows=skip, ndmin=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's ``align`` on the same files (the port's also with
    --triangular), and the JAX package's ``predict`` on both packages'
    checkpoints, from the stored coordinates and at new ones."""
    d = tmp_path_factory.mktemp("cli")
    paths, X0 = _write_views(d)
    new = d / "new_xy.csv"
    np.savetxt(new, X0[:7] + 0.05, delimiter=",", header="x,y", comments="")
    out = {k: d / k for k in ("jax", "torch", "torch_tri")}
    assert jcli.main(_align(paths, out["jax"])) == 0
    assert tcli.main(_align(paths, out["torch"], CPU)) == 0
    assert tcli.main(_align(paths, out["torch_tri"], ("--triangular", *CPU))) == 0
    jax_pred = {}
    for ckpt in ("jax", "torch", "torch_tri"):
        for at in ("stored", "at"):
            dest = d / f"jax_pred_{ckpt}_{at}"
            extra = ["--at", str(new)] if at == "at" else []
            assert jcli.main(["predict", "--checkpoint", str(out[ckpt] / "model.npz"),
                              *extra, "--out", str(dest)]) == 0
            jax_pred[ckpt, at] = dest
    return {"dir": d, "paths": paths, "X0": X0, "new": new, "out": out, "jax_pred": jax_pred}


def test_align_writes_the_jax_artifacts(runs):
    jout, tout = runs["out"]["jax"], runs["out"]["torch"]
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout))
    for name in ("aligned_coords.csv", "losses.csv"):
        (th, tv), (jh, jv) = _read(tout, name), _read(jout, name)
        assert th == jh and tv.shape == jv.shape, name
    _, aligned = _read(tout, "aligned_coords.csv")
    n = runs["X0"].shape[0]
    assert aligned.shape == (2 * n, 1 + 2 + 2)
    v0 = aligned[aligned[:, 0] == 0]
    np.testing.assert_array_equal(v0[:, 1:3], v0[:, 3:5])  # the template passes through
    np.testing.assert_array_equal(aligned[:, 1:3], _read(jout, "aligned_coords.csv")[1][:, 1:3])
    ts, js = (json.loads((o / "summary.json").read_text()) for o in (tout, jout))
    assert list(ts) == list(js)
    for k in ("n_views", "n_samples_list", "n_outputs", "epochs", "artifacts"):
        assert ts[k] == js[k], k
    assert np.isfinite(ts["final_neg_elbo"]) and ts["train_seconds"] > 0
    assert ts["pre_alignment_view_mse"] == js["pre_alignment_view_mse"]
    manifest = json.loads((tout / "model.npz.json").read_text())
    assert manifest["normalize"] is False and manifest["seed"] == 0
    assert manifest["torch_rng_device"] == "cpu"


@pytest.mark.parametrize("at", ["stored", "at"])
@pytest.mark.parametrize("ckpt", ["jax", "torch", "torch_tri"])
def test_predict_agrees_across_packages(runs, tmp_path, ckpt, at):
    """One checkpoint, either package's ``predict``: the same aligned
    coordinates and output moments."""
    extra = ["--at", str(runs["new"])] if at == "at" else []
    dest = tmp_path / "pred"
    assert tcli.main(["predict", "--checkpoint", str(runs["out"][ckpt] / "model.npz"),
                      *extra, "--out", str(dest), *CPU]) == 0
    n = 2 * (7 if at == "at" else runs["X0"].shape[0])
    for name in ("aligned_coords.csv", "pred_mean.csv", "pred_var.csv"):
        (th, tv), (jh, jv) = _read(dest, name), _read(runs["jax_pred"][ckpt, at], name)
        assert th == jh or name != "aligned_coords.csv"
        assert tv.shape == jv.shape and tv.shape[0] == n, name
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5 * np.abs(jv).max(), err_msg=name)
    var = _read(dest, "pred_var.csv")[1]
    assert (var > 0).all()


def test_triangular_travels_in_the_checkpoint(runs):
    model = VariationalGPSA.load(str(runs["out"]["torch_tri"] / "model.npz"), device="cpu")
    assert model.spec.triangular_variational is True
    plain = VariationalGPSA.load(str(runs["out"]["torch"] / "model.npz"), device="cpu")
    assert plain.spec.triangular_variational is False


def test_predict_with_input_views_and_the_rebuild(runs, tmp_path):
    """``predict`` on the training files, from the self-contained
    checkpoint and from a params-only one, which it rebuilds from the files
    and the flags as the JAX package does: the same outputs."""
    paths, out = runs["paths"], runs["out"]["torch"]
    full = tmp_path / "full"
    assert tcli.main(["predict", *_views(paths), "--checkpoint", str(out / "model.npz"),
                      "--out", str(full), *CPU]) == 0
    model = VariationalGPSA.load(str(out / "model.npz"), device="cpu")
    bare = str(tmp_path / "bare.npz")
    save_checkpoint(bare, model.params, model.consts, step=150)
    rebuilt = tmp_path / "rebuilt"
    assert tcli.main(["predict", *_views(paths), "--template", "0", "--m", "10",
                      "--checkpoint", bare, "--out", str(rebuilt), *CPU]) == 0
    stored = runs["jax_pred"]["torch", "stored"]
    for name in ("aligned_coords.csv", "pred_mean.csv", "pred_var.csv"):
        a, b = _read(full, name)[1], _read(rebuilt, name)[1]
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, _read(stored, name)[1], rtol=1e-5,
                                   atol=1e-5 * np.abs(a).max())


def test_h5ad_input(tmp_path):
    """``--h5ad`` on the committed sparse, categorical fixture: the views
    are the batch column's values in sorted order; predict reads it too."""
    out = tmp_path / "out"
    assert tcli.main(["align", "--h5ad", FIXTURE, "--template", "0", "--m", "8",
                      "--epochs", "20", "--print-every", "10", "--out", str(out), *CPU]) == 0
    summary = json.loads((out / "summary.json").read_text())
    assert summary["n_samples_list"] == [60, 60] and summary["n_outputs"] == 12
    pred = tmp_path / "pred"
    assert tcli.main(["predict", "--h5ad", FIXTURE, "--checkpoint", str(out / "model.npz"),
                      "--out", str(pred), *CPU]) == 0
    assert _read(pred, "pred_mean.csv")[1].shape == (120, 12)


def test_errors_are_the_jax_packages(runs, tmp_path):
    paths, out = runs["paths"], runs["out"]["torch"]
    args = ["predict", *_views(paths, ("a",)), "--checkpoint", str(out / "model.npz"),
            "--out", str(tmp_path / "bad")]
    with pytest.raises(SystemExit, match="view-count mismatch") as got:
        tcli.main(args + list(CPU))
    with pytest.raises(SystemExit) as want:
        jcli.main(args)
    assert str(got.value) == str(want.value)
    args = ["align", "--coords", "x.csv", "--out", str(tmp_path)]
    with pytest.raises(SystemExit, match="matching --coords/--counts") as got:
        tcli.main(args + list(CPU))
    with pytest.raises(SystemExit) as want:
        jcli.main(args)
    assert str(got.value) == str(want.value)


def test_without_device_the_cli_wants_the_card(runs, tmp_path):
    """No --device means the GPU: on a machine without one the command
    raises the port's device error and trains nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(_align(runs["paths"], out))
    assert not out.exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["predict", "--checkpoint", str(runs["out"]["torch"] / "model.npz"),
                   "--out", str(out)])


def test_module_entry_point_help(capsys):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _ROOT
    done = subprocess.run([sys.executable, "-m", "spatial_alignment_tpu_torch", "--help"],
                          cwd=_ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert "usage: spatial_alignment_tpu_torch" in done.stdout
    for sub in ("align", "predict"):
        with pytest.raises(SystemExit) as e:
            tcli.main([sub, "--help"])
        assert e.value.code == 0 and "--device {cuda,cpu}" in capsys.readouterr().out
