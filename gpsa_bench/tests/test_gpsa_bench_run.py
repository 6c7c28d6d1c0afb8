"""Whole runs of a cell on the CPU at small sizes: a sound run is correct,
the control and each planted fault are not; the import check; run.py's
refusals; and, on the card only, one short run of run.py."""

import json
import math
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from conftest import ROOT, small

CELLS = ("visium_m200.fit", "spots100k_m100.fit_minibatch", "visium_m200.fit_kernels")


def _run(harness, cell, seed=5):
    r = small(harness.resolve(cell))
    return harness.run_cell(cell, seed, 0.2, False, time.perf_counter(), device="cpu",
                            resolved=r)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(harness, cell):
    out = _run(harness, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 3 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_steps_per_s", "peak_mem_gib", "setup_s"}
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "warp_mean_altered"])
def test_a_planted_fault_is_not_correct(harness, cell, fault, request):
    request.getfixturevalue(fault)
    out = _run(harness, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(harness, cell):
    """The reference one precision below the configuration's, in the
    program's place, fails the cell's limits on three seeds."""
    from gpsa_bench import calibrate

    r = small(harness.resolve(cell))
    out = calibrate.calibrate(r, [], {"lowered": [3, 4, 5]}, device="cpu", emit=lambda s: None)
    for row in out["lowered"]:
        assert not harness.judge(row, r["limits"])[0], row


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_programs_lower_precision_path_is_not_correct(harness, cell):
    """The program with the configuration's control options (one TF32 pass
    for its fp32 products; on the CPU the same fp32, so the card only)
    fails the cell's limits on three seeds, or crashes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from gpsa_bench import calibrate

    r = small(harness.resolve(cell), grid=30, m=100, latent=10, outputs=30)
    out = calibrate.calibrate(r, [], {"control": [3, 4, 5]}, device="cuda", emit=lambda s: None)
    assert len(out.get("control", [])) + len(out.get("control crashed", [])) == 3
    for row in out.get("control", []):
        assert not harness.judge(row, r["limits"])[0], row


@pytest.mark.parametrize("cell", CELLS[:2])
def test_a_run_from_the_constructors_start(harness, cell):
    """A configuration whose ``init`` is null keeps the constructor's
    starting parameters, and the reference starts from them."""
    r = small(harness.resolve(cell))
    r["config"]["init"] = None
    out = harness.run_cell(cell, 5, 0.2, False, time.perf_counter(), device="cpu", resolved=r)
    assert out["attempted"] >= 3 and out["failed"] == 0
    assert all(math.isfinite(c["value"]) for c in out["checks"].values())


def test_the_import_check_compares_whole_top_level_names(harness, monkeypatch):
    monkeypatch.setitem(sys.modules, "spatial_alignment_tpu_torch", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "spatial_alignment_tpu_torchvision", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    for name in harness.FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "spatial_alignment_tpu.models", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax", "spatial_alignment_tpu"]


def test_the_harness_and_reference_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from gpsa_bench import harness, reference, calibrate, datagen\n"
            "import spatial_alignment_tpu_torch\n"
            "print(harness.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "gpsa_bench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copytree(ROOT / "gpsa_bench", tmp_path / "gpsa_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "gpsa_bench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "gpsa_bench/run.py", "--workload", CELLS[0],
                          "--seed", "31", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
