"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its file; a cell, configuration and metric added as files
alone run."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

from gpsa_bench import datagen

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
READINGS = {"loss", "loss_first", "grad", "grad_median", "change", "change_median", "aligned",
            "aligned_start"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert (ROOT / bench["command"][1]).exists()
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(bench["paths"][0] + "/") and c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_workloads(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (ROOT / "gpsa_bench" / "traffic" / f"{w['traffic']}.json").exists()


def test_metrics(bench, harness):
    e2e, per_layer = bench["end_to_end"], bench["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(per_layer) <= 128
    names = [m["name"] for m in e2e + per_layer]
    assert len(set(names)) == len(names)
    assert "setup_s" in names
    cells = {w["name"] for w in bench["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in per_layer:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in e2e} and _line(m["layer"])
        assert m["source"] in SOURCES and set(m.get("workloads", cells)) <= cells
        assert hasattr(harness.reader(m["name"]), "read")
    for m in e2e + per_layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in cells:
        r = harness.resolve(w, bench)
        reported = {m["name"] for m in r["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2 and r["per_layer"]


def test_every_cell_resolves_with_limits(bench, harness):
    for w in bench["workloads"]:
        r = harness.resolve(w["name"], bench)
        assert hasattr(harness.entry(r["traffic"]), "call")
        assert hasattr(datagen._generator(r["config"]), "make")
        assert r["limits"], f"{w['name']} has no limits file"
        assert set(r["limits"]) <= READINGS and {"loss", "grad_median", "change"} <= set(r["limits"])
        assert all(v > 0 for v in r["limits"].values())


ADDED = '''
import json, sys, time
sys.path.insert(0, {root!r})
from gpsa_bench import harness
sys.path.insert(0, {tests!r})
from conftest import small
r = small(harness.resolve("tiny_grid.fit_once"))
assert r["config"]["name"] == "tiny_grid"
assert [m["name"] for m in r["per_layer"]] == ["one_more"]
assert harness.reader("one_more").read({{}}) == 1.0
assert harness.entry(r["traffic"]).__name__ == "gpsa_bench.entries.fit_copy"
out = harness.run_cell("tiny_grid.fit_once", 7, 0.5, False, time.perf_counter(), device="cpu",
                       resolved=r)
print(json.dumps(sorted(out["metrics"])))
'''


def test_a_cell_added_as_files_alone_runs(tmp_path, bench):
    """A copy of the benchmark with a configuration, a traffic mix, an
    entry, a generator, a limits file and a per-layer metric added as new
    files and entries, and no file edited, loads and runs its new cell."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "gpsa_bench", copy / "gpsa_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "spatial_alignment_tpu_torch").symlink_to(ROOT / "spatial_alignment_tpu_torch")
    g = copy / "gpsa_bench"
    cfg = json.loads((g / "configs" / "visium_m200.json").read_text())
    cfg["name"] = "tiny_grid"
    cfg["data"]["generator"] = "grid_copy"
    (g / "configs" / "tiny_grid.json").write_text(json.dumps(cfg))
    shutil.copy(g / "generators" / "twod_grid.py", g / "generators" / "grid_copy.py")
    shutil.copy(g / "entries" / "fit.py", g / "entries" / "fit_copy.py")
    traffic = json.loads((g / "traffic" / "fit.json").read_text())
    traffic["entry"] = "fit_copy"
    (g / "traffic" / "fit_once.json").write_text(json.dumps(traffic))
    (g / "limits" / "tiny_grid.fit_once.json").write_text(
        (g / "limits" / "visium_m200.fit.json").read_text())
    (g / "metrics" / "one_more.py").write_text("def read(ctx):\n    return 1.0\n")
    b = json.loads(json.dumps(bench))
    b["configs"].append({"name": "tiny_grid", "source": "x", "reduced": [], "why": "x",
                         "file": "gpsa_bench/configs/tiny_grid.json"})
    b["workloads"].append({"name": "tiny_grid.fit_once", "config": "tiny_grid",
                           "traffic": "fit_once", "chips": 1, "why": "x"})
    b["end_to_end"].append({"name": "other_rate", "unit": "steps/s", "better": "higher",
                            "bound": 0.05, "source": "host_clock", "workloads": ["x"]})
    b["per_layer"].append({"name": "one_more", "unit": "count", "better": "lower",
                           "source": "program_counter", "layer": "step", "moves": "setup_s",
                           "workloads": ["tiny_grid.fit_once"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(b))
    code = ADDED.format(root=str(copy), tests=str(ROOT / "gpsa_bench" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=copy)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [
        "peak_mem_gib", "setup_s", "train_steps_per_s"]
