"""The span metrics: their readers on a synthetic replica result, the idle
split and the step's attribution (``spanrun.py``) on synthetic profiler
events, set-up's parts from synthetic span records, and a CPU run whose
readings do not move when the program's spans are on."""

import time

import pytest

from conftest import small

from gpsa_bench import spanrun
from gpsa_bench.spanrun import Ev

CELLS = ("visium_m200.fit", "spots100k_m100.fit_minibatch", "visium_m200.fit_kernels")
SPAN_METRICS = ("idle_in_graph_share", "idle_host_share", "setup_model_s", "setup_capture_s",
                "step_ms.sampler", "step_ms.factors", "step_ms.warp", "step_ms.data",
                "step_ms.objective", "step_ms.optimizer", "device_idle_share.replica")

RESULT = {
    "setup": {"model_s": 5.5, "capture_s": 8.25},
    "call": {"in_graph_share": 3.5, "host_share": 0.4, "idle_share": 3.95},
    "step": {"gpsa.sampler": [0.0, 0], "gpsa.factors": [0.6, 90], "gpsa.warp": [0.7, 120],
             "gpsa.data": [3.0, 400], "gpsa.objective": [0.2, 60],
             "gpsa.optimizer": [0.25, 30], "unattributed": [0.05, 5]},
}
WANT = {"idle_in_graph_share": 3.5, "idle_host_share": 0.4, "setup_model_s": 5.5,
        "setup_capture_s": 8.25, "step_ms.sampler": None, "step_ms.factors": 0.6,
        "step_ms.warp": 0.7, "step_ms.data": 3.0, "step_ms.objective": 0.2,
        "step_ms.optimizer": 0.25, "device_idle_share.replica": 3.95}


def _ctx(n=0):
    return {"config": {"name": f"c{n}"}, "traffic": {"entry": "fit"}}


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_each_reader_on_a_synthetic_result(harness, monkeypatch, metric):
    import gpsa_bench.metrics._spanrun as imported

    runs = []
    monkeypatch.setattr(imported, "_cache", {})
    monkeypatch.setattr(imported, "_has_spans", lambda: True)
    monkeypatch.setattr(imported, "_run", lambda request: runs.append(request) or RESULT)
    mod = harness.reader(metric)
    assert mod.read(_ctx()) == WANT[metric]
    assert mod.read(_ctx()) == WANT[metric]
    assert len(runs) == 1  # one replica a run, whatever reads it


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_each_reader_reads_nothing_without_spans(harness, monkeypatch, metric):
    import gpsa_bench.metrics._spanrun as imported

    monkeypatch.setattr(imported, "_cache", {})
    monkeypatch.setattr(imported, "_has_spans", lambda: False)
    monkeypatch.setattr(imported, "_run", lambda request: pytest.fail("ran without spans"))
    assert harness.reader(metric).read(_ctx(1)) is None


def test_the_replica_is_asked_with_its_own_seed(monkeypatch):
    import json

    import gpsa_bench.metrics._spanrun as imported

    runs = []
    monkeypatch.setattr(imported, "_cache", {})
    monkeypatch.setattr(imported, "_has_spans", lambda: True)
    monkeypatch.setattr(imported, "_run", lambda request: runs.append(request) or RESULT)
    monkeypatch.setattr("sys.argv", ["run.py", "--seed", "3000000001"])
    imported.result(_ctx(2))
    assert json.loads(runs[0]) == {**_ctx(2), "seed": imported.SEED}


@pytest.mark.parametrize("script", ["import sys; sys.exit(3)", "print('', end='')"],
                         ids=["exit", "silent"])
def test_a_failed_replica_fails_the_reader(monkeypatch, tmp_path, script):
    """With a span recorder in the program, a replica that exits non-zero
    or prints nothing raises, and takes the traced run down with it."""
    import gpsa_bench.metrics._spanrun as imported

    (tmp_path / "spanrun.py").write_text(script)
    monkeypatch.setattr(imported, "_cache", {})
    monkeypatch.setattr(imported, "_has_spans", lambda: True)
    monkeypatch.setattr(imported, "BENCH_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="span replica"):
        imported.result(_ctx(3))


# A profiled call of 1,300 ns: gpsa.fit over [0, 1000], its replays over
# [0, 600] (one cudaGraphLaunch, correlation 7), the losses' copy over
# [600, 1000]; a host op after the fit.
CALL = [
    Ev("gpsa.fit", "span", 0, 1000, 1),
    Ev("gpsa.loop.replays", "span", 0, 600, 2),
    Ev("cudaGraphLaunch", "runtime", 10, 20, 7),
    Ev("gpsa.loop.losses", "span", 600, 1000, 3),
    Ev("aten::copy_", "op", 610, 990, 4),
    Ev("cudaMemcpyAsync", "runtime", 620, 640, 9),
    Ev("aten::item", "op", 1010, 1090, 5),
    Ev("kernel_a", "device", 100, 200, 7),
    Ev("kernel_b", "device", 210, 550, 7),  # 10 ns in-graph gap before it
    Ev("memcpy", "device", 700, 800, 9),  # 150 ns host gap before it
    Ev("kernel_c", "device", 1100, 1200, 11),  # 300 ns gap, 200 of it in gpsa.fit
]


def test_the_idle_split_of_a_synthetic_call():
    out = spanrun.split_idle(CALL, 1300)
    busy = 100 + 340 + 100 + 100
    assert out["busy_s"] == busy / 1e9 and out["events"] == 4
    assert out["in_graph_share"] == pytest.approx(100 * 10 / 1300)
    # Host, inside gpsa.fit: [0, 100] before the first operation, [550, 700]
    # and [800, 1000]; outside it: [1000, 1100] and the tail.
    assert out["host_share"] == pytest.approx(100 * (100 + 150 + 200) / 1300)
    assert out["idle_share"] == pytest.approx(100 * (1300 - busy) / 1300)
    assert out["in_graph_share"] + out["host_share"] + out["outside_share"] == pytest.approx(
        out["idle_share"])
    labels = dict((n, v) for n, v in out["host_by_label"])
    assert labels == {"gpsa.loop.losses > aten::copy_": pytest.approx(200e-9),
                      "gpsa.loop.losses > cudaMemcpyAsync": pytest.approx(150e-9),
                      "gpsa.loop.replays > cudaGraphLaunch": pytest.approx(100e-9)}
    assert out["gaps"][0] == ["gpsa.loop.losses > aten::copy_", pytest.approx(200e-9)]
    assert ["in-graph replay", pytest.approx(10e-9)] in out["gaps"]
    assert out["shift_s"] == 0


def test_a_gap_outside_any_span_keeps_the_bare_op():
    """The innermost op that overlaps a gap names it (the runtime call
    inside the copy), the innermost span likewise (the losses' copy inside
    the fit)."""
    assert spanrun.labels([(1000, 1100), (560, 700), (800, 1000), (1250, 1300)], CALL) == [
        "aten::item", "gpsa.loop.losses > cudaMemcpyAsync", "gpsa.loop.losses > aten::copy_",
        "host outside any traced op"]


def test_device_times_move_to_follow_their_launches():
    """A device clock mapped 100 ns early puts the memcpy 20 ns before its
    cudaMemcpyAsync: every device operation moves 20 ns later."""
    by = lambda d: [e._replace(start=e.start + d, end=e.end + d) if e.kind == "device" else e
                    for e in CALL]
    assert spanrun.align_device(by(-100)) == (by(-80), 20)
    assert spanrun.align_device(CALL) == (CALL, 0)


# One eager step: the forward thread (1) runs the warp layer's mm, the data
# layer's mul and a custom Function in the factor pass; the backward thread
# (2) runs each node's backward; a fill launched outside any span.
STEP = [
    Ev("gpsa.factors", "span", 0, 50, 1, thread=1),
    Ev("Cholesky", "op", 10, 40, 2, thread=1, seq=4),
    Ev("gpsa.warp", "span", 50, 100, 3, thread=1),
    Ev("aten::matmul", "op", 55, 80, 4, thread=1, seq=5),
    Ev("aten::mm", "op", 60, 75, 5, thread=1, seq=5),
    Ev("gpsa.data", "span", 100, 200, 6, thread=1),
    Ev("aten::mul", "op", 110, 120, 7, thread=1, seq=6),
    Ev("aten::ones_like", "op", 210, 220, 8, thread=1),
    Ev("autograd::engine::evaluate_function: MulBackward0", "op", 300, 340, 20, thread=2,
       seq=6, fwd_thread=1),
    Ev("aten::mul", "op", 310, 320, 21, thread=2),
    Ev("autograd::engine::evaluate_function: MmBackward0", "op", 340, 400, 22, thread=2,
       seq=5, fwd_thread=1),
    Ev("MmBackward0", "op", 342, 398, 23, thread=2, seq=5, fwd_thread=1),
    Ev("aten::mm", "op", 350, 390, 24, thread=2),
    Ev("autograd::engine::evaluate_function: CholeskyBackward", "op", 400, 450, 25, thread=2,
       seq=4, fwd_thread=1),
    Ev("trisolve_launch", "op", 410, 440, 26, thread=2),
    Ev("gpsa.optimizer", "span", 500, 600, 27, thread=1),
    Ev("aten::_foreach_add_", "op", 510, 590, 28, thread=1),
    Ev("chol_kernel", "device", 1000, 1010, 900, linked=2),
    Ev("gemm", "device", 1010, 1030, 901, linked=5),
    Ev("mul_kernel", "device", 1030, 1034, 902, linked=7),
    Ev("fill", "device", 1034, 1035, 903, linked=8),
    Ev("mul_bwd", "device", 1040, 1044, 904, linked=21),
    Ev("gemm_bwd_1", "device", 1044, 1064, 905, linked=24),
    Ev("gemm_bwd_2", "device", 1064, 1084, 906, linked=24),
    Ev("trisolve_kernel", "device", 1084, 1100, 907, linked=26),
    Ev("foreach", "device", 1100, 1108, 908, linked=28),
    Ev("orphan", "device", 1108, 1109, 909, linked=0),
]


def test_the_attribution_of_a_synthetic_step():
    out = spanrun.attribute(STEP)
    assert out["gpsa.factors"] == [10 + 16, 2]
    assert out["gpsa.warp"] == [20 + 20 + 20, 3]  # a backward kernel by sequence_nr
    assert out["gpsa.data"] == [4 + 4, 2]
    assert out["gpsa.optimizer"] == [8, 1]
    assert out["gpsa.objective"] == [0, 0] and out["gpsa.sampler"] == [0, 0]
    assert out["unattributed"] == [1 + 1, 2]
    assert sum(v[0] for v in out.values()) == sum(e.end - e.start for e in STEP
                                                  if e.kind == "device")


def test_setup_parts_from_span_records():
    from spatial_alignment_tpu_torch.utils.profiling import Span

    s = 10**9
    recs = [
        Span("gpsa.model.init", 0, 5 * s, None, None),
        Span("gpsa.model.kmeans", 1 * s, 3 * s, 0, None),
        Span("gpsa.fit", 6 * s, 20 * s, None, 1),
        Span("gpsa.loop.build", 6 * s, 18 * s, 2, 1),
        Span("gpsa.loop.prime", 7 * s, 8 * s, 3, 1),
        Span("gpsa.loop.warmup", 8 * s, 15 * s, 3, 1),
        Span("gpsa.ops.build", 9 * s, 11 * s, 5, 1),
        Span("gpsa.loop.capture", 15 * s, 17 * s, 3, 1),
        Span("gpsa.fit", 21 * s, 22 * s, None, 2),
        Span("gpsa.ops.build", 21 * s, 21 * s + s // 2, 8, 2),
    ]
    out = spanrun.setup_parts(recs)
    assert out["model_s"] == 5 and out["kmeans_s"] == 2
    assert out["build_s"] == 12 and out["ops_build_s"] == 2 and out["capture_s"] == 10
    assert (out["prime_s"], out["warmup_s"], out["graph_capture_s"]) == (1, 7, 2)
    assert out["fit_calls"] == 2 and out["fit_s"] == 15


@pytest.mark.parametrize("cell", CELLS)
def test_readings_do_not_move_with_spans_on(harness, cell):
    """A CPU run of the cell with the program's spans on compares as one
    with them off, number for number."""
    from spatial_alignment_tpu_torch.utils import profiling

    r = small(harness.resolve(cell))
    run = lambda: harness.run_cell(cell, 5, 0.2, False, time.perf_counter(), device="cpu",
                                   resolved=r)
    off = run()
    profiling.enable_spans(True)
    try:
        on = run()
        recorded = {s.name for s in profiling.spans()}
    finally:
        profiling.enable_spans(False)
    assert {"gpsa.model.init", "gpsa.fit", "gpsa.warp", "gpsa.data"} <= recorded
    assert on["correct"] and off["correct"]
    assert {k: c["value"] for k, c in on["checks"].items()} == {
        k: c["value"] for k, c in off["checks"].items()}


class _Old:
    """A profiler event of a PyTorch without ``activity_type``."""

    def __init__(self, name, python=False):
        self._name, self._python = name, python

    def name(self):
        return self._name

    def is_python_function(self):
        return self._python


class _New(_Old):
    def __init__(self, name, act):
        super().__init__(name)
        self._act = act

    def activity_type(self):
        return self._act


def test_host_events_are_told_apart_with_and_without_activity_types():
    kind = spanrun._host_kind
    assert [kind(_Old(n)) for n in ("cudaGraphLaunch", "cuLaunchKernelEx", "aten::copy_",
                                    "CholeskyFunction", "Optimizer.step#Adam.step")] == [
        "runtime", "runtime", "op", "op", "op"]
    assert kind(_Old("train.py(12): _step", python=True)) is None
    assert [kind(_New("x", a)) for a in ("cuda_runtime", "cuda_driver", "cpu_op",
                                         "python_function")] == ["runtime", "runtime", "op", None]
