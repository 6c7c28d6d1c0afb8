"""The port's span recorder (``utils.profiling.enable_spans`` / ``span`` /
``spans``) and the training loop's counters.

CPU tests on a 12-point model: with spans off nothing enters
``record_function`` and nothing is stored; with spans on a fit records the
layers' tree (parents, one call id per fit() call, self times), the
constructor its k-means, a minibatch fit its sampler, predict the step's
layers. The card test: two fit() calls capture once, move every counter by
their steps times the step's counts (a replay's among them), and spans
leave the losses bit for bit as they are. The file imports neither jax nor
the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py -q
"""

from collections import Counter

import numpy as np
import pytest
import torch

from spatial_alignment_tpu_torch import VariationalGPSA, ops
from spatial_alignment_tpu_torch.models import train
from spatial_alignment_tpu_torch.utils import profiling


def _data(n=6, seed=0):
    rng = np.random.default_rng(seed)
    X1 = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    X = np.concatenate([X1, X1 + 0.1 * rng.standard_normal(X1.shape).astype(np.float32)])
    Y = np.stack([np.sin(X[:, 0] * (j + 1) / 3.0) + np.cos(X[:, 1]) for j in range(3)], 1)
    return {"expression": {"spatial_coords": X, "outputs": Y.astype(np.float32),
                           "n_samples_list": [n, n]}}


def _model(device="cpu", seed=0):
    return VariationalGPSA(_data(), m_X_per_view=4, m_G=4, n_latent_gps={"expression": 2},
                           fixed_view_idx=0, seed=seed, device=device)


@pytest.fixture
def spans_on():
    profiling.spans()
    profiling.enable_spans(True)
    try:
        yield
    finally:
        profiling.enable_spans(False)
        profiling.spans()


def _depth_names(records, i):
    """The names from record i up to the top."""
    out = []
    while i is not None:
        out.append(records[i].name)
        i = records[i].parent
    return out


def test_spans_off_enter_no_record_function_and_store_nothing(monkeypatch):
    """(``torch.optim`` enters ``torch.autograd.profiler.record_function``
    in every step of its own; a span enters ``torch.profiler``'s.)"""
    import torch.profiler

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.enable_spans(False)
    profiling.spans()
    model = _model()
    model.fit(3, S=2)
    model.fit(3, S=2, minibatch_size=4)
    model.predict({"expression": _data()["expression"]["spatial_coords"]})
    assert profiling.span("gpsa.fit") is profiling.span("gpsa.warp")
    assert profiling.spans() == []


def test_a_fit_records_the_layers_tree(spans_on):
    model = _model()
    profiling.spans()
    model.fit(3, S=2)
    model.fit(3, S=2)
    recs = profiling.spans()
    assert {r.name for r in recs} <= set(profiling.SPAN_NAMES)
    fits = [i for i, r in enumerate(recs) if r.name == "gpsa.fit"]
    assert len(fits) == 2 and all(recs[i].parent is None for i in fits)
    ids = [recs[i].call_id for i in fits]
    assert len(set(ids)) == 2 and None not in ids
    for i, r in enumerate(recs):
        top = _depth_names(recs, i)[-1]
        assert top == "gpsa.fit"
        root = i
        while recs[root].parent is not None:
            root = recs[root].parent
        assert r.call_id == recs[root].call_id
        if r.parent is not None:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    parent = lambda r: recs[r.parent].name if r.parent is not None else None
    counts = Counter((r.name, parent(r)) for r in recs)
    # The first call builds the loop (priming resets the state once), each
    # call resets it, copies one chunk's inputs, runs 3 steps, copies losses.
    assert counts[("gpsa.loop.build", "gpsa.fit")] == 1
    assert counts[("gpsa.loop.prime", "gpsa.loop.build")] == 1
    assert counts[("gpsa.loop.reset", "gpsa.loop.prime")] == 1
    assert counts[("gpsa.loop.reset", "gpsa.fit")] == 2
    for name in ("gpsa.loop.inputs", "gpsa.loop.replays", "gpsa.loop.losses"):
        assert counts[(name, "gpsa.fit")] == 2
    for name, per_step in (("gpsa.factors", 1), ("gpsa.warp", 1), ("gpsa.data", 1),
                           ("gpsa.objective", 2), ("gpsa.optimizer", 2)):
        assert counts[(name, "gpsa.loop.replays")] == 6 * per_step
    assert not any(r.name == "gpsa.sampler" for r in recs)


def test_self_time_is_duration_less_childrens(spans_on):
    """Children lie inside their parent and apart from each other, so a
    span's self time, its duration less its children's, is what their
    union leaves of it."""
    model = _model()
    model.fit(2, S=2)
    recs = profiling.spans()
    for i, r in enumerate(recs):
        kids = sorted((c.start_ns, c.end_ns) for c in recs if c.parent == i)
        assert all(a[1] <= b[0] for a, b in zip(kids, kids[1:]))
        covered, end = 0, r.start_ns
        for a, b in kids:
            covered += max(0, b - max(a, end))
            end = max(end, b)
        own = r.end_ns - r.start_ns - sum(b - a for a, b in kids)
        assert own == r.end_ns - r.start_ns - covered and own >= 0


def test_the_constructor_records_its_kmeans(spans_on):
    _model()
    recs = profiling.spans()
    assert recs[0].name == "gpsa.model.init" and recs[0].parent is None
    assert recs[0].call_id is None
    kmeans = [r for r in recs if r.name == "gpsa.model.kmeans"]
    assert len(kmeans) == 3  # each view's inducing points and the data layer's
    assert all(r.parent == 0 for r in kmeans)
    assert {r.name for r in recs} == {"gpsa.model.init", "gpsa.model.kmeans"}


def test_a_minibatch_fit_records_its_sampler_and_predict_its_layers(spans_on):
    model = _model()
    model.fit(4, S=2, minibatch_size=4)
    recs = profiling.spans()
    sampler = [r for r in recs if r.name == "gpsa.sampler"]
    assert len(sampler) == 4
    assert all(recs[r.parent].name == "gpsa.loop.replays" for r in sampler)
    model.predict({"expression": _data()["expression"]["spatial_coords"]})
    names = [r.name for r in profiling.spans()]
    assert names == ["gpsa.factors", "gpsa.warp", "gpsa.data"]


def test_spans_enter_record_function_and_the_profiler_sees_them(spans_on):
    model = _model()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.fit(2, S=2)
    seen = Counter(e.name for e in prof.events() if e.name.startswith("gpsa."))
    recorded = Counter(r.name for r in profiling.spans() if r.name != "gpsa.model.init")
    recorded -= Counter({"gpsa.model.kmeans": 3})
    assert seen == recorded and seen["gpsa.fit"] == 1 and seen["gpsa.warp"] == 2


def test_spans_refuses_while_one_is_open(spans_on):
    with profiling.span("gpsa.fit", call=True):
        with pytest.raises(RuntimeError, match="open"):
            profiling.spans()
    assert [r.name for r in profiling.spans()] == ["gpsa.fit"]


def test_the_loop_counters_are_registered():
    """Replays count among the kernel counters; captures stay out of them
    (a fit moves those by its steps times the step's counts alone)."""
    counts = ops.read_counters()
    assert "loop.replays" in counts and "loop.captures" not in counts
    assert isinstance(train.captures, int)


@pytest.mark.cuda
def test_two_fits_capture_once_and_spans_leave_losses_alone():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the loop captures its step on one")
    runs = {}
    for on in (False, True):
        profiling.enable_spans(on)
        try:
            before, captured = ops.read_counters(), train.captures
            model = _model("cuda", seed=3)
            runs[on] = [model.fit(7, S=2), model.fit(5, S=2)]
            after = ops.read_counters()
            recs = profiling.spans()
        finally:
            profiling.enable_spans(False)
        per_step = model._train_loop_cache["loop"].per_step
        assert train.captures - captured == 1 and per_step["loop.replays"] == 1
        assert {k: after[k] - before[k] for k in after} == {k: 12 * v for k, v in per_step.items()}
        names = Counter(r.name for r in recs)
        if on:
            assert names["gpsa.loop.capture"] == 1 and names["gpsa.fit"] == 2
            assert names["gpsa.warp"] == 1 + 2  # captured once, two warm-up steps
        else:
            assert not recs
    for a, b in zip(runs[False], runs[True]):
        np.testing.assert_array_equal(a, b)
