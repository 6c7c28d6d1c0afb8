"""A traced replica of a run, with the program's spans on from its start.

    python3 gpsa_bench/spanrun.py < request.json

from the root of a checkout, where the request is ``{"config": ...,
"traffic": ..., "seed": n}`` (a resolved cell's configuration and traffic).
In a process of its own, so that set-up pays what a run's set-up pays, it
turns the span recorder on (``utils.profiling.enable_spans``), makes the
run's set-up (:func:`harness.setup`), then

  - reads set-up's parts from the recorded spans (:func:`setup_parts`);
  - runs the entry's calls for ``WARM_S`` seconds, as a run's window does
    before its profiled call, and profiles one call of ``profile_epochs``
    under torch.profiler: its device idle split into gaps inside
    one graph replay and gaps the host left, each of these named by the
    innermost ``gpsa.*`` span and the host operation that overlap it most
    (:func:`split_idle`), and the loop's counters over the call;
  - profiles one eager run of the captured step (the cached loop's own
    step, its state put back after) and gives each device operation to the
    step's span that launched it, a backward one to the span of the forward
    operation autograd links it to (:func:`attribute`).

It prints one JSON line, the last on standard output, and its log on
standard error; exits 2 without a CUDA device. ``metrics/_spanrun.py`` runs
it once per traced run for the span metrics' readers, where the program has
a span recorder.

A stop-gap: a benchmark change to ``harness.py`` (``PERF.md`` §7) is to
turn the spans on before the run's own set-up and have ``profile_call``
and ``run_cell`` call the pure helpers here (:func:`split_idle`,
:func:`labels`, :func:`eager_step`, :func:`attribute`,
:func:`setup_parts`); then :func:`replica`, :func:`main` and ``WARM_S``
go, and the run's own ``device_idle_share`` is the whole the split adds up
to.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import json  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NamedTuple, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpsa_bench import harness  # noqa: E402
from gpsa_bench.harness import log  # noqa: E402

# The step's parts: each device operation of a step goes to one of these,
# or to "unattributed".
STEP_PARTS = ("gpsa.sampler", "gpsa.factors", "gpsa.warp", "gpsa.data", "gpsa.objective",
              "gpsa.optimizer")
IN_GRAPH = "in-graph replay"
# Seconds of the entry's calls before the profiled one.
WARM_S = 20.0
_BACKWARD_NODE = "autograd::engine::evaluate_function"


class Ev(NamedTuple):
    """One profiler event: ``kind`` is "device" (a kernel, copy or set),
    "runtime" (a CUDA runtime or driver call), "op" (an operator) or "span"
    (a ``gpsa.*`` range); times in ns on the profiler's clock; ``corr`` its
    correlation id (a device operation's and its runtime call's are one;
    an operator's is its own), ``linked`` the operator a device operation
    was launched inside; ``seq`` and ``fwd_thread`` autograd's sequence
    number and, on a backward node, the thread of its forward."""

    name: str
    kind: str
    start: int
    end: int
    corr: int = 0
    linked: int = 0
    thread: int = 0
    seq: int = -1
    fwd_thread: int = 0


# A CUDA runtime or driver call's name (cudaLaunchKernel, cuLaunchKernelEx),
# where the profiler's events carry no activity type (before PyTorch 2.12).
_RUNTIME = re.compile(r"^cu(da)?[A-Z]")


def _host_kind(e) -> Optional[str]:
    """"runtime", "op" or None (left out) of a host event that is not a span."""
    if hasattr(e, "activity_type"):
        act = e.activity_type()
        return {"cuda_runtime": "runtime", "cuda_driver": "runtime", "cpu_op": "op"}.get(act)
    if getattr(e, "is_python_function", lambda: False)():
        return None
    return "runtime" if _RUNTIME.match(e.name()) else "op"


def events_of(prof) -> list:
    """The :class:`Ev` list of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            kind = "device"
        elif e.is_user_annotation():
            if not name.startswith("gpsa."):
                continue
            kind = "span"
        else:
            kind = _host_kind(e)
            if kind is None:
                continue
        start = e.start_ns()
        out.append(Ev(name, kind, start, start + e.duration_ns(), e.correlation_id(),
                      e.linked_correlation_id(), e.start_thread_id(), e.sequence_nr(),
                      e.fwd_thread_id()))
    return out


# ---------------------------------------------------------------------------
# Idle gaps of a profiled call
# ---------------------------------------------------------------------------


def device_timeline(evs) -> tuple:
    """(busy ns, gaps, (first start, last end)) of the device operations:
    busy is their union's length, each gap (start, end, correlation id of
    the operation that ended last before it, of the one after it)."""
    dev = sorted((e for e in evs if e.kind == "device"), key=lambda e: (e.start, e.end))
    busy, gaps, cur = 0, [], None
    for e in dev:
        if cur is None or e.start > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], e.start, cur[2], e.corr))
            cur = [e.start, e.end, e.corr]
        elif e.end >= cur[1]:
            cur[1], cur[2] = e.end, e.corr
    if cur is None:
        return 0, [], None
    busy += cur[1] - cur[0]
    return busy, gaps, (dev[0].start, cur[1])


def _most(a: int, b: int, cands) -> Optional[str]:
    """The name of the event of ``cands`` that overlaps (a, b) most, the
    shortest of those that overlap it alike; None when none does."""
    best = max(((min(b, e.end) - max(a, e.start), -(e.end - e.start), e.name) for e in cands),
               default=None)
    return best[2] if best is not None and best[0] > 0 else None


def _innermost(a: int, b: int, spans) -> list:
    """The spans that overlap (a, b) and hold no other span that does."""
    on = [e for e in spans if min(b, e.end) > max(a, e.start)]
    return [e for e in on if not any(o is not e and e.start <= o.start and o.end <= e.end
                                     for o in on)]


def labels(intervals, evs) -> list:
    """``"<span> > <host op>"`` of each host gap (a, b) of ``intervals``:
    of the innermost ``gpsa.*`` spans that overlap it, the one that overlaps
    it most, and likewise of the innermost host operations (operators and
    runtime calls); the bare operation where no span overlaps it. Ties go
    to the shorter."""
    host = sorted((e for e in evs if e.kind in ("op", "runtime", "span")), key=lambda e: e.start)
    order = sorted(range(len(intervals)), key=lambda i: intervals[i][0])
    out, active, k = [None] * len(intervals), [], 0
    for i in order:
        a, b = intervals[i]
        while k < len(host) and host[k].start < b:
            active.append(host[k])
            k += 1
        active = [e for e in active if e.end > a]
        op = _most(a, b, _innermost(a, b, [e for e in active if e.kind != "span"]))
        op = op or "host outside any traced op"
        sp = _most(a, b, _innermost(a, b, [e for e in active if e.kind == "span"]))
        out[i] = f"{sp} > {op}" if sp else op
    return out


def _clip(a: int, b: int, intervals) -> list:
    """The parts of (a, b) inside ``intervals`` (disjoint)."""
    return [(max(a, s), min(b, e)) for s, e in intervals if min(b, e) > max(a, s)]


def align_device(evs) -> tuple:
    """(events, shift ns): the device operations moved later by the
    least that starts none before its runtime call (the profiler maps the
    device's clock onto the host's, and the mapping can run early)."""
    launch = {e.corr: e.start for e in evs if e.kind == "runtime"}
    shift = max([0] + [launch[e.corr] - e.start for e in evs
                       if e.kind == "device" and e.corr in launch])
    if not shift:
        return evs, 0
    return [e._replace(start=e.start + shift, end=e.end + shift) if e.kind == "device" else e
            for e in evs], shift


def split_idle(evs, wall_ns: int) -> dict:
    """The device idle of a profiled call of ``wall_ns`` split in two.
    In-graph: gaps whose operations on both sides carry the correlation id
    of one graph launch. Host: every other gap, and the idle before the
    first operation and after the last, where the host is inside a
    ``gpsa.fit`` span. ``outside`` is the rest of wall less busy (the host
    outside ``gpsa.fit``, and the profiler's clock against the wall's).
    Shares are % of the wall; ``gaps`` the ten longest with their labels,
    ``host_by_label`` the host idle summed by label; ``shift_s`` the
    device clock's correction (:func:`align_device`)."""
    evs, shift = align_device(evs)
    busy, gaps, ends = device_timeline(evs)
    launches = {e.corr for e in evs if e.kind == "runtime" and "GraphLaunch" in e.name}
    fits = [(e.start, e.end) for e in evs if e.kind == "span" and e.name == "gpsa.fit"]
    in_graph, labelled, by_label = 0, [], defaultdict(int)
    edges = [(-2**62, ends[0]), (ends[1], 2**62)] if ends else []
    for a, b, left, right in gaps:
        if left == right and left in launches:
            in_graph += b - a
            labelled.append((IN_GRAPH, b - a))
        else:
            edges.append((a, b))
    inside = [piece for a, b in edges for piece in _clip(a, b, fits)]
    for (a, b), name in zip(inside, labels(inside, evs)):
        by_label[name] += b - a
        labelled.append((name, b - a))
    host = sum(b - a for a, b in inside)
    labelled.sort(key=lambda g: -g[1])
    pct = lambda ns: 100.0 * ns / wall_ns
    return {"busy_s": busy / 1e9, "in_graph_share": pct(in_graph), "host_share": pct(host),
            "outside_share": pct(wall_ns - busy - in_graph - host),
            "idle_share": pct(wall_ns - busy), "shift_s": shift / 1e9,
            "events": sum(e.kind == "device" for e in evs),
            "gaps": [[n, ns / 1e9] for n, ns in labelled[:10]],
            "host_by_label": [[n, ns / 1e9] for n, ns in
                              sorted(by_label.items(), key=lambda kv: -kv[1])[:10]]}


# ---------------------------------------------------------------------------
# The step's device time by part
# ---------------------------------------------------------------------------


def _parents(host) -> list:
    """The index of each host event's innermost enclosing event on its
    thread (None at the top)."""
    parent = [None] * len(host)
    by_thread = defaultdict(list)
    for i, e in enumerate(host):
        by_thread[e.thread].append(i)
    for idx in by_thread.values():
        stack = []
        for i in sorted(idx, key=lambda i: (host[i].start, -host[i].end)):
            while stack and host[stack[-1]].end < host[i].end:
                stack.pop()
            parent[i] = stack[-1] if stack else None
            stack.append(i)
    return parent


def attribute(evs) -> dict:
    """{part: [device ns, operations]} of one eager step's profile, parts
    ``STEP_PARTS`` and "unattributed". A device operation goes to the
    innermost step span around the operator it was launched inside; one
    launched inside a backward node goes to the step span around the
    forward operator of the node's sequence number on its forward thread
    (the latest, where several carry it)."""
    host = [e for e in evs if e.kind in ("op", "span")]
    parent = _parents(host)
    by_corr = {e.corr: i for i, e in enumerate(host) if e.corr}
    forward = defaultdict(list)
    for i, e in enumerate(host):
        if e.kind == "op" and e.seq >= 0 and e.fwd_thread <= 0 and not e.name.startswith(
                _BACKWARD_NODE):
            forward[(e.thread, e.seq)].append(i)

    def up(i):
        while i is not None:
            yield i
            i = parent[i]

    def part(i):
        return next((host[j].name for j in up(i) if host[j].kind == "span"
                     and host[j].name in STEP_PARTS), None)

    out = {p: [0, 0] for p in STEP_PARTS + ("unattributed",)}
    for d in evs:
        if d.kind != "device":
            continue
        i, got = by_corr.get(d.linked) if d.linked else None, None
        if i is not None:
            node = next((j for j in up(i) if host[j].name.startswith(_BACKWARD_NODE)
                         and host[j].seq >= 0), None)
            if node is None:
                got = part(i)
            else:
                cands = forward.get((host[node].fwd_thread, host[node].seq), [])
                for j in sorted(cands, key=lambda j: -host[j].start):
                    got = part(j)
                    if got:
                        break
        row = out[got or "unattributed"]
        row[0] += d.end - d.start
        row[1] += 1
    return out


def eager_step(loop) -> list:
    """The :class:`Ev` list of one eager run of ``loop``'s step under
    torch.profiler, after one unprofiled; the parameters, the optimizer's
    state, the generator and the step index put back after both."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    leaves = [t.detach().clone() for t in loop.leaves]
    state = {k: v.detach().clone() for k, v in loop.state().items()}
    gen, index = loop.generator.get_state(), loop._i.clone()
    try:
        loop._step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loop._step()
            torch.cuda.synchronize()
    finally:
        with torch.no_grad():
            loop._put_back(leaves)
            for k, v in loop.state().items():
                v.copy_(state[k])
            loop._i.copy_(index)
        loop.generator.set_state(gen)
        loop.optimizer.zero_grad(set_to_none=True)
    return events_of(prof)


# ---------------------------------------------------------------------------
# Set-up's parts
# ---------------------------------------------------------------------------


def setup_parts(records) -> dict:
    """Seconds of set-up's spans (``profiling.Span`` records): the
    constructor (``model_s``) and the training loop's build less the kernel
    libraries built or loaded inside it (``capture_s``; a checkout's first
    run builds them, later runs load them), and their parts."""
    dur = lambda r: (r.end_ns - r.start_ns) / 1e9

    def within(r, name):
        p = r.parent
        while p is not None:
            if records[p].name == name:
                return True
            p = records[p].parent
        return False

    total = lambda name: sum(dur(r) for r in records if r.name == name)
    build = total("gpsa.loop.build")
    ops_in_build = sum(dur(r) for r in records if r.name == "gpsa.ops.build"
                       and within(r, "gpsa.loop.build"))
    return {"model_s": total("gpsa.model.init"), "kmeans_s": total("gpsa.model.kmeans"),
            "capture_s": build - ops_in_build, "build_s": build, "ops_build_s": ops_in_build,
            "prime_s": total("gpsa.loop.prime"), "warmup_s": total("gpsa.loop.warmup"),
            "graph_capture_s": total("gpsa.loop.capture"),
            "fit_s": total("gpsa.fit"), "fit_calls": sum(r.name == "gpsa.fit" for r in records)}


# ---------------------------------------------------------------------------
# The replica
# ---------------------------------------------------------------------------


def replica(cfg: dict, traffic: dict, seed: int, device: str = "cuda") -> dict:
    """Set-up, warm calls, a profiled call and an eager step, with spans
    on (module doc); the numbers the span metrics read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spatial_alignment_tpu_torch import ops
    from spatial_alignment_tpu_torch.models import train
    from spatial_alignment_tpu_torch.utils import profiling

    profiling.enable_spans(True)
    dev = torch.device(device)
    model, *_ = harness.setup(cfg, traffic, seed, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    setup = setup_parts(profiling.spans())
    setup["setup_s"] = setup_s

    # Whole calls of the window's length for WARM_S first: a run's window
    # turns the device to its fast phase within 1-20 s (PERF.md), and the
    # harness profiles its call after the window.
    call, n = harness.entry(traffic), int(traffic["profile_epochs"])
    ends, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < WARM_S:
        call.call(model, cfg, traffic, int(traffic["n_epochs"]))
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    log("spans, warm calls " + " ".join(f"{b - a:.4f}" for a, b in zip([t0] + ends, ends)))
    profiling.spans()
    before, captured = ops.read_counters(), train.captures
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # The profiler's first device activity waits for its buffers (an
        # "Activity Buffer Request" of 0.6-2.6 ms): taken here, not in the call.
        torch.zeros(1, device=dev).add_(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        call.call(model, cfg, traffic, n)
        torch.cuda.synchronize()
        wall = time.perf_counter_ns() - t0
    after = ops.read_counters()
    profiling.spans()
    steps = call.steps(traffic, n)
    idle = split_idle(events_of(prof), wall)
    idle.update(steps=steps, wall_s=wall / 1e9,
                captures=train.captures - captured,
                replays=after["loop.replays"] - before["loop.replays"])

    step = attribute(eager_step(model._train_loop_cache["loop"]))
    profiling.spans()
    return {"setup": setup, "call": idle,
            "step": {k: [ns / 1e6, n_ops] for k, (ns, n_ops) in step.items()}}


def report(out: dict):
    """The replica's log lines."""
    s, c, st = out["setup"], out["call"], out["step"]
    log(f"spans, set-up {s['setup_s']:.3f} s: constructor {s['model_s']:.3f} s (k-means "
        f"{s['kmeans_s']:.3f}); loop build {s['build_s']:.3f} s (kernel libraries "
        f"{s['ops_build_s']:.3f}, priming {s['prime_s']:.3f}, warm-up {s['warmup_s']:.3f}, "
        f"capture {s['graph_capture_s']:.3f}); {s['fit_calls']} fit() calls {s['fit_s']:.3f} s")
    log(f"spans, profiled call: {c['steps']} steps in {c['wall_s']:.4f} s, captures "
        f"{c['captures']}, loop.replays {c['replays']}; device events a step "
        f"{c['events'] / c['steps']:.1f}; idle {c['idle_share']:.4f} % = in-graph "
        f"{c['in_graph_share']:.4f} + host {c['host_share']:.4f} + outside gpsa.fit "
        f"{c['outside_share']:.4f} (device clock moved {c['shift_s'] * 1e6:.1f} us)")
    log("spans, host idle by label: " + "; ".join(f"{n} {v * 1e3:.4f} ms"
                                                  for n, v in c["host_by_label"]))
    log("spans, longest gaps: " + "; ".join(f"{n} {v * 1e6:.2f} us" for n, v in c["gaps"]))
    total = sum(ms for ms, _ in st.values())
    log(f"spans, eager step {total:.4f} device ms (busy a replayed step "
        f"{c['busy_s'] * 1e3 / c['steps']:.4f}): " + "; ".join(
            f"{k} {ms:.4f} ms / {n} ops" for k, (ms, n) in st.items()))


def main() -> int:
    req = json.loads(sys.stdin.read())
    import torch

    if not torch.cuda.is_available():
        log("spanrun needs a CUDA device")
        return 2
    out = replica(req["config"], req["traffic"], int(req["seed"]))
    report(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
