"""The benchmark's machinery: a cell's files, the inputs, the program's
set-up, the timed window, the traced measurements and the comparison that
decides ``correct``.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs/<config>.json``: data, model and training shapes,
the starting parameters, the control's options) and a traffic mix
(``traffic/<traffic>.json``: the entry a window repeats, its epochs a call,
minibatch and model options); its comparison limits are
``limits/<cell>.json``. The entry is ``entries/<entry>.py``, the data's
generator ``generators/<generator>.py`` and each per-layer metric's reader
``metrics/<metric>.py``, all found by name. Nothing here names a cell, a
configuration, an entry, a generator or a metric.

A configuration's model has one modality or several (:mod:`.datagen` gives
the schema): ``model.n_latent_gps`` an integer (the one modality
``expression`` through that many LMC latents) or ``{modality: int |
null}`` (null: no LMC), and ``model.n_noise_variance_params`` optional.
The data passes through here as {modality: (coordinates, outputs,
per-view counts)} in the model's order; the aligned coordinates compared
are the moving view's points of every modality, in that order.

The program under test is ``spatial_alignment_tpu_torch``, imported inside
the functions that use it; the reference (:mod:`.reference`) imports
nothing of it.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from gpsa_bench import byname, datagen, peaks, reference

BENCH_DIR = byname.BENCH_DIR
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spatial_alignment_tpu")


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def resolve(workload: str, bench: Optional[dict] = None) -> dict:
    """Everything a cell runs with: its entry, configuration, traffic,
    limits (None before they are set), end-to-end and per-layer metrics."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    limits_path = BENCH_DIR / "limits" / f"{workload}.json"
    reports = lambda m: "workloads" not in m or workload in m["workloads"]
    end_to_end = [m for m in bench["end_to_end"] if reports(m)]
    moved = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in moved and reports(m)]
    return {"cell": cell, "config": config, "traffic": traffic,
            "limits": load_json(limits_path) if limits_path.exists() else None,
            "end_to_end": end_to_end, "per_layer": per_layer}


def reader(metric: str):
    """The module that reads per-layer metric ``metric``."""
    return byname.load("metrics", metric)


def entry(traffic: dict):
    """The module of the traffic mix's entry (``entries/<entry>.py``)."""
    return byname.load("entries", traffic["entry"])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# Inputs and the program's set-up
# ---------------------------------------------------------------------------


def flat(tree, prefix: str = "") -> dict:
    """{"a/b": leaf} of a nested dict, in its order."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _lloyd(x: torch.Tensor, k: int, gen, iters: int = 20) -> torch.Tensor:
    """k-means centres of x (n, D): k points drawn without replacement,
    then ``iters`` Lloyd steps. The clusters' sums are taken on the host,
    where ``index_add_`` adds in one order: on a CUDA device it adds by
    atomics, and the centres, and so the whole start, would differ by
    rounding from one process to the next at the same seed."""
    c = x[torch.randperm(x.shape[0], generator=gen, device=x.device)[:k]].clone()
    x_host = x.cpu()
    for _ in range(iters):
        lab = torch.cdist(x, c).argmin(1)
        sums = torch.zeros_like(x_host[:k]).index_add_(0, lab.cpu(), x_host).to(x.device)
        cnt = torch.bincount(lab, minlength=k).to(x.dtype)
        c = torch.where(cnt[:, None] > 0, sums / cnt.clamp_min(1)[:, None], c)
    return c


def _view(nsl, v: int) -> slice:
    """View ``v``'s rows of a modality whose views hold ``nsl`` points."""
    return slice(sum(nsl[:v]), sum(nsl[:v + 1]))


def _prior_factor(Z: torch.Tensor, log_ls: float, log_var: float) -> torch.Tensor:
    """Cholesky factor, in float64, of the RBF prior covariance at the
    inducing points Z with relative jitter 1e-6."""
    Z = Z.double()
    K = math.exp(log_var) * torch.exp(-0.5 * torch.cdist(Z, Z).square() / math.exp(log_ls) ** 2)
    return torch.linalg.cholesky(K + 1e-6 * math.exp(log_var) * torch.eye(
        Z.shape[0], dtype=K.dtype, device=K.device))


def make_init(cfg: dict, data: dict, seed: int) -> dict:
    """The configuration's own starting parameters (its ``init``), drawn
    from ``seed`` on the data's device, in place of the constructor's; both
    the program and the reference start from them.

    Inducing points are k-means centres of each view's points of every
    modality and of all coordinates, as the model's constructor places
    them; the kernels' log lengthscales and the variational posteriors'
    shape are the configuration's ``init``. Each posterior is shaped by its
    prior, as a trained model's is: the mean is the prior mean plus
    ``warp_scale`` (warp layer) or one (data layer) times a draw from the
    prior, and the factor of the covariance is sqrt(``posterior_scale``)
    chol(Kuu) (I + 0.1 E) for a standard normal E. (At the constructor's
    own starting point, lengthscales 10, 0.1 randn factors and randn means,
    the program's float32 Grams by the expansion |x|^2 + |z|^2 - 2 x.z lose
    three digits of the step: PERF.md, Open questions.) Each modality has
    its own data-layer posterior, of L latents with LMC and of P without,
    and a W only with LMC. LMC weights and the data kernel's variance are
    randn, the ``n_noise_variance_params`` noise terms randn - 1, the warp
    kernels' variance 1, as the constructor draws them. The draws come in
    one order whatever the modalities: the k-means, the data kernel's
    variance, the noise, the warp posterior, then each modality's
    posterior and W in turn."""
    model, init_cfg = cfg["model"], cfg["init"]
    lmc = datagen.modalities(cfg)
    X0, _, nsl0 = next(iter(data.values()))
    V, D, dev = len(nsl0), X0.shape[1], X0.device
    mX, mG = int(model["m_X_per_view"]), int(model["m_G"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) * 2 + 2)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev, dtype=torch.float64)
    view = lambda v: torch.cat([x[_view(nsl, v)] for x, _, nsl in data.values()])
    Xtilde = torch.stack([_lloyd(view(v), mX, gen) for v in range(V)])
    Gtilde = _lloyd(torch.cat([x for x, _, _ in data.values()]), mG, gen)
    wls, dls = float(init_cfg["warp_log_lengthscale"]), float(init_cfg["data_log_lengthscale"])
    c = math.sqrt(float(init_cfg["posterior_scale"]))
    data_var = randn(1)
    Lw = torch.stack([_prior_factor(Xtilde[v], wls, 0.0) for v in range(V)])  # (V, m, m)
    Ld = _prior_factor(Gtilde, dls, float(data_var))
    shaped = lambda Lk, *lead: c * Lk @ (torch.eye(Lk.shape[-1], dtype=Lk.dtype, device=dev)
                                         + 0.1 * randn(*lead, Lk.shape[-1], Lk.shape[-1]))
    init = {
        "noise_variance": randn(int(model.get("n_noise_variance_params", 2))) - 1.0,
        "warp_kernel_variances": torch.zeros(V, device=dev),
        "warp_kernel_lengthscales": torch.full((V,), wls, device=dev),
        "data_kernel_lengthscale": torch.full((1,), dls, device=dev),
        "data_kernel_variance": data_var,
        "Xtilde": Xtilde,
        "Gtilde": Gtilde,
        "delta_G": Xtilde + float(init_cfg["warp_scale"]) * (Lw @ randn(V, mX, D)),
        "Omega_sqt_G": shaped(Lw[:, None], V, D),
    }
    for mod, (_, Y, _) in data.items():
        P = Y.shape[1]
        L = P if lmc[mod] is None else lmc[mod]
        init[f"Omega_sqt_F/{mod}"] = shaped(Ld, L)
        init[f"delta_F/{mod}"] = Ld @ randn(mG, L)
        if lmc[mod] is not None:
            init[f"W/{mod}"] = randn(L, P)
    return {k: v.float().contiguous() for k, v in init.items()}


def build_model(cfg: dict, traffic: dict, data: dict, seed: int, device):
    """The program's model of configuration ``cfg`` with the traffic's
    model options, constructed as a user does (its own seeded init)."""
    from spatial_alignment_tpu_torch import VariationalGPSA

    kw = dict(cfg["model"])
    kw.update(traffic.get("model_options") or {})
    kw["n_latent_gps"] = datagen.modalities(cfg)
    data_dict = {mod: {"spatial_coords": X.cpu().numpy(), "outputs": Y.cpu().numpy(),
                       "n_samples_list": list(nsl)} for mod, (X, Y, nsl) in data.items()}
    return VariationalGPSA(data_dict, seed=int(seed), device=device, **kw)


def install(model, init: dict):
    """Write ``init`` into the model's parameter tensors in place."""
    params = flat(model.params)
    if set(params) != set(init):
        raise RuntimeError(f"the model's parameters {sorted(params)} are not the "
                           f"benchmark's {sorted(init)}")
    with torch.no_grad():
        for k, t in params.items():
            if tuple(t.shape) != tuple(init[k].shape):
                raise RuntimeError(f"{k}: model {tuple(t.shape)}, benchmark {tuple(init[k].shape)}")
            t.copy_(init[k])


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------


def _leaf_gaps(prog: dict, ref: dict, names) -> list:
    """Each leaf's gap between the program's norm and the reference's,
    against the larger of the reference's norm of that leaf and of the
    median leaf."""
    norms = {k: float(ref[k].norm()) for k in names}
    med = statistics.median(norms.values())
    return [abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], med, 1e-300)
            for k in names]


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """{"grad": {leaf: gap}, "change": {leaf: gap}}: each leaf's gap of the
    first gradient and of the parameters' change over the first steps
    (leaving out the leaves whose reference gradient is under a thousandth
    of the median leaf's), by :func:`_leaf_gaps`."""
    names = list(ref["grads"])
    gnorm = {k: float(ref["grads"][k].norm()) for k in names}
    med = statistics.median(gnorm.values())
    moving = [k for k in names if gnorm[k] >= 1e-3 * med]
    d_prog = {k: prog["params"][k].double() - prog["init"][k].double() for k in names}
    d_ref = {k: ref["params"][k] - prog["init"][k].double() for k in names}
    return {"grad": dict(zip(names, _leaf_gaps(prog["grads"], ref["grads"], names))),
            "change": dict(zip(moving, _leaf_gaps(d_prog, d_ref, moving)))}


def readings(prog: dict, ref: dict, data: dict) -> dict:
    """The numbers that can be compared (a cell's limits file names those
    that are): ``loss`` the largest relative gap of the first steps'
    losses, ``loss_first`` the first step's; ``grad`` the first gradient's
    worst leaf, ``grad_median`` its median leaf; ``change`` and
    ``change_median`` the same of the parameters' change over the first
    steps (:func:`leaf_gaps`); ``aligned`` the largest gap of the moving
    view's aligned coordinates after them and ``aligned_start`` at the
    starting parameters, over the extent of all modalities' coordinates."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    leaves = leaf_gaps(prog, ref)
    grad, change = list(leaves["grad"].values()), list(leaves["change"].values())
    coords = torch.cat([x for x, _, _ in data.values()])
    extent = float((coords.max(0).values - coords.min(0).values).max())
    gap = lambda k: float((prog[k].double() - ref[k]).abs().max()) / extent
    return {"loss": max(gaps), "loss_first": gaps[0], "grad": max(grad),
            "grad_median": statistics.median(grad), "change": max(change),
            "change_median": statistics.median(change), "aligned": gap("aligned"),
            "aligned_start": gap("aligned_start")}


def follow_reference(init: dict, data: dict, cfg: dict, traffic: dict, model_seed: int,
                     precision: reference.Precision) -> dict:
    """The reference (in another precision, or with a planted fault)
    through the entry's first steps, and its aligned coordinates after
    them."""
    with _tf32_off():
        losses, grads, params = entry(traffic).follow(init, data, cfg, traffic, model_seed,
                                                      precision)
        view = _moving_view(cfg, data)
        aligned = lambda p: reference.aligned_means(
            {k: v.to(precision.dtype) for k, v in p.items()}, data, cfg, view, precision).double()
        return {"losses": losses, "grads": grads, "params": params, "aligned": aligned(params),
                "aligned_start": aligned(init), "init": init}


class _tf32_off:
    """PyTorch's TF32 switches off inside: the reference's float32 products
    are float32 (its control rounds its operands itself)."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def _moving_view(cfg: dict, data: dict) -> int:
    fixed = cfg["model"].get("fixed_view_idx")
    V = len(next(iter(data.values()))[2])
    return next(v for v in range(V) if v != fixed)


def program_aligned(model, data: dict, cfg: dict, params: dict):
    """``predict``'s aligned coordinates of the moving view's points of
    every modality, in the model's order, at ``params`` (the program's own
    parameters after the first steps, written back)."""
    install(model, params)
    view = _moving_view(cfg, data)
    G_means, _, _ = model.predict({mod: X.cpu().numpy() for mod, (X, _, _) in data.items()})
    dev = next(iter(data.values()))[0].device
    return torch.cat([torch.as_tensor(G_means[mod][_view(nsl, view)], device=dev)
                      for mod, (_, _, nsl) in data.items()])


def judge(values: dict, limits: Optional[dict]) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers the limits
    name: every one finite and within its limit; no limits, not correct."""
    if not limits:
        return False, {k: {"value": v, "limit": None} for k, v in values.items()}
    checks = {k: {"value": values[k], "limit": lim} for k, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


# ---------------------------------------------------------------------------
# Traced measurements
# ---------------------------------------------------------------------------


def median_ms(fn, n: int = 20, reps: int = 5, warmup: int = 3) -> float:
    """Device ms of one call of ``fn``: the median over ``reps`` batches of
    ``n`` calls queued behind a device-side sleep longer than the host takes
    to issue them, of the batch's CUDA-event time over ``n``."""
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(10**7)
    e.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10**7 / s.elapsed_time(e)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int((2 * issue_ms + 1.0) * cycles_per_ms))
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / n)
    return sorted(times)[reps // 2]


def op_calls(model, cfg: dict, traffic: dict, ops: dict) -> dict:
    """{op name: [{"args", "fwd_ms"[, "bwd_ms"]}]}: the calls one step makes
    to each op's entry points (``ops``: name -> reader's OP), spied on
    during one eager loss and gradient, then each timed alone."""
    import importlib

    calls = {name: [] for name in ops}
    patched = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            if kwargs:
                raise RuntimeError(f"{name}: keyword arguments are not recorded")
            calls[name].append({"fn": fn, "args": [a.detach() if torch.is_tensor(a) else a
                                                   for a in args]})
            return fn(*args)
        return wrapped

    for name, op in ops.items():
        for module, attr in op["patch"]:
            mod = importlib.import_module(module)
            orig = getattr(mod, attr)
            patched.append((mod, attr, orig))
            setattr(mod, attr, spy(name, orig))
    try:
        entry(traffic).loss_and_grad(model, cfg, traffic)
    finally:
        for mod, attr, orig in reversed(patched):
            setattr(mod, attr, orig)
    for name, op in ops.items():
        for c in calls[name]:
            fn, args = c.pop("fn"), c["args"]
            with torch.no_grad():
                c["fwd_ms"] = median_ms(lambda: fn(*args))
            if op.get("backward"):
                leaves = [a.clone().requires_grad_(True) if torch.is_tensor(a)
                          and a.is_floating_point() else a for a in args]
                out = fn(*leaves)
                wrt = [a for a in leaves if torch.is_tensor(a) and a.requires_grad]
                dy = torch.randn_like(out)
                c["bwd_ms"] = median_ms(
                    lambda: torch.autograd.grad(out, wrt, dy, retain_graph=True))
    return calls


def profile_call(model, cfg: dict, traffic: dict, n_epochs: int) -> dict:
    """One call of the entry of ``n_epochs`` under torch.profiler: its steps, wall
    seconds, device-busy seconds (the union of device operations), device
    operations (kernels, copies, sets), and the breakdown: the device
    operations that took most time and the longest idle gaps with what the
    host was doing in them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        entry(traffic).call(model, cfg, traffic, n_epochs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in dev)
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for s, e, _ in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    totals = {}
    for s, e, name in spans:
        totals[name] = totals.get(name, 0.0) + (e - s) / 1e6

    def doing(a, b):
        """The host operation that overlaps gap (a, b) most (the shorter of
        two that overlap it alike)."""
        best = max(((min(b, h.time_range.end) - max(a, h.time_range.start),
                     -h.time_range.elapsed_us(), h.name) for h in host), default=None)
        return best[2] if best is not None and best[0] > 0 else "host outside any traced op"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "steps": entry(traffic).steps(traffic, n_epochs), "wall_s": wall, "busy_s": busy / 1e6, "events": len(spans),
        "breakdown": {
            "device_ops": [[n, t] for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[doing(a, b), (b - a) / 1e6] for a, b in gaps[:10]],
        },
    }


def graph_pool_bytes(model) -> Optional[int]:
    """Bytes the allocator holds for the model's cached fit loop's captured
    graph (its private pool's segments), or None where there is none."""
    cache = model.__dict__.get("_train_loop_cache")
    graph = cache["loop"].graph if cache else None
    if graph is None:
        return None
    pool = tuple(graph.pool())
    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0]:
        return None
    return sum(s["total_size"] for s in segments if tuple(s["segment_pool_id"]) == pool)


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------


def setup(cfg: dict, traffic: dict, seed: int, dev):
    """Set-up of a run: the inputs from ``seed``, the model as a user builds
    it, the configuration's starting parameters written into it (where its
    ``init`` is null, the constructor's are kept), and the entry's first
    calls (the first captures the step). Returns (model, the data as
    {modality: (coordinates, outputs, counts)}, starting parameters, the
    program's first steps)."""
    t0 = time.perf_counter()
    data = datagen.make_data(cfg, seed, dev)
    t1 = time.perf_counter()
    model = build_model(cfg, traffic, data, int(seed), dev)
    t2 = time.perf_counter()
    if cfg.get("init") is None:
        init = {k: v.detach().clone() for k, v in flat(model.params).items()}
    else:
        init = make_init(cfg, data, seed)
        install(model, init)
    t3 = time.perf_counter()
    prog = entry(traffic).first_steps(model, cfg, traffic)
    prog["init"] = init
    log(f"set-up parts: data {t1 - t0:.3f} s, model {t2 - t1:.3f} s, starting parameters "
        f"{t3 - t2:.3f} s, first calls {time.perf_counter() - t3:.3f} s")
    return model, data, init, prog


def program_outputs(model, data: dict, cfg: dict, prog: dict):
    """Add to ``prog`` the program's aligned coordinates at the starting
    parameters and after the first steps (both written back in turn)."""
    prog["aligned_start"] = program_aligned(model, data, cfg, prog["init"])
    prog["aligned"] = program_aligned(model, data, cfg, prog["params"])


def free(dev):
    """Give back the memory of what the caller dropped (a model and its
    captured graph)."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", resolved: Optional[dict] = None) -> dict:
    """One run of a cell: set-up, the window, with ``trace`` the per-layer
    measurements, then the comparison. Returns the result line's object.
    ``t_start`` is the process's start on ``time.perf_counter``'s clock."""
    r = resolved or resolve(workload)
    cfg, traffic = r["config"], r["traffic"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    model_seed = int(seed)

    # Set-up: inputs, the model as a user builds it, the configuration's
    # starting parameters, the entry's first calls (the first captures).
    model, data, init, prog = setup(cfg, traffic, seed, dev)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    # The window: whole calls of the cell's entry while the time lasts.
    n_epochs = int(traffic["n_epochs"])
    call = entry(traffic)
    steps, failed, calls = 0, 0, []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        losses = call.call(model, cfg, traffic, n_epochs)
        calls.append(time.perf_counter())
        steps += call.steps(traffic, n_epochs)
        failed += int(sum(not math.isfinite(v) for v in losses))
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    ends = [t0] + calls
    log(f"window {steps} steps in {window_s:.3f} s; calls "
        + " ".join(f"{b - a:.4f}" for a, b in zip(ends, ends[1:])))
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)

    metrics, device_info, breakdown = {}, {}, None
    if not trace:
        values = {"train_steps_per_s": (steps / window_s, "steps/s"),
                  "peak_mem_gib": (peak / 2**30, "GiB"),
                  "setup_s": (setup_s, "s")}
        for m in r["end_to_end"]:
            v, unit = values[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": unit}
    else:
        readers = {m["name"]: reader(m["name"]) for m in r["per_layer"]}
        ops = {mod.OP["name"]: mod.OP for mod in readers.values() if hasattr(mod, "OP")}
        card = torch.cuda.get_device_name(dev)
        ctx = {"config": cfg, "traffic": traffic, "peaks": peaks.for_device(card),
               "window": {"steps": steps, "seconds": window_s},
               "graph_pool_bytes": graph_pool_bytes(model)}
        ctx["profile"] = profile_call(model, cfg, traffic, int(traffic["profile_epochs"]))
        ctx["ops"] = op_calls(model, cfg, traffic, ops) if ops else {}
        for name, mod in readers.items():
            v = mod.read(ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": next(
                    m["unit"] for m in r["per_layer"] if m["name"] == name)}
        device_info = {"busy_s": ctx["profile"]["busy_s"], "window_s": ctx["profile"]["wall_s"]}
        breakdown = ctx["profile"]["breakdown"]

    # The comparison, once the window has closed and the peak is read: the
    # program's aligned coordinates at its parameters after the first
    # steps, the program freed, then the reference through the same steps.
    program_outputs(model, data, cfg, prog)
    del model
    free(dev)
    t0 = time.perf_counter()
    ref = follow_reference(init, data, cfg, traffic, model_seed, reference.Precision())
    log(f"reference {time.perf_counter() - t0:.3f} s; losses, program "
        + " ".join(repr(v) for v in prog["losses"]) + "; reference "
        + " ".join(repr(v) for v in ref["losses"]))
    values = readings(prog, ref, data)
    correct, checks = judge(values, r["limits"])
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    out = {"correct": correct, "attempted": steps, "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak), **device_info}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["card"] = power_limit() if cuda else "cpu"
    out["checks"] = checks
    return out


class ForbiddenImport(RuntimeError):
    def __init__(self, names):
        super().__init__(f"modules of JAX or the JAX package are loaded: {', '.join(names)}")
        self.names = names
