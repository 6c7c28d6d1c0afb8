"""The port's training loop: one step captured as a CUDA graph and replayed.

Counterpart of the JAX package's ``make_train_loop``, which runs a chunk of
steps as one ``lax.scan`` dispatch. Here one training step (loss forward,
backward and the optimizer's step) is captured once into a
``torch.cuda.CUDAGraph`` and replayed once a step, so one graph serves
chunks of every length. The step reads its per-step inputs (the warp
temperature, and the learning rate of a schedule) from device buffers at a
device-side step index and writes its loss into a device buffer at that
index. A chunk of n steps is one host-to-device copy of the chunk's
temperatures and learning rates, n replays and one device-to-host copy of
the n losses, with no host sync between.

Before capture the loop runs warm-up steps on a side stream (lazy state,
library handles and kernel builds happen there, as PyTorch's recipe asks),
then puts the parameters, the optimizer state and the generator back, so a
fit of n steps is n replays from the state it started in. The model's
generator is registered with the graph: each replay reads the generator's
offset as it stands and advances it, so every replay draws fresh noise and
a replay draws what an eager step from the same generator state draws.

Kernel counters (``ops.read_counters``) count a captured step once, at its
capture. The loop keeps that step's counts, sets the counters back to their
values before the warm-up and adds the step's counts once per replay, so
they count the steps a fit runs. The loop's own counter ``loop.replays``
(this module's ``COUNTERS``) is one of the step's counts: a replay adds 1.
The graphs captured, ``captures``, stay out of ``ops.read_counters()``,
so that a fit moves those by its steps times the step's counts alone.

Spans (``utils.profiling``, off by default): ``gpsa.loop.prime``,
``gpsa.loop.warmup`` and ``gpsa.loop.capture`` around the construction's
three parts (``VariationalGPSA.make_train_loop`` opens ``gpsa.loop.build``
around the optimizer's construction and the loop's); ``gpsa.loop.reset``
around a state reset or load; ``gpsa.loop.inputs``, ``gpsa.loop.replays``
and ``gpsa.loop.losses`` around a chunk's host-to-device copy, its steps
and its losses' copy back (the wait for the device included);
``gpsa.optimizer`` around the step's optimizer work. A replay runs no
Python, so it runs no span.

With ``width=R`` the step trains R restarts at once (``fit_multistart``):
the loss function returns their R losses, the step differentiates their
sum, so each restart's parameters get their own loss's gradient, and the
loop records the R losses of every step. Each optimizer the loop accepts
(``RESETTABLE_OPTIMIZERS``) updates each element from that element's
gradient and state alone, so one optimizer over R-stacked parameters is R
independent optimizers, as the JAX package's ``vmap`` of ``tx.update`` is.

A graph holds the optimizer state's tensors, so each fit starts afresh by
writing the state a new optimizer starts from into them: the loop records
each state tensor's value as the optimizer first stores it (NAdam's
``mu_product`` of 1, Rprop's step sizes, Adagrad's accumulators), during a
priming step on zero gradients.

On the CPU nothing is captured and the same step runs eagerly.
"""

from __future__ import annotations

import gc
import sys
from collections import defaultdict
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import ops
from ..utils import profiling

__all__ = ["CosineDecayAdam", "DEFAULT_LR", "TrainLoop", "check_resettable", "resolve_recipe",
           "same_factory"]

DEFAULT_LR = 1e-2

# The loop's counter (``ops.read_counters()``: "loop.replays"): replays of
# a captured step, counted as one of the step's counts (``per_step``).
COUNTERS = ("replays",)
replays = 0
# Graphs captured (read here, not through ``ops.read_counters()``).
captures = 0

# Steps between two host copies at most (the device buffers' length).
CAPACITY = 1024
# Eager steps on a side stream before capture.
WARMUP_STEPS = 2
# Elementwise optimizers whose fresh state is held in tensors from the
# first step on, so that writing the values they first stored back into
# those tensors gives the state a new one starts from. SGD qualifies without
# dampening: a zero momentum buffer then takes the first gradient as the
# missing buffer of a new SGD does.
RESETTABLE_OPTIMIZERS = (
    torch.optim.Adam, torch.optim.AdamW, torch.optim.Adamax, torch.optim.RMSprop,
    torch.optim.Adadelta, torch.optim.SGD, torch.optim.NAdam, torch.optim.RAdam,
    torch.optim.Adagrad, torch.optim.ASGD, torch.optim.Rprop,
)


def check_resettable(optimizer: torch.optim.Optimizer):
    """Raise unless ``optimizer`` is one of ``RESETTABLE_OPTIMIZERS``: SGD
    with dampening treats its first gradient apart (its buffer is missing,
    not zero), and an optimizer that is not elementwise (LBFGS) cannot
    train R-stacked restarts independently."""
    name = type(optimizer).__name__
    damped = isinstance(optimizer, torch.optim.SGD) and any(
        g["momentum"] and g["dampening"] for g in optimizer.param_groups
    )
    if type(optimizer) not in RESETTABLE_OPTIMIZERS or damped:
        raise ValueError(
            "fit() resets the optimizer's state in place at each call to the state a new one "
            "starts from, which it can do for the elementwise optimizers "
            f"{', '.join(o.__name__ for o in RESETTABLE_OPTIMIZERS)} (SGD without "
            f"dampening), not for {name}{' with dampening' if damped else ''}; step it with "
            "make_train_step, which builds a new one"
        )


class _FirstValues(dict):
    """One parameter's optimizer state that keeps a copy of each tensor as
    the optimizer first stores it (``first``, shared with the caller)."""

    def __init__(self, first: dict, *args):
        super().__init__(*args)
        self.first = first

    def __setitem__(self, key, value):
        if key not in self and isinstance(value, torch.Tensor):
            self.first[key] = value.detach().clone()
        super().__setitem__(key, value)


class _RecordingState(dict):
    """``optimizer.state`` during the priming step: each parameter's state
    is a :class:`_FirstValues` writing into ``fresh[param]``."""

    def __init__(self, fresh: dict, existing):
        super().__init__((p, _FirstValues(fresh.setdefault(p, {}), st))
                         for p, st in existing.items())
        self.fresh = fresh

    def __missing__(self, p):
        state = self[p] = _FirstValues(self.fresh.setdefault(p, {}))
        return state


class CosineDecayAdam:
    """Optimizer factory of ``recipe="accurate"``: Adam with its learning
    rate decayed from ``lr`` to ``lr / 100`` over ``horizon`` steps on
    ``CosineAnnealingLR``'s curve (the JAX package's
    ``optax.adam(optax.cosine_decay_schedule(lr, horizon, alpha=1e-2))``).

    Called on the parameters it returns ``torch.optim.Adam`` with its
    learning rate in a 0-d float32 tensor (``capturable`` on CUDA).
    ``lr_schedule(steps)`` gives the learning rate of each global step, the
    value ``CosineAnnealingLR`` holds after that many steps (the horizon's
    value past it), which ``fit`` writes into the tensor before the step.
    """

    def __init__(self, lr: float, horizon: int):
        self.lr, self.horizon = float(lr), max(1, int(horizon))
        self._values: Optional[np.ndarray] = None

    def __call__(self, params) -> torch.optim.Optimizer:
        params = list(params)
        dev = params[0].device
        lr = torch.tensor(self.lr, dtype=torch.float32, device=dev)
        return torch.optim.Adam(params, lr=lr, capturable=dev.type == "cuda")

    def lr_schedule(self, steps) -> np.ndarray:
        if self._values is None:
            opt = torch.optim.SGD([torch.zeros(1)], lr=self.lr)
            sched = torch.optim.lr_scheduler.CosineAnnealingLR(
                opt, T_max=self.horizon, eta_min=self.lr * 1e-2
            )
            values = [self.lr]
            for _ in range(self.horizon):
                opt.step()
                sched.step()
                values.append(sched.get_last_lr()[0])
            self._values = np.asarray(values, np.float32)
        return self._values[np.minimum(np.asarray(steps), self.horizon)]


def resolve_recipe(recipe, lr, n_epochs, optimizer, warp_temperature_schedule):
    """Expand a named recipe into (optimizer factory, temperature schedule),
    as the JAX package's ``_resolve_recipe``: "accurate" is
    :class:`CosineDecayAdam` over ``n_epochs`` with the temperature-0
    objective; an optimizer or schedule given explicitly wins."""
    if recipe == "accurate":
        if optimizer is None:
            optimizer = CosineDecayAdam(lr, n_epochs)
        if warp_temperature_schedule is None:
            warp_temperature_schedule = lambda t: np.zeros_like(np.asarray(t, np.float32))
    return optimizer, warp_temperature_schedule


def same_factory(a, b) -> bool:
    """Whether a train loop built by optimizer factory ``a`` serves ``b``: the
    same object, or two CosineDecayAdam at one lr (the graph reads the
    learning rate from a tensor each step, so their horizons do not enter
    it; each fit takes its schedule from its own factory)."""
    if type(a) is CosineDecayAdam and type(b) is CosineDecayAdam:
        return a.lr == b.lr
    return a is b


class TrainLoop:
    """Runs training steps of ``loss_fn`` under ``optimizer``: on CUDA one
    replay each of a captured step, on the CPU the same step eagerly.

    ``named_params``: [(path, leaf)] the optimizer updates; ``loss_fn(temp)``
    the step's loss at warp temperature ``temp`` (a 0-d tensor), drawing its
    noise from ``generator``; ``scheduled``: every parameter group's
    learning rate is a tensor that each step sets from the chunk's
    schedule; ``width``: ``loss_fn`` returns that many losses, one a
    restart, and the step minimizes their sum. ``capture=False`` runs the
    step eagerly on CUDA too (a distributed step on a gloo group, whose
    collectives cannot be captured; NCCL's can). Raises when the
    optimizer's state cannot be reset in place (:func:`check_resettable`),
    and on CUDA when the step cannot be captured.
    """

    def __init__(
        self,
        named_params: List[Tuple[str, torch.Tensor]],
        loss_fn: Callable[[torch.Tensor], torch.Tensor],
        optimizer: torch.optim.Optimizer,
        generator: torch.Generator,
        scheduled: bool = False,
        width: Optional[int] = None,
        capture: bool = True,
    ):
        check_resettable(optimizer)
        self.width = width
        self.names = [name for name, _ in named_params]
        self.leaves = [leaf for _, leaf in named_params]
        self.loss_fn, self.optimizer, self.generator = loss_fn, optimizer, generator
        self.device = self.leaves[0].device
        self._lrs = [g["lr"] for g in optimizer.param_groups] if scheduled else []
        if not all(isinstance(lr, torch.Tensor) for lr in self._lrs):
            raise ValueError(
                f"a learning-rate schedule needs {type(optimizer).__name__}'s lr as a tensor"
            )
        # Row 0: each step's warp temperature; row 1: its learning rate.
        self._inputs = torch.ones((2, CAPACITY), dtype=torch.float32, device=self.device)
        self._losses = torch.zeros((CAPACITY,) + ((width,) if width else ()),
                                   dtype=torch.float32, device=self.device)
        self._i = torch.zeros(1, dtype=torch.long, device=self.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.per_step: dict = {}
        counts = ops.read_counters()
        self._prime()
        if self.device.type == "cuda" and capture:
            self._capture()
        ops.set_counters(counts)
        if self.graph is not None:
            global captures
            captures += 1

    # ------------------------------------------------------------------
    def _step(self):
        with profiling.span("gpsa.optimizer"):
            self.optimizer.zero_grad(set_to_none=True)
            temp, lr = torch.index_select(self._inputs, 1, self._i)
            for group_lr in self._lrs:
                group_lr.copy_(lr.reshape(()))
        loss = self.loss_fn(temp.reshape(()))
        (loss.sum() if self.width else loss).backward()
        with profiling.span("gpsa.optimizer"):
            self.optimizer.step()
            self._losses.index_copy_(0, self._i, loss.detach().reshape(self._losses[:1].shape))
            self._i.add_(1)

    def _put_back(self, saved):
        with torch.no_grad():
            for leaf, value in zip(self.leaves, saved):
                leaf.copy_(value)

    @profiling.spanned("gpsa.loop.prime")
    def _prime(self):
        """Create the optimizer's state by one step on zero gradients,
        recording each state tensor's value as the optimizer first stores
        it (state it made at construction counts as stored then), then put
        the parameters back and reset the state: a fresh state, held in
        tensors that :meth:`reset_state` and :meth:`load_state` write."""
        saved = [leaf.detach().clone() for leaf in self.leaves]
        opt = self.optimizer
        fresh = {p: {k: v.detach().clone() for k, v in st.items() if isinstance(v, torch.Tensor)}
                 for p, st in opt.state.items()}
        opt.state = _RecordingState(fresh, opt.state)
        try:
            for leaf in self.leaves:
                leaf.grad = torch.zeros_like(leaf)
            opt.step()
        finally:
            opt.state = defaultdict(dict, {p: dict(st) for p, st in opt.state.items()})
        opt.zero_grad(set_to_none=True)
        self._put_back(saved)
        self._fresh = {f"{name}/{key}": fresh.get(leaf, {}).get(key)
                       for name, leaf in zip(self.names, self.leaves)
                       for key, value in opt.state.get(leaf, {}).items()
                       if isinstance(value, torch.Tensor)}
        missing = [k for k, v in self._fresh.items() if v is None]
        if missing:
            raise ValueError(f"{type(opt).__name__} stored its state {missing} in a way "
                             "the loop cannot reset")
        self.reset_state()

    def _capture(self):
        name = type(self.optimizer).__name__
        if any(g.get("capturable") is False for g in self.optimizer.param_groups):
            raise RuntimeError(
                f"{name} was built with capturable=False: fit() on CUDA runs each step "
                "as a replay of a captured CUDA graph; build it with capturable=True"
            )
        if torch.is_anomaly_enabled():
            raise RuntimeError(
                "autograd anomaly detection syncs the host in every backward and cannot "
                "be captured; debug the step eagerly with make_train_step"
            )
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                "this PyTorch cannot register a generator with a CUDA graph, so replays "
                "would repeat one draw of the noise"
            )
        saved = [leaf.detach().clone() for leaf in self.leaves]
        gen_state = self.generator.get_state()
        try:
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side), profiling.span("gpsa.loop.warmup"):
                for _ in range(WARMUP_STEPS):
                    self._step()
            main.wait_stream(side)
            self._put_back(saved)
            self.reset_state()
            self.generator.set_state(gen_state)
            self.optimizer.zero_grad(set_to_none=True)
            # A dead graph freed by the collector during this capture would
            # end it (a graph's teardown is not allowed while one is captured).
            gc.collect()
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self.generator)
            before = ops.read_counters()
            with profiling.span("gpsa.loop.capture"), torch.cuda.graph(
                graph, capture_error_mode="global"
            ):
                self._step()
            after = ops.read_counters()
        except Exception as e:
            raise RuntimeError(f"could not capture a training step with {name}: {e}") from e
        self.per_step = {k: after[k] - before[k] for k in after}
        self.per_step["loop.replays"] = 1
        self.graph = graph

    # ------------------------------------------------------------------
    def run(self, temps: np.ndarray, lrs: Optional[np.ndarray] = None) -> np.ndarray:
        """``len(temps)`` steps at those warp temperatures (and learning
        rates, when scheduled); returns their losses as float64, (n,) or
        (n, width)."""
        n = len(temps)
        out = np.empty((n,) + tuple(self._losses.shape[1:]), np.float64)
        for lo in range(0, n, CAPACITY):
            k = min(CAPACITY, n - lo)
            host = np.ones((2, k), np.float32)
            host[0] = temps[lo : lo + k]
            if lrs is not None:
                host[1] = lrs[lo : lo + k]
            with profiling.span("gpsa.loop.inputs"):
                self._inputs[:, :k].copy_(torch.from_numpy(host))
                self._i.zero_()
            with profiling.span("gpsa.loop.replays"):
                if self.graph is None:
                    for _ in range(k):
                        self._step()
                else:
                    for _ in range(k):
                        self.graph.replay()
                    ops.add_counters(self.per_step, k)
            with profiling.span("gpsa.loop.losses"):
                out[lo : lo + k] = self._losses[:k].cpu().numpy()
        return out

    def state(self) -> dict:
        """{"<leaf path>/<state name>": tensor} of the optimizer's state (the
        live tensors, e.g. Adam's ``exp_avg``, ``exp_avg_sq`` and ``step``)."""
        return {
            f"{name}/{key}": value
            for name, leaf in zip(self.names, self.leaves)
            for key, value in self.optimizer.state.get(leaf, {}).items()
            if isinstance(value, torch.Tensor)
        }

    @profiling.spanned("gpsa.loop.reset")
    def reset_state(self):
        """A fresh optimizer state in place: every state tensor set to the
        value the optimizer first stored in it (zero for Adam's moments and
        step count, one for NAdam's ``mu_product``)."""
        with torch.no_grad():
            for key, value in self.state().items():
                value.copy_(self._fresh[key])

    @profiling.spanned("gpsa.loop.reset")
    def load_state(self, flat: dict):
        """Write a saved state ({path: array}, as :meth:`state` names it)
        into the optimizer's state tensors in place."""
        name = type(self.optimizer).__name__
        with torch.no_grad():
            for key, value in self.state().items():
                if key not in flat:
                    raise ValueError(f"the checkpoint has no {name} state {key!r}")
                arr = np.asarray(flat[key])
                if arr.shape != tuple(value.shape):
                    raise ValueError(
                        f"{name} state {key!r}: checkpoint shape {arr.shape}, "
                        f"optimizer {tuple(value.shape)}"
                    )
                value.copy_(torch.from_numpy(arr))


ops.register_counted("loop", sys.modules[__name__])
