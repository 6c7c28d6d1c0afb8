"""``fit_multistart`` in PyTorch: restarts, init families and selection.

Counterpart of the multistart part of ``spatial_alignment_tpu/models/
vgpsa.py`` (``reinitialize``, ``_holdout_split``, ``_predictive_score``,
``_alignment_consistency``, ``_warp_init_transforms``,
``_apply_warp_seed``, ``_fit_restarts_vectorized``, ``fit_multistart``),
as methods :class:`.vgpsa.VariationalGPSA` inherits from
:class:`MultistartMixin`.

The vectorized path trains R restarts as one step: the per-restart loss is
``torch.func.vmap``-ed over R-stacked parameters and the R losses' sum is
differentiated, so restart r's parameters get restart r's gradient. The
vmapped dim reaches every kernel as one more leading batch dim (the
``vmap`` rules of the autograd Functions in :mod:`..ops`), so one R-wide
step launches each kernel as often as one restart's step does, with R
times the batch. On CUDA the step is captured once as a CUDA graph
(:class:`.train.TrainLoop` with ``width=R``) and replayed once a step.

Divergences from the JAX package: the Monte-Carlo noise and minibatch
indices of all R restarts come from the model's ``torch.Generator``,
reseeded with the wave's first seed, in one draw a step
(:func:`.core.draw_restart_noise`), not from ``jax.random.split`` keys, so
the sample streams differ; and ``vectorized="auto"`` also needs an
optimizer factory that builds one of :data:`.train.ZERO_STATE_OPTIMIZERS`,
each of which updates every element from its own gradient and state, so
one optimizer over R-stacked parameters is R independent ones. Restarts are
not spread over several devices.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.gram import gram_force
from . import core
from ._trees import copy_into, leaves, named_leaves, tree_equal, tree_map
from .params import init_params, merge_hyperparams
from .spec import _as_numpy, view_slices
from .train import DEFAULT_LR, TrainLoop, check_zero_state, resolve_recipe, same_factory

# fit() options the vectorized path runs (everything else trains sequentially).
_VEC_KEYS = {"lr", "S", "optimizer", "warp_temperature_schedule", "minibatch_size"}


def _snapshot(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


class MultistartMixin:
    """The multistart methods of :class:`.vgpsa.VariationalGPSA`."""

    # None draws each R-wide step's noise (and minibatch indices) from the
    # model's generator; the tests set a function (R, S) -> (warp_noise,
    # data_noise, indices), as :func:`.core.draw_restart_noise` returns
    # them, to inject the JAX package's draws (a captured step calls it once,
    # at capture).
    _draw_restart_noise = None

    def reinitialize(self, seed: int):
        """Draw a fresh parameter initialization with ``seed`` (host-side,
        same spec), written in place into the model's parameter tensors, and
        reseed the generator: a cached train loop keeps serving ``fit()``."""
        if self._init_args is None:
            raise RuntimeError(
                "reinitialize() needs the original data_dict; this model was "
                "rebuilt from a checkpoint (VariationalGPSA.load) — call "
                "attach_data(data_dict) first"
            )
        a = self._init_args
        params, consts, spec = init_params(
            self.spec, a["data_dict"], data_init=a["data_init"], grid_init=a["grid_init"],
            seed=seed, fixed_warp_kernel_variances=a["fixed_warp_kernel_variances"],
            fixed_warp_kernel_lengthscales=a["fixed_warp_kernel_lengthscales"],
            fixed_data_kernel_lengthscales=a["fixed_data_kernel_lengthscales"],
            device=self.device,
        )
        copy_into(self.params, params)
        # consts and the spec are seed-independent: the objects are kept
        # when equal, so cached train loops survive restarts.
        if not tree_equal(consts, self.consts):
            self.consts = consts
        if spec != self.spec:
            self.spec = spec
        self._gen.manual_seed(int(seed))
        self._seed = int(seed)
        return self

    # ------------------------------------------------------------------
    # Selection
    # ------------------------------------------------------------------
    def _holdout_split(self, frac: float, rng: np.random.Generator):
        """Host-side train/holdout split of the original data_dict.

        Drops ``frac`` of each NON-fixed view's spots (the template view is
        never held out — its coords pass through unchanged, so its points
        carry no alignment signal). Returns (train_data_dict, holdout) where
        holdout = {mod: {"X": (n_h, D), "Y": (n_h, P), "counts": [per-view]}}.
        """
        src = self._init_args["data_dict"]
        train, holdout = {}, {}
        for mod in self.spec.modalities:
            X = _as_numpy(src[mod.name]["spatial_coords"]).astype(np.float32)
            Y = _as_numpy(src[mod.name]["outputs"]).astype(np.float32)
            Xt, Yt, Xh, Yh = [], [], [], []
            counts_t, counts_h = [], []
            for v, (lo, hi) in enumerate(view_slices(mod.n_samples)):
                n_v = hi - lo
                if self.spec.fixed_view_mask[v] or n_v < 4:
                    keep = np.arange(n_v)
                    drop = np.zeros(0, np.int64)
                else:
                    n_h = max(1, int(round(frac * n_v)))
                    perm = rng.permutation(n_v)
                    drop, keep = np.sort(perm[:n_h]), np.sort(perm[n_h:])
                Xt.append(X[lo:hi][keep])
                Yt.append(Y[lo:hi][keep])
                Xh.append(X[lo:hi][drop])
                Yh.append(Y[lo:hi][drop])
                counts_t.append(int(keep.size))
                counts_h.append(int(drop.size))
            train[mod.name] = {
                "spatial_coords": np.concatenate(Xt),
                "outputs": np.concatenate(Yt),
                "n_samples_list": counts_t,
            }
            holdout[mod.name] = {"X": np.concatenate(Xh), "Y": np.concatenate(Yh),
                                 "counts": counts_h}
        return train, holdout

    def _predictive_score(self, sub_model, holdout) -> float:
        """Mean held-out predictive log-likelihood under the trained model.

        Held-out coords are warped through the restart's warp posterior and
        scored against the data GP's analytic moments (deterministic
        ``predict``); predictive variance adds the learned noise scale
        (reference quirk: exp(noise_variance)+offset IS the scale)."""
        spec = sub_model.spec
        vi, X_h = {}, {}
        for mod in spec.modalities:
            cs = np.insert(np.cumsum(holdout[mod.name]["counts"]), 0, 0)
            vi[mod.name] = [np.arange(cs[v], cs[v + 1]) for v in range(spec.n_views)]
            X_h[mod.name] = holdout[mod.name]["X"]
        _, F_mean, F_var = sub_model.predict(X_h, vi)
        hp = merge_hyperparams(sub_model.params, sub_model.consts)
        noise_pos = np.exp(_as_numpy(hp["noise_variance"])) + spec.diagonal_offset
        total, n = 0.0, 0
        for mm, mod in enumerate(spec.modalities):
            scale = noise_pos[-spec.n_modalities + mm]
            mu = np.asarray(F_mean[mod.name])
            var = np.asarray(F_var[mod.name]) + scale**2
            y = holdout[mod.name]["Y"]
            lp = -0.5 * (y - mu) ** 2 / var - 0.5 * np.log(2.0 * np.pi * var)
            total += float(lp.sum())
            n += lp.size
        return total / max(n, 1)

    def _alignment_consistency(self, G_means: dict, k: int = 5, max_points: int = 5000) -> float:
        """Cross-view expression disagreement in aligned coordinates.

        For every ordered view pair (a, b) within each modality, predict
        view a's expression at each of its aligned coordinates by inverse-
        distance-weighted k-NN interpolation of view b's expression (k-d
        tree over view b's aligned coords), and average the squared error.
        A misaligned restart places disagreeing spots next to each other, so
        this tracks the true aligned-view error without ground truth.

        Views larger than ``max_points`` spots are subsampled (both the
        queried view and the k-d-tree view) with a FIXED seed so every
        restart is scored on the identical spot subset; host kNN over full
        100k+-spot views would otherwise dominate the wall-clock.
        """
        from scipy.spatial import cKDTree

        src = self._init_args["data_dict"]
        sub_rng = np.random.default_rng(0)  # fixed: identical across restarts
        errs = []
        for mod in self.spec.modalities:
            Ga = np.asarray(G_means[mod.name], np.float64)
            Y = _as_numpy(src[mod.name]["outputs"]).astype(np.float64)
            idx = [np.arange(lo, hi) for lo, hi in view_slices(mod.n_samples)]
            idx = [
                i if i.size <= max_points else np.sort(sub_rng.choice(i, max_points, replace=False))
                for i in idx
            ]
            for a in range(len(idx)):
                for b in range(len(idx)):
                    if a == b or idx[a].size == 0 or idx[b].size < 2:
                        continue
                    kk = min(k, idx[b].size)
                    tree = cKDTree(Ga[idx[b]])
                    d, j = tree.query(Ga[idx[a]], k=kk)
                    d = d.reshape(idx[a].size, kk)
                    j = j.reshape(idx[a].size, kk)
                    w = 1.0 / np.maximum(d, 1e-9)
                    w /= w.sum(axis=1, keepdims=True)
                    yhat = (Y[idx[b]][j] * w[..., None]).sum(axis=1)
                    errs.append(float(np.mean((Y[idx[a]] - yhat) ** 2)))
        return float(np.mean(errs)) if errs else np.inf

    # ------------------------------------------------------------------
    # Init families
    # ------------------------------------------------------------------
    def _warp_init_transforms(self, method: str):
        """Per-view affine seeds ``[(A_T, b) or None per view]`` mapping each
        view's coordinates toward the anchor view's frame, for init-diverse
        multistart (``fit_multistart(init=...)``).

        ``method="prealign"`` uses expression-moment matching
        (:func:`..utils.prealign.moment_align`); ``method="ot"`` runs the
        entropic-OT + weighted-Procrustes coarse alignment
        (:func:`..utils.ot.entropic_ot_align_views`, the PASTE recipe) and
        recovers each view's rigid map by least squares. Anchor = first
        fixed view, else view 0. Transforms come from the FIRST modality
        (the warp is shared across modalities). Host-side, computed once
        per multistart.
        """
        src = self._init_args["data_dict"]
        mod = self.spec.modalities[0]
        X = _as_numpy(src[mod.name]["spatial_coords"]).astype(np.float64)
        Y = _as_numpy(src[mod.name]["outputs"]).astype(np.float64)
        slices = list(view_slices(mod.n_samples))
        anchor = next((v for v, f in enumerate(self.spec.fixed_view_mask) if f), 0)
        D = X.shape[1]
        transforms: list = [None] * self.n_views
        if method == "prealign":
            from ..utils.prealign import moment_align

            Xa, Ya = X[slice(*slices[anchor])], Y[slice(*slices[anchor])]
            for v, (lo, hi) in enumerate(slices):
                if v == anchor:
                    continue
                transforms[v] = moment_align(X[lo:hi], Y[lo:hi], Xa, Ya)
            return transforms
        if method == "ot":
            from ..utils.ot import entropic_ot_align_views

            idx = [np.arange(lo, hi) for lo, hi in slices]
            # entropic_ot_align_views anchors on view 0; reorder so the
            # template view is the anchor when one is set.
            order = [anchor] + [v for v in range(len(idx)) if v != anchor]
            aligned = entropic_ot_align_views(X, Y, [idx[v] for v in order])
            for v, (lo, hi) in enumerate(slices):
                if v == anchor or hi - lo < D + 1:
                    continue
                H = np.concatenate([X[lo:hi], np.ones((hi - lo, 1))], axis=1)
                sol, *_ = np.linalg.lstsq(H, aligned[lo:hi], rcond=None)
                transforms[v] = (sol[:D], sol[D])
            return transforms
        raise ValueError(f"unknown warp init method {method!r}")

    @staticmethod
    def _apply_warp_seed(params: dict, transforms) -> dict:
        """Seed the warp posterior mean with per-view affine maps: the
        posterior warp value at the inducing points becomes the affinely
        pre-aligned position, ``delta_G[v] = Xtilde[v] @ A_T + b``, instead
        of the identity. Returns a new dict; ``params`` is left untouched."""
        Xt = _as_numpy(params["Xtilde"])
        old = params["delta_G"]
        delta = np.array(_as_numpy(old))
        for v, t in enumerate(transforms):
            if t is None:
                continue
            A_T, b = t
            delta[v] = (Xt[v] @ np.asarray(A_T) + np.asarray(b)).astype(delta.dtype)
        return {**params, "delta_G": torch.as_tensor(delta, device=old.device)}

    # ------------------------------------------------------------------
    # Vectorized restarts
    # ------------------------------------------------------------------
    def _elementwise_factory(self, optimizer) -> bool:
        """Whether ``optimizer`` (a factory, None for the default Adam)
        builds one of :data:`.train.ZERO_STATE_OPTIMIZERS`, which update
        each element from its own gradient and state: the R-wide step needs
        that to train R independent restarts."""
        if optimizer is None:
            return True
        try:
            check_zero_state(optimizer([torch.zeros(1, device=self.device, requires_grad=True)]))
        except ValueError:
            return False
        return True

    def _restart_step_loss(self, S: int, minibatch_size: Optional[int], R: int, params_R: dict):
        """temp -> the (R,) losses of one step of R restarts on the stacked
        parameters ``params_R``: one draw of all R restarts' noise (and
        indices), then the per-restart loss ``vmap``-ed over the restart
        axis. Holds no reference to the model (see ``_step_loss``)."""
        spec, consts, batch, dev = self.spec, self.consts, self._batch, self.device
        sub_spec = weights = None
        if minibatch_size is not None:
            sub_spec = core.minibatch_spec(spec, minibatch_size)
            weights = core.importance_weights(spec, sub_spec, batch)
        gen, draw = self._gen, self._draw_restart_noise
        if draw is None:
            draw = lambda R_, S_: core.draw_restart_noise(spec, R_, S_, gen, dev, sub_spec)

        def one(params, temp, wn, dn, idx):
            if sub_spec is None:
                return core.negative_elbo(spec, params, consts, batch, S, temp,
                                          warp_noise=wn, data_noise=dn)
            return core.negative_elbo_minibatch(
                spec, sub_spec, params, consts, batch, S, temp, indices=idx,
                warp_noise=wn, data_noise=dn, weights=weights,
            )

        def loss(temp):
            wn, dn, idx = draw(R, S)
            dims = (0, None, 0, None if dn is None else 0, None if idx is None else 0)
            return torch.func.vmap(one, in_dims=dims)(params_R, temp, wn, dn, idx)

        return loss

    def _restart_loop(self, R, lr, S, optimizer, minibatch_size, values) -> TrainLoop:
        """The R-wide :class:`.train.TrainLoop` with ``values`` (R-stacked
        initial parameters) written into its parameter tensors. Memoized as
        ``_cached_train_loop`` memoizes fit()'s loop, so waves of one width
        replay one captured graph: the same (R, lr, S, minibatch_size), Gram
        switch, optimizer factory, spec, generator, noise hook, consts and
        batch tensors."""
        key = (R, lr, S, minibatch_size, gram_force())
        held = (self.spec, self._gen, self._draw_restart_noise, *leaves(self.consts),
                *leaves(self._batch))
        cache = self.__dict__.get("_vec_loop_cache")
        if (
            cache is not None
            and cache["key"] == key
            and same_factory(cache["optimizer"], optimizer)
            and len(cache["held"]) == len(held)
            and all(a is b for a, b in zip(cache["held"], held))
        ):
            copy_into(cache["params"], values)
            return cache["loop"]
        self.__dict__.pop("_vec_loop_cache", None)  # free the old graph first
        params_R = tree_map(lambda v: v.detach().clone().requires_grad_(True), values)
        loop = TrainLoop(named_leaves(params_R),
                         self._restart_step_loss(S, minibatch_size, R, params_R),
                         self._optimizer(optimizer, lr, leaves(params_R)),
                         self._gen, scheduled=hasattr(optimizer, "lr_schedule"), width=R)
        self._vec_loop_cache = {"key": key, "optimizer": optimizer, "held": held,
                                "params": params_R, "loop": loop}
        return loop

    def _restart_inits(self, n_restarts: int, seed0: int, init_transforms=None) -> dict:
        """The initial parameters of restarts ``seed0`` .. ``seed0 +
        n_restarts - 1``, stacked along a leading restart axis: each drawn
        as ``reinitialize`` draws it, then seeded by its entry of
        ``init_transforms`` (None: a fresh random init)."""
        a = self._init_args
        if a is None:
            raise RuntimeError(
                "vectorized multistart needs the original data_dict "
                "(unavailable on checkpoint-loaded models)"
            )
        stacked = []
        for r in range(n_restarts):
            p, consts, _ = init_params(
                self.spec, a["data_dict"], data_init=a["data_init"], grid_init=a["grid_init"],
                seed=seed0 + r, fixed_warp_kernel_variances=a["fixed_warp_kernel_variances"],
                fixed_warp_kernel_lengthscales=a["fixed_warp_kernel_lengthscales"],
                fixed_data_kernel_lengthscales=a["fixed_data_kernel_lengthscales"],
                device=self.device,
            )
            if r == 0 and not tree_equal(consts, self.consts):
                raise RuntimeError(
                    "constants changed across reinitialization — vectorized "
                    "multistart assumes seed-independent consts"
                )
            if init_transforms is not None and r < len(init_transforms) \
                    and init_transforms[r] is not None:
                p = self._apply_warp_seed(p, init_transforms[r])
            stacked.append(p)
        return tree_map(lambda *xs: torch.stack(xs), *stacked)

    def _fit_restarts_vectorized(
        self,
        n_epochs: int,
        n_restarts: int,
        seed0: int,
        lr: float = DEFAULT_LR,
        S: int = 5,
        optimizer=None,
        warp_temperature_schedule=None,
        minibatch_size: Optional[int] = None,
        chunk_size: int = 200,
        init_transforms=None,
    ):
        """Train ``n_restarts`` independent initializations (seeds ``seed0``
        on) SIMULTANEOUSLY: one step of all of them is one replay of the
        R-wide captured step (see the module doc). The optimizer state
        starts fresh and the generator is reseeded with ``seed0``.

        Returns (stacked params {leaf: (R, ...)}, losses (R, T)); the
        stacked tensors are the loop's own, which the next wave overwrites.

        ``init_transforms``: optional per-restart list, each entry None (a
        fresh random init) or a per-view affine-seed list from
        ``_warp_init_transforms`` (applied via ``_apply_warp_seed``).
        """
        values = self._restart_inits(n_restarts, seed0, init_transforms)
        loop = self._restart_loop(n_restarts, lr, S, optimizer, minibatch_size, values)
        loop.reset_state()
        self._gen.manual_seed(int(seed0))
        lr_schedule = getattr(optimizer, "lr_schedule", None)
        losses = np.zeros((n_epochs, n_restarts), np.float64)
        t = 0
        while t < n_epochs:
            n = min(chunk_size, n_epochs - t)
            steps = np.arange(t, t + n)
            if warp_temperature_schedule is not None:
                temps = np.asarray(warp_temperature_schedule(steps), np.float32)
            else:
                temps = np.ones(n, np.float32)
            losses[t : t + n] = loop.run(temps, lr_schedule(steps) if lr_schedule else None)
            t += n
        return self._vec_loop_cache["params"], losses.T

    # ------------------------------------------------------------------
    # fit_multistart
    # ------------------------------------------------------------------
    def fit_multistart(
        self,
        n_epochs: int,
        n_restarts: int = 5,
        seed0: int = 0,
        tail: int = 200,
        verbose: bool = True,
        select: str = "auto",
        holdout_frac: float = 0.1,
        ensemble_top_k: int = 1,
        vectorized="auto",
        adaptive_waves: Optional[int] = None,
        adaptive_rtol: float = 0.05,
        init: str = "random",
        wave_size: Optional[int] = None,
        **fit_kwargs,
    ) -> np.ndarray:
        """Train from ``n_restarts`` independent initializations (seeds
        ``seed0`` on) and keep the best restart.

        SVI alignment has initialization-dependent local optima: across
        restarts the converged aligned-view error can span 10x+.

        ``select`` chooses the winner:
          * ``"auto"`` (default) — ``"consistency"`` when the original
            data_dict is available, else ``"loss"``.
          * ``"consistency"`` — every restart trains on the full data, then
            is scored by cross-view k-NN expression disagreement in its
            aligned coordinates (``_alignment_consistency``); lowest wins.
          * ``"loss"`` — lowest mean training loss over the final ``tail``
            epochs.
          * ``"predictive"`` — each restart trains (sequentially) on a split
            with ``holdout_frac`` of every non-template view's spots
            dropped, is scored by held-out predictive log-likelihood through
            ``predict()``, and the winning seed is retrained on the full
            data.

        ``ensemble_top_k`` (consistency selection only): when > 1, also
        average the aligned coordinates (G_means) of the ``k`` best-scoring
        restarts into ``self.ensemble_G_means_``; the model keeps the single
        winner's parameters.

        ``adaptive_waves`` (consistency selection + vectorized path only):
        train in waves of this size and stop as soon as a new wave fails to
        improve the best consistency score by more than ``adaptive_rtol``
        (relative); ``n_restarts`` is the cap and at least two waves run.

        ``vectorized`` ("auto" default): train the restarts of a wave as one
        R-wide captured step (``_fit_restarts_vectorized``). "auto" takes it
        when the model has its data, the fit options are among ``lr``,
        ``S``, ``optimizer``, ``warp_temperature_schedule`` and
        ``minibatch_size``, the selection is consistency or loss, and the
        optimizer factory builds an elementwise optimizer (one of
        ``train.ZERO_STATE_OPTIMIZERS``); ``False`` runs sequential
        ``fit()`` calls after ``reinitialize``; ``True`` raises where the
        vectorized path cannot run.

        ``init``: ``"random"`` (every restart a fresh random draw),
        ``"prealign"`` / ``"ot"`` (every restart's warp posterior mean seeded
        with the expression-moment or entropic-OT coarse alignment), or
        ``"mixed"`` (restarts cycle through random, prealign and ot).

        ``wave_size`` (vectorized path, non-adaptive): train in fixed waves
        of this width, all of which run; a final partial wave trains
        surplus restarts and discards them, so one captured width serves
        every wave.

        ``multistart_winner_`` records the winning restart, its init family
        and its score. The optimizer and generator state of the last fit
        are cleared: they belong to another trajectory than the winner's,
        so ``save()`` writes no training state and exact resume refuses.

        RNG streams differ from the JAX package's (a ``torch.Generator``,
        not ``jax.random``), so restarts are equal in distribution, not
        draw for draw. Accepts every ``fit`` option. Returns the winning
        run's loss trace and leaves the model holding the winning
        parameters.
        """
        opt, temps = resolve_recipe(
            fit_kwargs.pop("recipe", None), fit_kwargs.get("lr", DEFAULT_LR), n_epochs,
            fit_kwargs.get("optimizer"), fit_kwargs.get("warp_temperature_schedule"),
        )
        fit_kwargs["optimizer"] = opt
        fit_kwargs["warp_temperature_schedule"] = temps

        if select == "auto":
            select = "consistency" if self._init_args is not None else "loss"
        self.ensemble_G_means_ = None
        self.multistart_winner_ = None

        if init not in ("random", "prealign", "ot", "mixed"):
            raise ValueError(f"unknown init {init!r}")
        init_transforms = None
        if init != "random":
            if self._init_args is None:
                raise RuntimeError(
                    f"init={init!r} needs the original data_dict "
                    "(unavailable on checkpoint-loaded models)"
                )
            if self.spec.whitened_variational:
                raise ValueError(
                    "affine-seeded inits write the warp posterior mean "
                    "directly and are not defined under whitened_variational"
                )
            seeds = {}
            if init in ("prealign", "mixed"):
                seeds["prealign"] = self._warp_init_transforms("prealign")
            if init in ("ot", "mixed"):
                seeds["ot"] = self._warp_init_transforms("ot")
            if init == "mixed":
                cycle = [None, seeds["prealign"], seeds["ot"]]
                fam_cycle = ["random", "prealign", "ot"]
            else:
                cycle, fam_cycle = [seeds[init]], [init]
            init_transforms = [cycle[r % len(cycle)] for r in range(n_restarts)]
            init_families = [fam_cycle[r % len(fam_cycle)] for r in range(n_restarts)]
        else:
            init_families = ["random"] * n_restarts

        if vectorized not in (True, False, "auto"):
            raise ValueError(f"vectorized must be True/False/'auto', got {vectorized!r}")
        can_vec = (
            self._init_args is not None
            and set(fit_kwargs) <= _VEC_KEYS
            and select in ("consistency", "loss")
            and self._elementwise_factory(fit_kwargs["optimizer"])
        )
        use_vec = vectorized is True or (vectorized == "auto" and can_vec)
        if vectorized is True and not can_vec:
            raise RuntimeError(
                "vectorized=True not supported here ("
                "checkpoint-loaded model, predictive selection, an optimizer "
                "that is not elementwise, or "
                f"unsupported fit options {set(fit_kwargs) - _VEC_KEYS})"
            )
        if wave_size is not None:
            if wave_size < 1:
                raise ValueError("wave_size must be >= 1")
            if adaptive_waves is not None:
                raise ValueError(
                    "wave_size and adaptive_waves are mutually exclusive: "
                    "adaptive_waves already trains in waves (of its own "
                    "size) and adds the stopping rule"
                )
            if not use_vec:
                raise RuntimeError(
                    "wave_size chunks the vectorized restart path, which "
                    "is unavailable here (checkpoint-loaded model, an optimizer "
                    "that is not elementwise or unsupported fit options)"
                )
        if adaptive_waves is not None:
            if adaptive_waves < 1:
                raise ValueError("adaptive_waves must be >= 1")
            if select != "consistency":
                raise ValueError(
                    f"adaptive_waves requires consistency selection (got select={select!r})"
                )
            if not use_vec:
                raise RuntimeError(
                    "adaptive_waves needs the vectorized restart path "
                    "(checkpoint-loaded models, optimizers that are not "
                    "elementwise and unsupported fit options fall back to "
                    "sequential training)"
                )

        def wave(done, w, transforms):
            """Train restarts done .. done + w - 1 as one vectorized wave:
            [(r, params_r, losses_r)], each restart's parameters copied out
            of the loop's tensors (the next wave overwrites them)."""
            params_R, losses_RT = self._fit_restarts_vectorized(
                n_epochs, w, seed0 + done, lr=fit_kwargs.get("lr", DEFAULT_LR),
                S=fit_kwargs.get("S", 5), optimizer=fit_kwargs["optimizer"],
                warp_temperature_schedule=fit_kwargs["warp_temperature_schedule"],
                minibatch_size=fit_kwargs.get("minibatch_size"), init_transforms=transforms,
            )
            return [(done + r, tree_map(lambda x, r=r: x[r].detach().clone(), params_R),
                     losses_RT[r]) for r in range(w)]

        def trained_restarts():
            """Yield (r, params_r, losses_r) for every restart."""
            if use_vec:
                # One n_restarts-wide wave, or fixed waves of wave_size
                # (a final partial wave trains surplus restarts, discarded).
                w = n_restarts if wave_size is None else min(wave_size, n_restarts)
                done = 0
                while done < n_restarts:
                    tr = None
                    if init_transforms is not None:
                        tr = init_transforms[done : done + w]
                        tr = tr + [None] * (w - len(tr))
                    yield from wave(done, w, tr)[: n_restarts - done]
                    done += w
            else:
                for r in range(n_restarts):
                    self.reinitialize(seed0 + r)
                    if init_transforms is not None and init_transforms[r] is not None:
                        copy_into(self.params,
                                   self._apply_warp_seed(self.params, init_transforms[r]))
                    losses = self.fit(n_epochs=n_epochs, **fit_kwargs)
                    yield r, _snapshot(self.params), losses

        def keep(params_r):
            """The model holds ``params_r``; the last fit's optimizer and
            generator state belong to another restart's trajectory."""
            copy_into(self.params, params_r)
            self._opt_state = self._rng_state = None

        if select == "consistency":
            if self._init_args is None:
                raise RuntimeError(
                    "select='consistency' needs the original data_dict "
                    "(unavailable on checkpoint-loaded models); use select='loss'"
                )
            src = self._init_args["data_dict"]
            X_by_mod = {
                mod.name: _as_numpy(src[mod.name]["spatial_coords"]).astype(np.float32)
                for mod in self.spec.modalities
            }
            vi, Ns, _, _ = self.create_view_idx_dict(src)
            runs = []

            def score_run(r, params_r, losses):
                copy_into(self.params, params_r)
                G_means, _, _, _ = self.forward(X_by_mod, vi, Ns)
                G_np = {k: np.asarray(v) for k, v in G_means.items()}
                score = self._alignment_consistency(G_np)
                if verbose:
                    print(
                        f"restart {r}: consistency {score:.6f} "
                        f"(tail loss {np.mean(losses[-min(tail, len(losses)):]):.2f})",
                        flush=True,
                    )
                if np.isfinite(score):
                    runs.append((score, r, params_r, losses, G_np))

            if adaptive_waves is not None:
                done, best_prev = 0, np.inf
                while done < n_restarts:
                    w = min(adaptive_waves, n_restarts - done)
                    tr = None if init_transforms is None else init_transforms[done : done + w]
                    for run in wave(done, w, tr):
                        score_run(*run)
                    done += w
                    best_now = min((t[0] for t in runs), default=np.inf)
                    if done >= n_restarts:
                        break
                    if np.isfinite(best_prev) and best_now >= best_prev * (1.0 - adaptive_rtol):
                        if verbose:
                            print(f"consistency stabilized after {done} restarts "
                                  f"(best {best_now:.6f})", flush=True)
                        break
                    best_prev = best_now
            else:
                for run in trained_restarts():
                    score_run(*run)
            if not runs:
                raise RuntimeError(
                    "fit_multistart: no restart produced a finite consistency score"
                )
            runs.sort(key=lambda t: t[0])
            _, best_r, best_params, best_losses, _ = runs[0]
            self.multistart_winner_ = {
                "restart": int(best_r),
                "init_family": init_families[best_r],
                "consistency": float(runs[0][0]),
            }
            if verbose:
                print(f"winner: restart {best_r} (init={init_families[best_r]})", flush=True)
            keep(best_params)
            if ensemble_top_k > 1:
                top = runs[: min(ensemble_top_k, len(runs))]
                self.ensemble_G_means_ = {
                    mod.name: np.mean([g[mod.name] for *_, g in top], axis=0)
                    for mod in self.spec.modalities
                }
            return best_losses

        if select == "predictive":
            if self._init_args is None or self._ctor_kwargs is None:
                raise RuntimeError(
                    "select='predictive' needs the original data_dict "
                    "(unavailable on checkpoint-loaded models)"
                )
            rng = np.random.default_rng(seed0)
            train_dd, holdout = self._holdout_split(holdout_frac, rng)
            sub = type(self)(train_dd, **self._ctor_kwargs)
            best_seed, best_score = None, -np.inf
            for r in range(n_restarts):
                seed = seed0 + r
                sub.reinitialize(seed)
                sub.fit(n_epochs=n_epochs, **fit_kwargs)
                score = self._predictive_score(sub, holdout)
                if verbose:
                    print(f"restart {r}: held-out predictive ll {score:.4f}", flush=True)
                if np.isfinite(score) and score > best_score:
                    best_seed, best_score = seed, score
            if best_seed is None:
                raise RuntimeError(
                    "fit_multistart: no restart produced a finite held-out predictive likelihood"
                )
            if verbose:
                print(f"winner: seed {best_seed}; retraining on full data", flush=True)
            self.reinitialize(best_seed)
            return self.fit(n_epochs=n_epochs, **fit_kwargs)
        if select != "loss":
            raise ValueError(f"unknown select {select!r}")

        best = None
        for r, params_r, losses in trained_restarts():
            score = float(np.mean(losses[-min(tail, len(losses)):]))
            if verbose:
                print(f"restart {r}: tail-mean loss {score:.2f}", flush=True)
            if not np.isfinite(score):
                continue  # a diverged (NaN/inf) restart can never win
            if best is None or score < best[0]:
                best = (score, params_r, losses, r)
        if best is None:
            raise RuntimeError("fit_multistart: no restart produced a finite tail-mean loss")
        self.multistart_winner_ = {
            "restart": int(best[3]),
            "init_family": init_families[best[3]],
            "tail_loss": float(best[0]),
        }
        keep(best[1])
        return best[2]
