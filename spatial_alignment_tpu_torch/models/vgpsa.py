"""``VariationalGPSA`` in PyTorch: the user-facing model.

Counterpart of ``spatial_alignment_tpu/models/vgpsa.py``: construction
(spec + seeded init), ``fit`` (full-batch or minibatch SVI, any optimizer
factory, ``recipe="accurate"``, exact resume), ``make_train_step`` /
``make_train_loop``, ``save`` / ``load`` / ``attach_data``, ``forward``,
``predict``, ``loss_fn`` and ``neg_elbo``; ``reinitialize`` and
``fit_multistart`` come from :class:`.multistart.MultistartMixin`. On CUDA
``fit`` runs each step as one replay of a captured CUDA graph
(:mod:`.train`); on the CPU the same steps run eagerly.

Divergences from the JAX package: optimizer factories ``params ->
torch.optim.Optimizer`` instead of optax transformations (the default is
``torch.optim.Adam``, capturable on CUDA; ``recipe="accurate"`` is
:class:`.train.CosineDecayAdam`, the same schedule as
``optax.cosine_decay_schedule(lr, n, alpha=1e-2)``), a ``torch.Generator``
instead of ``jax.random`` (different sample streams for the same seed), and
a numpy k-means instead of sklearn's. Checkpoints share the JAX package's
format and its ``params`` / ``consts`` / ``data`` sections
(:mod:`..utils.checkpoint`).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed

from .._device import resolve_device
from ..ops.gram import gram_force
from ..ops.kernels import kernel_name
from ..utils import profiling
from ..utils.checkpoint import load_checkpoint_blob, nest, save_checkpoint, unflatten_into
from . import core
from .convert import tensors_from_numpy
from ._trees import copy_into, leaves, named_leaves, tree_map
from .multistart import MultistartMixin
from .params import init_params, merge_hyperparams
from .spec import (
    ModelSpec,
    _as_numpy,
    build_spec,
    create_view_idx_dict,
    pack_batch,
    pack_coords,
    spec_from_dict,
    unpack_points,
    view_mask,
)
from .train import DEFAULT_LR, TrainLoop, resolve_recipe, same_factory


class _hybridmethod:
    """Descriptor: the method gets the instance when called on one, the class
    when called on the class (``VariationalGPSA.load(path)`` builds a model,
    ``model.load(path)`` restores into one)."""

    def __init__(self, fn):
        self.fn = fn
        self.__doc__ = fn.__doc__

    def __get__(self, obj, objtype=None):
        return partial(self.fn, obj if obj is not None else objtype)


class VariationalGPSA(MultistartMixin):
    """Deep-GP spatial alignment model (PyTorch port of the JAX model).

    ``device=None`` means ``"cuda"``; without a CUDA device that raises,
    and the caller passes ``device="cpu"`` to run the plain kernels.

    After :func:`..parallel.distribute` the model holds this rank's blocks
    of the params and the batch (``_mesh`` is the mesh): ``fit`` and
    ``make_train_step`` run the explicit-collective step of
    :mod:`..parallel.shardmap`, ``forward``, ``predict`` and ``neg_elbo``
    give full-size results on every rank, ``save`` writes the full state
    from rank 0, and ``fit_multistart`` spreads its restarts over the ranks.
    """

    # Set by parallel.distribute: the mesh, its groups, and the full packed
    # batch (restarts train on it, checkpoints carry it).
    _mesh = None
    _comms = None
    _global_batch = None

    @profiling.spanned("gpsa.model.init")
    def __init__(
        self,
        data_dict: Dict[str, dict],
        m_X_per_view: int,
        m_G: int,
        data_init: bool = True,
        minmax_init: bool = False,  # accepted-but-dead in the reference
        grid_init: bool = False,
        n_spatial_dims: int = 2,  # derived from the data
        n_noise_variance_params: int = 2,
        kernel_func_warp="rbf",
        kernel_func_data="rbf",
        n_latent_gps: Optional[Dict[str, Optional[int]]] = None,
        mean_function: str = "identity_fixed",
        mean_penalty_param: float = 0.0,
        fixed_warp_kernel_variances=None,
        fixed_warp_kernel_lengthscales=None,
        fixed_data_kernel_lengthscales=None,
        fixed_view_idx=None,
        *,
        seed: int = 0,
        reference_sample_scale: bool = False,
        diagonal_offset: float = 1e-5,
        pad_multiple: int = 1,
        data_chunk_size: Optional[int] = None,
        analytic_data_likelihood: bool = False,
        svgp_matmul_precision: str = "auto",
        svgp_variance_precision: str = "auto",
        svgp_solve_mode: str = "auto",
        triangular_variational: bool = False,
        whitened_variational: bool = False,
        cholesky_impl: str = "auto",
        quad_diag_impl: str = "auto",
        fused_factor_inverse: str = "auto",
        device=None,
    ):
        del n_spatial_dims, minmax_init
        self.device = resolve_device(device)
        spec = build_spec(
            data_dict,
            m_X_per_view=m_X_per_view,
            m_G=m_G,
            n_latent_gps=n_latent_gps,
            kernel_warp=kernel_name(kernel_func_warp),
            kernel_data=kernel_name(kernel_func_data),
            mean_function=mean_function,
            n_noise_variance_params=n_noise_variance_params,
            fixed_view_idx=fixed_view_idx,
            fixed_warp_kernel_variances=fixed_warp_kernel_variances,
            fixed_warp_kernel_lengthscales=fixed_warp_kernel_lengthscales,
            fixed_data_kernel_lengthscales=fixed_data_kernel_lengthscales,
            diagonal_offset=diagonal_offset,
            reference_sample_scale=reference_sample_scale,
            mean_penalty_param=mean_penalty_param,
            pad_multiple=pad_multiple,
            data_chunk_size=data_chunk_size,
            analytic_data_likelihood=analytic_data_likelihood,
            svgp_matmul_precision=svgp_matmul_precision,
            svgp_variance_precision=svgp_variance_precision,
            svgp_solve_mode=svgp_solve_mode,
            triangular_variational=triangular_variational,
            whitened_variational=whitened_variational,
            cholesky_impl=cholesky_impl,
            quad_diag_impl=quad_diag_impl,
            fused_factor_inverse=fused_factor_inverse,
        )
        params, consts, self.spec = init_params(
            spec,
            data_dict,
            data_init=data_init,
            grid_init=grid_init,
            seed=seed,
            fixed_warp_kernel_variances=fixed_warp_kernel_variances,
            fixed_warp_kernel_lengthscales=fixed_warp_kernel_lengthscales,
            fixed_data_kernel_lengthscales=fixed_data_kernel_lengthscales,
            device=self.device,
        )
        self._set_state(params, consts, pack_batch(self.spec, data_dict, self.device), seed)
        # For reinitialize() and fit_multistart: the data and the init options
        # (host-side re-init), and the constructor's arguments less the data
        # (a structurally identical model on a train/holdout split).
        self._init_args = dict(
            data_dict=data_dict, data_init=data_init, grid_init=grid_init,
            fixed_warp_kernel_variances=fixed_warp_kernel_variances,
            fixed_warp_kernel_lengthscales=fixed_warp_kernel_lengthscales,
            fixed_data_kernel_lengthscales=fixed_data_kernel_lengthscales,
        )
        self._ctor_kwargs = dict(
            m_X_per_view=m_X_per_view, m_G=m_G, data_init=data_init, grid_init=grid_init,
            n_noise_variance_params=n_noise_variance_params,
            kernel_func_warp=kernel_func_warp, kernel_func_data=kernel_func_data,
            n_latent_gps=n_latent_gps, mean_function=mean_function,
            mean_penalty_param=mean_penalty_param,
            fixed_warp_kernel_variances=fixed_warp_kernel_variances,
            fixed_warp_kernel_lengthscales=fixed_warp_kernel_lengthscales,
            fixed_data_kernel_lengthscales=fixed_data_kernel_lengthscales,
            fixed_view_idx=fixed_view_idx, seed=seed,
            reference_sample_scale=reference_sample_scale, diagonal_offset=diagonal_offset,
            pad_multiple=pad_multiple, data_chunk_size=data_chunk_size,
            analytic_data_likelihood=analytic_data_likelihood,
            svgp_matmul_precision=svgp_matmul_precision,
            svgp_variance_precision=svgp_variance_precision,
            svgp_solve_mode=svgp_solve_mode, triangular_variational=triangular_variational,
            whitened_variational=whitened_variational, cholesky_impl=cholesky_impl,
            quad_diag_impl=quad_diag_impl, fused_factor_inverse=fused_factor_inverse,
            device=self.device,
        )
        self.fixed_view_idx = fixed_view_idx
        self.n_latent_gps = (
            n_latent_gps if n_latent_gps is not None else {m: None for m in self.spec.modality_names}
        )

    def _set_state(self, params, consts, batch, seed: int):
        """Install params/consts/batch and the bookkeeping derived from the spec."""
        self.params = tree_map(lambda t: t.detach().requires_grad_(True), params)
        self.consts = consts
        self._batch = batch
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._seed = int(seed)
        self._last_aux = None
        # The last fit's epoch, optimizer state and generator state, for save().
        self._epoch = 0
        self._opt_state = self._rng_state = None
        vi, Ns, Ps, n_total = create_view_idx_dict(self.spec)
        self.view_idx, self.Ns, self.Ps, self.n_total = vi, Ns, Ps, n_total

    # ------------------------------------------------------------------
    # Reference surface
    # ------------------------------------------------------------------
    @property
    def n_views(self) -> int:
        return self.spec.n_views

    @property
    def n_spatial_dims(self) -> int:
        return self.spec.n_spatial_dims

    @property
    def modality_names(self):
        return list(self.spec.modality_names)

    @property
    def m_X_per_view(self) -> int:
        return self.spec.m_X_per_view

    @property
    def m_G(self) -> int:
        return self.spec.m_G

    @property
    def Xtilde(self) -> np.ndarray:
        return _as_numpy(self.params["Xtilde"])

    @property
    def Gtilde(self) -> np.ndarray:
        return _as_numpy(self.params["Gtilde"])

    def parameters(self):
        return leaves(self.params)

    def train(self):  # torch-API shims: the model has no modes
        return self

    def eval(self):
        return self

    def to(self, device=None):
        """Returns the model. The device is fixed at construction
        (``device=``): this moves nothing."""
        del device
        return self

    def create_view_idx_dict(self, data_dict):
        """view_idx, Ns, Ps, n_total of an arbitrary data_dict."""
        view_idx, Ns, Ps = {}, {}, {}
        n_total = 0
        for mod in data_dict.keys():
            n_samples_list = data_dict[mod]["n_samples_list"]
            Ns[mod] = int(np.sum(n_samples_list))
            n_total += Ns[mod]
            Ps[mod] = int(_as_numpy(data_dict[mod]["outputs"]).shape[1])
            cs = np.insert(np.cumsum(n_samples_list), 0, 0)
            view_idx[mod] = [np.arange(cs[ii], cs[ii + 1]) for ii in range(self.n_views)]
        return view_idx, Ns, Ps, n_total

    # ------------------------------------------------------------------
    # Forward / loss
    # ------------------------------------------------------------------
    def _eval_spec(self, view_idx) -> ModelSpec:
        """Spec for a (possibly different-sized) coordinate set."""
        counts = {
            mod: tuple(len(view_idx[mod][v]) for v in range(self.n_views))
            for mod in self.spec.modality_names
        }
        if all(counts[m.name] == m.n_samples for m in self.spec.modalities):
            return self.spec
        new_mods = tuple(
            dataclasses.replace(m, n_samples=counts[m.name], n_padded=max(max(counts[m.name]), 1))
            for m in self.spec.modalities
        )
        return self.spec.replace(modalities=new_mods)

    def _coords_batch(self, spec: ModelSpec, X_spatial):
        coords = pack_coords(spec, X_spatial, self.device)
        return {
            mod.name: {
                "coords": coords[mod.name],
                "mask": torch.from_numpy(view_mask(spec, mod)).to(self.device),
                "outputs": torch.zeros(
                    (spec.n_views, mod.n_padded, mod.n_outputs), device=self.device
                ),
            }
            for mod in spec.modalities
        }

    def forward(
        self,
        X_spatial: Dict[str, np.ndarray],
        view_idx=None,
        Ns=None,
        S: int = 1,
        prediction_mode: bool = False,
        G_test=None,
    ):
        """Reference-layout forward pass.

        Returns (G_means, G_samples, F_latent_samples, F_observed_samples) as
        numpy arrays in the concatenated-per-view layout. With ``G_test``
        ({mod: (n_test, D)} or the reference's (1, n_test, D) aligned
        coordinates) it also imputes the outputs there
        (:func:`.core.impute_at`) and appends their S samples,
        {mod: (S, n_test, L)} latent and {mod: (S, n_test, P)} observed.
        """
        del Ns, prediction_mode
        if view_idx is None:
            view_idx = self.view_idx
        spec = self._eval_spec(view_idx)
        hp = merge_hyperparams(self._full_params(), self.consts)
        if G_test is not None:
            G_test = {m: torch.as_tensor(np.asarray(_as_numpy(v), np.float32), device=self.device)
                      for m, v in G_test.items()}
        with torch.no_grad():
            result = core.forward(
                spec, hp, self._coords_batch(spec, X_spatial), S, generator=self._gen,
                G_test=G_test,
            )
        self._last_aux = (hp, result.warp_aux, result.data_aux)
        unpack = lambda d: {m: unpack_points(spec, m, d[m]) for m in spec.modality_names}
        out = (
            unpack(result.G_means),
            unpack(result.G_samples),
            unpack(result.F_latent_samples),
            unpack(result.F_observed_samples),
        )
        if G_test is None:
            return out
        to_np = lambda d: {m: _as_numpy(v) for m, v in d.items()}
        return out + (to_np(result.F_latent_samples_test), to_np(result.F_observed_samples_test))

    def predict(self, X_spatial: Dict[str, np.ndarray], view_idx=None, Ns=None):
        """Deterministic posterior prediction: (G_means, F_mean, F_var) in
        the reference layout, with no sampling."""
        del Ns
        if view_idx is None:
            view_idx = self.view_idx
        spec = self._eval_spec(view_idx)
        hp = merge_hyperparams(self._full_params(), self.consts)
        with torch.no_grad():
            G_means, F_mean, F_var = core.predict_mean(
                spec, hp, self._coords_batch(spec, X_spatial)
            )
        unpack = lambda d: {m: unpack_points(spec, m, d[m]) for m in spec.modality_names}
        return unpack(G_means), unpack(F_mean), unpack(F_var)

    def loss_fn(self, data_dict, F_samples):
        """Negative ELBO given observed samples, using the intermediates of
        the preceding ``forward`` call (the reference's stateful loss)."""
        if self._last_aux is None:
            raise RuntimeError("loss_fn requires a preceding forward() call")
        hp, warp_aux, data_aux = self._last_aux
        with torch.no_grad():
            KL = core.kl_divergence(self.spec, hp, warp_aux, data_aux)
            noise_pos = torch.exp(hp["noise_variance"]) + self.spec.diagonal_offset
            LL = torch.zeros((), device=self.device)
            for mm, mod in enumerate(self.spec.modalities):
                F = torch.as_tensor(np.asarray(F_samples[mod.name], np.float32), device=self.device)
                Y = torch.as_tensor(
                    _as_numpy(data_dict[mod.name]["outputs"]).astype(np.float32), device=self.device
                )
                scale = noise_pos[-self.spec.n_modalities + mm]
                log_prob = (
                    -0.5 * torch.square((Y[None] - F) / scale)
                    - torch.log(scale)
                    - 0.5 * core._LOG_2PI
                )
                LL = LL + log_prob.sum() / F.shape[0]
        return -LL + KL

    def neg_elbo(self, S: int = 5) -> float:
        """One ELBO evaluation on the training batch (on a distributed model
        the global one, on every rank)."""
        with torch.no_grad():
            return float(self._loss_fn(None)(self.params, S, 1.0, None, None))

    # ------------------------------------------------------------------
    # The distributed layout (parallel.distribute)
    # ------------------------------------------------------------------
    def _placements(self):
        from ..parallel.sharding import param_shardings

        return param_shardings(self.spec, self.params, self._mesh)

    def _full_params(self) -> dict:
        """The full parameters: ``self.params``, or on a distributed model
        its blocks gathered over the mesh (the same on every rank)."""
        if self._mesh is None:
            return self.params
        from ..parallel.sharding import gather_block

        with torch.no_grad():
            return tree_map(lambda t, p: gather_block(t.detach(), p, self._mesh, self._comms),
                            self.params, self._placements())

    def _commit_params_to_mesh(self, params: dict):
        """Write full parameters ``params`` into the model's tensors in place:
        on a distributed model each rank's blocks of them (a multistart
        winner, a fresh init, a checkpoint)."""
        if self._mesh is not None:
            from ..parallel.sharding import local_block

            params = tree_map(lambda t, p: local_block(t, p, self._mesh), params,
                              self._placements())
        copy_into(self.params, params)

    def _opt_state_layout(self, flat: dict, gather: bool) -> dict:
        """An optimizer state {"<leaf path>/<name>": tensor} of the rank's
        blocks gathered to full leaves (``gather``), or of full leaves cut to
        the rank's blocks; scalars (a step count) stay as they are."""
        if self._mesh is None:
            return flat
        from ..parallel.sharding import gather_block, local_block

        placed = dict(named_leaves(self._placements()))
        local = dict(named_leaves(self.params))
        out = {}
        for key, value in flat.items():
            path = key.rsplit("/", 1)[0]
            p = placed.get(path)
            if gather and p is not None and tuple(value.shape) == tuple(local[path].shape):
                value = gather_block(value, p, self._mesh, self._comms)
            elif not gather and p is not None and np.ndim(value) == local[path].ndim:
                value = local_block(torch.as_tensor(np.asarray(value)), p, self._mesh).numpy()
            out[key] = value
        return out

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    # None draws each step's noise inside the step from the model's generator;
    # the tests set a function S -> (warp_noise, data_noise) here to inject
    # the JAX package's draws into CPU steps (a captured step calls it once,
    # at capture).
    _draw_noise = None

    def _loss_fn(self, minibatch_size: Optional[int]):
        """(params, S, temp, warp_noise, data_noise) -> scalar loss over the
        training batch; the minibatch variant subsamples ``minibatch_size``
        points per view on the device each call (``core.subsample_batch``)."""
        spec, consts, batch, gen = self.spec, self.consts, self._batch, self._gen
        if self._mesh is not None:
            # The rank's blocks through the explicit-collective step; the
            # minibatch is the stratified per-shard sample (JAX vgpsa.py
            # _loss_fn), so its gather needs no communication.
            from ..parallel.shardmap import Executor

            ex = Executor(spec, self._mesh, consts, minibatch_size)
            return lambda params, S, temp, wn, dn: ex.loss(params, batch, S, temp, gen, wn, dn)
        if minibatch_size is None:
            return lambda params, S, temp, wn, dn: core.negative_elbo(
                spec, params, consts, batch, S, temp, generator=gen, warp_noise=wn, data_noise=dn
            )
        sub_spec = core.minibatch_spec(spec, minibatch_size)
        weights = core.importance_weights(spec, sub_spec, batch)
        return lambda params, S, temp, wn, dn: core.negative_elbo_minibatch(
            spec, sub_spec, params, consts, batch, S, temp, generator=gen,
            warp_noise=wn, data_noise=dn, weights=weights,
        )

    def _step_loss(self, S: int, minibatch_size: Optional[int]):
        """temp -> one step's loss on the current params, its noise drawn
        from the generator or by ``_draw_noise``. It holds no reference to
        the model: a cached loop must not make a cycle with it, or its graph
        could be freed by the garbage collector while another is captured."""
        loss_fn, params, draw = self._loss_fn(minibatch_size), self.params, self._draw_noise
        return lambda temp: loss_fn(params, S, temp, *(draw(S) if draw else (None, None)))

    def _optimizer(self, optimizer, lr: float, params=None) -> torch.optim.Optimizer:
        """``optimizer(params)``, or by default Adam at ``lr`` (capturable on
        CUDA, where fit() captures its step); ``params`` defaults to the
        model's parameters."""
        params = self.parameters() if params is None else params
        if optimizer is None:
            return torch.optim.Adam(params, lr=lr, capturable=self.device.type == "cuda")
        return optimizer(params)

    def make_train_step(
        self,
        lr: float = DEFAULT_LR,
        S: int = 5,
        optimizer=None,
        minibatch_size: Optional[int] = None,
    ):
        """(step, optimizer): ``step(temperature=1.0)`` runs one eager
        training step on the model's parameters (loss, backward, optimizer
        step) and returns the loss as a 0-d device tensor. ``optimizer`` is a
        factory ``params -> torch.optim.Optimizer`` (default Adam at ``lr``,
        capturable on CUDA). A factory with ``lr_schedule(steps)`` has its
        learning rate, a tensor, set to the schedule's value at this step's
        count before each step, as ``fit`` sets it (the JAX package's
        optax schedule advances with the optimizer state's count). From the
        same parameters, optimizer state and generator state, these steps
        give the losses of ``fit``'s captured steps bit for bit: this is
        their eager reference."""
        opt = self._optimizer(optimizer, lr)
        loss_fn = self._step_loss(S, minibatch_size)
        lr_schedule = getattr(optimizer, "lr_schedule", None)
        count = 0

        def step(temperature=1.0) -> torch.Tensor:
            nonlocal count
            if lr_schedule is not None:
                value = np.float32(lr_schedule(count))
                for group in opt.param_groups:
                    if isinstance(group["lr"], torch.Tensor):
                        group["lr"].fill_(float(value))
                    else:
                        group["lr"] = float(value)
                count += 1
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(temperature)
            loss.backward()
            opt.step()
            return loss.detach()

        return step, opt

    @profiling.spanned("gpsa.loop.build")
    def make_train_loop(
        self,
        lr: float = DEFAULT_LR,
        S: int = 5,
        optimizer=None,
        minibatch_size: Optional[int] = None,
    ) -> TrainLoop:
        """The :class:`.train.TrainLoop` of this model: on CUDA its step
        (forward, backward, optimizer step) captured once as a CUDA graph and
        replayed once a step, on the CPU run eagerly. ``loop.run(temps,
        lrs)`` runs ``len(temps)`` steps and returns their losses;
        ``loop.optimizer`` is the optimizer, its state fresh. Runs inside
        the span ``gpsa.loop.build``, the optimizer's construction included
        (a process's first imports ``torch._dynamo``)."""
        # gloo's collectives cannot be captured: a distributed step on it
        # runs eagerly.
        capture = self._mesh is None or torch.distributed.get_backend() == "nccl"
        return TrainLoop(
            named_leaves(self.params),
            self._step_loss(S, minibatch_size),
            self._optimizer(optimizer, lr),
            self._gen,
            scheduled=hasattr(optimizer, "lr_schedule"),
            capture=capture,
        )

    def _cached_train_loop(self, lr, S, optimizer, minibatch_size) -> TrainLoop:
        """make_train_loop, reused across fit() calls while nothing it holds
        changed: the same (lr, S, minibatch_size), Gram switch
        (``set_gram_force``, read at capture), optimizer factory
        (``same_factory``), spec, generator and the same tensors of params,
        consts and batch (a graph holds their addresses; average_last and
        attach_data rebind them and miss)."""
        key = (lr, S, minibatch_size, gram_force())
        held = (self.spec, self._gen, self._draw_noise, *leaves(self.params),
                *leaves(self.consts), *leaves(self._batch))
        cache = self.__dict__.get("_train_loop_cache")
        if (
            cache is not None
            and cache["key"] == key
            and same_factory(cache["optimizer"], optimizer)
            and len(cache["held"]) == len(held)
            and all(a is b for a, b in zip(cache["held"], held))
        ):
            return cache["loop"]
        self.__dict__.pop("_train_loop_cache", None)  # free the old graph first
        loop = self.make_train_loop(lr, S, optimizer, minibatch_size)
        self._train_loop_cache = {"key": key, "optimizer": optimizer, "held": held, "loop": loop}
        return loop

    @profiling.spanned("gpsa.fit", call=True)
    def fit(
        self,
        n_epochs: int,
        lr: float = DEFAULT_LR,
        S: int = 5,
        print_every: Optional[int] = None,
        callback=None,
        convergence_checker=None,
        chunk_size: Optional[int] = None,
        warp_temperature_schedule=None,
        optimizer=None,
        average_last: Optional[int] = None,
        minibatch_size: Optional[int] = None,
        recipe: Optional[str] = None,
        resume_from: Optional[str] = None,
    ) -> np.ndarray:
        """Training loop; returns the per-step loss trace (float64).

        On CUDA each step is one replay of a captured CUDA graph
        (:class:`.train.TrainLoop`); the losses stay on the device and are
        copied to the host once per chunk. On the CPU the same steps run
        eagerly. Each call starts a fresh optimizer state, as the JAX
        package's does.

        ``optimizer`` is a factory ``params -> torch.optim.Optimizer``
        (default: Adam at ``lr``, capturable on CUDA; one that cannot be
        captured raises on CUDA, and so does one whose fresh state the loop
        cannot restore, see :func:`.train.check_resettable`). A factory with
        ``lr_schedule(steps)`` has its learning rate, a tensor, set from it
        before each step.
        ``callback(model, epoch, losses)`` fires every ``print_every``
        epochs; ``convergence_checker(iternum, losses)`` can stop early at
        chunk ends (see :mod:`..utils.convergence`);
        ``warp_temperature_schedule(epoch_array) -> temps`` anneals the warp
        noise; ``average_last=K`` replaces the final parameters with the mean
        of chunk-end snapshots from the last K epochs; ``minibatch_size=B``
        trains each step on an unbiased B-points-per-view subsample
        (stochastic variational inference).
        ``recipe="accurate"`` is Adam under cosine decay to lr/100
        (:class:`.train.CosineDecayAdam`) with the temperature-0 objective,
        unless ``optimizer`` / ``warp_temperature_schedule`` are given.
        ``resume_from=path`` restores the parameters, the optimizer state,
        the generator state and the epoch from a checkpoint ``save()`` wrote
        after a fit, and trains ``n_epochs`` more: bit for bit the
        uninterrupted fit (same optimizer factory; with ``recipe`` the
        horizon is the total, checkpointed epoch + ``n_epochs``).
        Checkpoints without optimizer state (``average_last``,
        ``include_opt=False``) refuse.
        """
        if recipe not in (None, "plain", "accurate"):
            raise ValueError(f"unknown recipe {recipe!r}")
        if self._batch is None:
            raise RuntimeError(
                "this model was loaded from a checkpoint saved with include_data=False: "
                "it can predict but has no training batch; call attach_data(data_dict)"
            )
        epoch0, blob = 0, None
        if resume_from is not None:
            blob = load_checkpoint_blob(resume_from)
            if not blob["torch_opt"] or blob["torch_rng"] is None:
                raise ValueError(
                    f"{resume_from} carries no optimizer state / generator state; it was "
                    "saved before any fit(), after average_last or with include_opt=False "
                    "and cannot resume exactly (start a fresh fit instead)"
                )
            self._assign(blob)
            self._restore_training_state(blob, require_generator=True)
            epoch0 = self._epoch
        optimizer, warp_temperature_schedule = resolve_recipe(
            recipe, lr, epoch0 + n_epochs, optimizer, warp_temperature_schedule
        )
        lr_schedule = getattr(optimizer, "lr_schedule", None)
        loop = self._cached_train_loop(lr, S, optimizer, minibatch_size)
        if blob is not None:
            loop.load_state(self._opt_state_layout(blob["torch_opt"], gather=False))
        else:
            loop.reset_state()

        if chunk_size is None:
            chunk_size = print_every or min(100, max(1, n_epochs))
        if convergence_checker is not None:
            chunk_size = min(chunk_size, 10)
        losses = np.zeros(n_epochs, np.float64)
        avg_start = n_epochs - average_last if average_last else n_epochs
        params_sum, n_snapshots = None, 0
        t = 0
        while t < n_epochs:
            n = min(chunk_size, n_epochs - t)
            if print_every:
                n = min(n, print_every - t % print_every)
            if average_last and t < avg_start:
                n = min(n, avg_start - t)
            steps = np.arange(epoch0 + t, epoch0 + t + n)
            if warp_temperature_schedule is not None:
                temps = np.asarray(warp_temperature_schedule(steps), np.float32)
            else:
                temps = np.ones(n, np.float32)
            lrs = lr_schedule(steps) if lr_schedule is not None else None
            losses[t : t + n] = loop.run(temps, lrs)
            if print_every and t % print_every == 0:
                print(f"Iter: {t:<10} LL {-losses[t]:1.3e}", flush=True)
                if callback is not None:
                    callback(self, t, losses[: t + n])
            t += n
            if average_last and t > avg_start:
                with torch.no_grad():
                    if params_sum is None:
                        params_sum = tree_map(lambda a: a.detach().clone(), self.params)
                    else:
                        params_sum = tree_map(lambda s, a: s + a.detach(), params_sum, self.params)
                n_snapshots += 1
            if convergence_checker is not None and convergence_checker(t - 1, losses):
                losses = losses[:t]
                break
        if n_snapshots:
            avg = tree_map(lambda s: s / n_snapshots, params_sum)
            self.params = tree_map(lambda a: a.requires_grad_(True), avg)
            # The optimizer state and the generator belong to the trajectory's
            # end, not to the average: save() writes no training state.
            self._opt_state = self._rng_state = None
        else:
            self._opt_state = loop.state()
            self._rng_state = self._gen.get_state()
        self._epoch = epoch0 + len(losses)
        return losses

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------
    def save(
        self,
        path: str,
        step: Optional[int] = None,
        include_data: bool = True,
        include_opt: bool = True,
        extra: Optional[dict] = None,
    ):
        """Self-contained checkpoint to ``path`` (.npz + .json manifest): the
        params, consts and spec, and unless left out the packed training
        batch and the last fit's optimizer and generator state, from which
        ``fit(resume_from=path)`` continues exactly. The JAX package's
        ``VariationalGPSA.load`` reads it (without the training state)."""
        with_opt = include_opt and self._opt_state is not None
        params = self._full_params()
        opt_state = self._opt_state_layout(self._opt_state, gather=True) if with_opt else None
        batch = self._batch if self._mesh is None else self._global_batch
        if self._mesh is None or torch.distributed.get_rank() == 0:
            save_checkpoint(
                path,
                params,
                self.consts,
                step=step if step is not None else self._epoch,
                extra={"seed": self._seed, "torch_rng_device": self.device.type, **(extra or {})},
                spec=self.spec,
                batch=batch if include_data else None,
                opt_state=opt_state,
                rng_state=self._rng_state if with_opt else None,
            )
        if self._mesh is not None:
            self._comms["world"].barrier()  # the file exists when save returns

    @_hybridmethod
    def load(self_or_cls, path: str, device=None):
        """Restore a checkpoint written by ``save`` (or by the JAX package's).

        ``model.load(path)`` copies the params and consts into this model's
        tensors (shapes must match) and takes its epoch and generator state;
        ``VariationalGPSA.load(path, device=None)`` builds a model from a
        self-contained checkpoint alone, on ``device`` (None = "cuda").
        The optimizer state is read by ``fit(resume_from=path)``.
        """
        blob = load_checkpoint_blob(path)
        if not isinstance(self_or_cls, type):
            model = self_or_cls
            model._assign(blob)
            model._restore_training_state(blob)
            return model
        spec_dict = blob["manifest"].get("spec")
        if spec_dict is None:
            raise ValueError(
                f"{path} is not self-contained (no spec in its manifest); construct "
                "the model and call model.load(path) instead"
            )
        spec = spec_from_dict(spec_dict)
        dev = resolve_device(device)
        params = tensors_from_numpy(nest(blob["params"]), dev)
        params.setdefault("W", {})  # an empty subtree (no LMC) has no npz entries
        consts = tensors_from_numpy(nest(blob["consts"]), dev)
        batch = tensors_from_numpy(nest(blob["data"]), dev) if blob["data"] else None
        model = self_or_cls.__new__(self_or_cls)
        model.device = dev
        model.spec = spec
        model._set_state(params, consts, batch, int(blob["manifest"].get("seed", 0)))
        model._restore_training_state(blob)
        # reinitialize() and fit_multistart need the original data (attach_data).
        model._init_args = model._ctor_kwargs = None
        fixed = [i for i, b in enumerate(spec.fixed_view_mask) if b]
        model.fixed_view_idx = None if not fixed else (fixed[0] if len(fixed) == 1 else fixed)
        model.n_latent_gps = {m.name: (m.n_latent if m.use_lmc else None)
                              for m in spec.modalities}
        return model

    def _assign(self, blob: dict):
        """Copy a checkpoint's params and consts into the model's tensors
        (in place: a captured step keeps reading them; on a distributed
        model the rank's blocks of them)."""
        self._commit_params_to_mesh(unflatten_into(self._full_params(), blob["params"]))
        copy_into(self.consts, unflatten_into(self.consts, blob["consts"]))

    def _restore_training_state(self, blob: dict, require_generator: bool = False):
        """Take the checkpoint's epoch and, when it was saved on this kind of
        device, its generator state (a CUDA and a CPU generator's states
        differ; ``require_generator`` raises on that)."""
        self._epoch = int(blob["manifest"].get("step") or 0)
        if blob["torch_rng"] is None:
            return
        saved_on = blob["manifest"].get("torch_rng_device")
        if saved_on != self.device.type:
            if require_generator:
                raise ValueError(
                    f"the checkpoint's generator state is from a {saved_on} generator; "
                    f"this model's runs on {self.device.type}"
                )
            return
        self._rng_state = torch.from_numpy(np.array(blob["torch_rng"], np.uint8))
        self._gen.set_state(self._rng_state)

    def attach_data(
        self,
        data_dict: Dict[str, dict],
        data_init: bool = True,
        grid_init: bool = False,
        fixed_warp_kernel_variances=None,
        fixed_warp_kernel_lengthscales=None,
        fixed_data_kernel_lengthscales=None,
    ):
        """Attach the training data to a model whose checkpoint was saved
        with ``include_data=False`` (or that ``VariationalGPSA.load`` built),
        so it can fit, ``reinitialize`` and ``fit_multistart`` again.
        ``data_dict`` must have the layout the spec was built from
        (modalities, per-view counts, spatial and output dimensions); it is
        checked before packing. ``data_init`` / ``grid_init`` and the fixed
        kernel values restore the options ``reinitialize`` draws with (a
        spec with a fixed value requires it here)."""
        for mod in self.spec.modalities:
            if mod.name not in data_dict:
                raise ValueError(f"data_dict is missing modality {mod.name!r}")
            d = data_dict[mod.name]
            X, Y = _as_numpy(d["spatial_coords"]), _as_numpy(d["outputs"])
            nsl = [int(n) for n in d["n_samples_list"]]
            if nsl != list(mod.n_samples):
                raise ValueError(
                    f"{mod.name}: n_samples_list {nsl} does not match the spec's "
                    f"per-view counts {list(mod.n_samples)}"
                )
            if X.shape != (sum(nsl), self.spec.n_spatial_dims):
                raise ValueError(f"{mod.name}: spatial_coords shape {X.shape} != "
                                 f"({sum(nsl)}, {self.spec.n_spatial_dims})")
            if Y.shape != (sum(nsl), mod.n_outputs):
                raise ValueError(f"{mod.name}: outputs shape {Y.shape} != "
                                 f"({sum(nsl)}, {mod.n_outputs})")
        fixed = dict(
            fixed_warp_kernel_variances=fixed_warp_kernel_variances,
            fixed_warp_kernel_lengthscales=fixed_warp_kernel_lengthscales,
            fixed_data_kernel_lengthscales=fixed_data_kernel_lengthscales,
        )
        for flag, val in fixed.items():
            if getattr(self.spec, flag) and val is None:
                raise ValueError(
                    f"this checkpoint's spec has {flag}=True; pass the "
                    f"original fixed values to attach_data({flag}=...) so "
                    "reinitialize()/multistart rebuild the same model"
                )
        self._batch = pack_batch(self.spec, data_dict, self.device)
        if self._mesh is not None:
            from ..parallel.sharding import batch_shardings, local_block

            self._global_batch = self._batch
            self._batch = tree_map(lambda t, p: local_block(t, p, self._mesh), self._batch,
                                   batch_shardings(self.spec, self._mesh))
        self._init_args = dict(data_dict=data_dict, data_init=data_init, grid_init=grid_init,
                               **fixed)
        # Any cached train loop closed over the old (absent) batch.
        self.__dict__.pop("_train_loop_cache", None)
        self.__dict__.pop("_vec_loop_cache", None)
        return self


def distance_matrix(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances between the rows of X (n, D)
    and Y (m, D), as an (m, n) matrix (the reference helper, kept for its
    API as the JAX package keeps it)."""
    return torch.sum(torch.square(X.unsqueeze(0) - Y.unsqueeze(1)), dim=2)


class GPSA(VariationalGPSA):
    """Alias of the working model under the reference's base-class name."""
