"""``VariationalGPSA`` in PyTorch: the user-facing model.

Counterpart of ``spatial_alignment_tpu/models/vgpsa.py`` on its default
path: construction (spec + seeded init), ``fit`` with Adam (full-batch or
minibatch SVI), ``forward``, ``predict``, ``loss_fn`` and ``neg_elbo``. Each
training step runs ``core.negative_elbo`` (or ``negative_elbo_minibatch``)
forward and backward and one ``torch.optim.Adam`` step; per-step losses
stay on the device and are copied to the host once per chunk.

Divergences from the JAX package: torch optimizers instead of optax
(``recipe="accurate"`` is Adam under ``CosineAnnealingLR`` to lr/100, the
same schedule as ``optax.cosine_decay_schedule(lr, n, alpha=1e-2)``), a
``torch.Generator`` instead of ``jax.random`` (different sample streams for
the same seed), and a numpy k-means instead of sklearn's. Options the port
does not have yet raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..ops.kernels import kernel_name
from . import core
from .params import init_params, merge_hyperparams
from .spec import (
    ModelSpec,
    _as_numpy,
    build_spec,
    check_supported,
    create_view_idx_dict,
    pack_batch,
    pack_coords,
    unpack_points,
    view_mask,
)

_DEFAULT_LR = 1e-2


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to PyTorch yet (ROADMAP.md {item})")


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


class VariationalGPSA:
    """Deep-GP spatial alignment model (PyTorch port of the JAX model).

    ``device=None`` means ``"cuda"``; without a CUDA device that raises,
    and the caller passes ``device="cpu"`` to run the plain kernels.
    """

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
        check_supported(spec)
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
        self.fixed_view_idx = fixed_view_idx
        self.n_latent_gps = (
            n_latent_gps if n_latent_gps is not None else {m: None for m in self.spec.modality_names}
        )

    def _set_state(self, params, consts, batch, seed: int):
        """Install params/consts/batch and the bookkeeping derived from the spec."""
        self.params = _map(lambda t: t.detach().requires_grad_(True), params)
        self.consts = consts
        self._batch = batch
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._last_aux = None
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
        return _leaves(self.params)

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
        numpy arrays in the concatenated-per-view layout.
        """
        del Ns, prediction_mode
        if G_test is not None:
            raise _not_ported("forward(G_test=...) imputation", "A6")
        if view_idx is None:
            view_idx = self.view_idx
        spec = self._eval_spec(view_idx)
        hp = merge_hyperparams(self.params, self.consts)
        with torch.no_grad():
            result = core.forward(
                spec, hp, self._coords_batch(spec, X_spatial), S, generator=self._gen
            )
        self._last_aux = (hp, result.warp_aux, result.data_aux)
        unpack = lambda d: {m: unpack_points(spec, m, d[m]) for m in spec.modality_names}
        return (
            unpack(result.G_means),
            unpack(result.G_samples),
            unpack(result.F_latent_samples),
            unpack(result.F_observed_samples),
        )

    def predict(self, X_spatial: Dict[str, np.ndarray], view_idx=None, Ns=None):
        """Deterministic posterior prediction: (G_means, F_mean, F_var) in
        the reference layout, with no sampling."""
        del Ns
        if view_idx is None:
            view_idx = self.view_idx
        spec = self._eval_spec(view_idx)
        hp = merge_hyperparams(self.params, self.consts)
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
        """One ELBO evaluation on the training batch."""
        with torch.no_grad():
            return float(
                core.negative_elbo(
                    self.spec, self.params, self.consts, self._batch, S, generator=self._gen
                )
            )

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def _draw_noise(self, S: int):
        """(warp_noise, data_noise) for one step; None draws inside the step
        from the model's generator."""
        return None, None

    def _loss_fn(self, minibatch_size: Optional[int]):
        """(params, S, temp, warp_noise, data_noise) -> scalar loss over the
        training batch; the minibatch variant subsamples ``minibatch_size``
        points per view on the device each call (``core.subsample_batch``)."""
        spec, consts, batch, gen = self.spec, self.consts, self._batch, self._gen
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

    def _step(self, loss_fn, opt, sched, S: int, temp: float) -> torch.Tensor:
        warp_noise, data_noise = self._draw_noise(S)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(self.params, S, temp, warp_noise, data_noise)
        loss.backward()
        opt.step()
        if sched is not None:
            sched.step()
        return loss.detach()

    def fit(
        self,
        n_epochs: int,
        lr: float = _DEFAULT_LR,
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
        """Adam training loop; returns the per-step loss trace (float64).

        ``callback(model, epoch, losses)`` fires every ``print_every``
        epochs; ``convergence_checker(iternum, losses)`` can stop early at
        chunk ends; ``warp_temperature_schedule(epoch_array) -> temps``
        anneals the warp noise; ``average_last=K`` replaces the final
        parameters with the mean of chunk-end snapshots from the last K
        epochs; ``recipe="accurate"`` is Adam under cosine decay to lr/100
        with the temperature-0 objective. ``minibatch_size=B`` trains each
        step on an unbiased B-points-per-view subsample (stochastic
        variational inference); the returned trace holds the per-step
        minibatch estimates.
        """
        if resume_from is not None:
            raise _not_ported("fit(resume_from=...)", "A2")
        if optimizer is not None:
            raise _not_ported("fit(optimizer=...)", "A2")
        if recipe not in (None, "plain", "accurate"):
            raise ValueError(f"unknown recipe {recipe!r}")
        if self._batch is None:
            raise RuntimeError("this model has no training batch to fit on")
        loss_fn = self._loss_fn(minibatch_size)

        leaves = self.parameters()
        opt = torch.optim.Adam(leaves, lr=lr)
        sched = None
        if recipe == "accurate":
            sched = torch.optim.lr_scheduler.CosineAnnealingLR(
                opt, T_max=n_epochs, eta_min=lr * 1e-2
            )
            if warp_temperature_schedule is None:
                warp_temperature_schedule = lambda t: np.zeros_like(np.asarray(t, np.float32))

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
            if warp_temperature_schedule is not None:
                temps = np.asarray(warp_temperature_schedule(np.arange(t, t + n)), np.float32)
            else:
                temps = np.ones(n, np.float32)
            chunk = torch.stack([self._step(loss_fn, opt, sched, S, float(tt)) for tt in temps])
            losses[t : t + n] = chunk.cpu().numpy().astype(np.float64)
            if print_every and t % print_every == 0:
                print(f"Iter: {t:<10} LL {-losses[t]:1.3e}", flush=True)
                if callback is not None:
                    callback(self, t, losses[: t + n])
            t += n
            if average_last and t > avg_start:
                with torch.no_grad():
                    if params_sum is None:
                        params_sum = _map(lambda a: a.detach().clone(), self.params)
                    else:
                        params_sum = _map_pair(lambda s, a: s + a.detach(), params_sum, self.params)
                n_snapshots += 1
            if convergence_checker is not None and convergence_checker(t - 1, losses):
                losses = losses[:t]
                break
        if n_snapshots:
            avg = _map(lambda s: s / n_snapshots, params_sum)
            self.params = _map(lambda a: a.requires_grad_(True), avg)
        self._epoch = len(losses)
        return losses

    def fit_multistart(self, *args, **kwargs):
        """Not ported yet; raises."""
        raise _not_ported("fit_multistart", "A5")


def _map_pair(fn, a, b):
    if isinstance(a, dict):
        return {k: _map_pair(fn, a[k], b[k]) for k in a}
    return fn(a, b)


class GPSA(VariationalGPSA):
    """Alias of the working model under the reference's base-class name."""
