"""``WarpGPMLE`` in PyTorch: the maximum-likelihood (non-variational) GPSA.

Counterpart of ``spatial_alignment_tpu/models/mle.py``. The aligned
coordinates G are a free parameter, initialized at the observed coords, and
training maximizes

  log p(G | X)  per view and spatial dim, the warp GP prior
                N(G_vd ; affine(X_v), K_warp(X_v, X_v) + eps I)
  log p(Y | G)  per modality, the exact data GP marginal
                N(Y_p ; 0, K_data(G, G) + sigma^2 I) for each output p

with padded points masked out. Exact (no inducing points): O(N^3) a view
and O(N_total^3) for the data term, for small-N analyses as in the
reference's usage.

Every factorization runs the Cholesky kernel on the card
(``csrc/cholesky.cu``): through :func:`..ops.linalg.jittered_cholesky` the
(V, N_pad, N_pad) warp slab and one (N_total, N_total) data matrix a
modality, each after its jitter probe, and under the LMC the Gram of W
(:func:`_pinv`). The loss is float32 throughout (the JAX package
runs it under ``highest``). ``fit`` is Adam (``torch.optim.Adam``, the JAX
package's ``optax.adam``), one step captured as a CUDA graph and replayed
(:class:`.train.TrainLoop`); the fixed view's gradient is zeroed inside the
step, so its G stays at the observed coordinates bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..ops.kernels import get_kernel, kernel_name
from ..ops.cholesky import cholesky
from ..ops.linalg import chol_logdet, cholesky_solve, jittered_cholesky, tri_solve
from ._trees import leaves, named_leaves, tree_map
from .params import init_params, merge_hyperparams
from .spec import build_spec, create_view_idx_dict, pack_batch, unpack_points
from .train import TrainLoop

__all__ = ["WarpGPMLE"]

_LOG_2PI = math.log(2.0 * math.pi)
_VARIATIONAL = ("Xtilde", "Gtilde", "delta_G", "Omega_sqt_G", "Omega_sqt_F", "delta_F")


def _mvn_logpdf_chol(resid: torch.Tensor, chol: torch.Tensor) -> torch.Tensor:
    """Sum over the columns of resid (..., n, P) of log N(col; 0, L L^T) for
    chol (..., n, n): one solve against the (n, P) right-hand side, the
    JAX package's per-column ``vmap`` of the same arithmetic. Returns (...)."""
    n, P = resid.shape[-2:]
    w = tri_solve(chol, resid)
    quad = torch.square(w).sum(dim=(-2, -1))
    return -0.5 * (quad + P * chol_logdet(chol) + P * n * _LOG_2PI)


def _pinv(W: torch.Tensor) -> torch.Tensor:
    """The pseudo-inverse of a full-rank W (L, P) through the Cholesky factor
    of its smaller Gram: Wᵀ (W Wᵀ)⁻¹, or (Wᵀ W)⁻¹ Wᵀ when L > P.

    For a full-rank W it is the SVD's pseudo-inverse (``jnp.linalg.pinv``,
    the JAX package's), but the Gram squares W's condition number: its
    rounding grows as cond(W)² 2⁻²⁴ in float32, the SVD's as cond(W) 2⁻²⁴.
    An eager call refuses, with ``LinAlgError``, a W whose Gram is singular
    by the cutoff JAX's pinv puts on singular values (10 max(L, P) eps):
    cond(W)² from above, (‖W‖_F ‖W⁺‖_F)², past its inverse (cond(W) about
    500 in float32), or a non-finite factor. There the SVD would keep or
    drop the small directions. Inside a captured step, which reads nothing
    back, such a W gives a non-finite or meaningless loss instead.
    ``torch.linalg.pinv`` is not used: its SVD copies through the host on
    CUDA, which a captured step refuses."""
    rows = W.shape[0] <= W.shape[1]
    A = W if rows else W.transpose(-1, -2)
    L = cholesky(A @ A.transpose(-1, -2))
    sol = cholesky_solve(L, A)  # (A Aᵀ)⁻¹ A
    X = sol.transpose(-1, -2) if rows else sol
    if not (W.is_cuda and torch.cuda.is_current_stream_capturing()):
        cond2 = (W.detach().norm() * X.detach().norm()) ** 2
        cutoff = 10 * max(W.shape) * torch.finfo(W.dtype).eps
        if not bool(torch.isfinite(cond2) and cond2 * cutoff < 1):
            raise torch.linalg.LinAlgError(
                f"the LMC's W {tuple(W.shape)} is rank-deficient to working precision "
                f"(cond(W)² up to {float(cond2):.3g}, past 1 / {cutoff:.3g})")
    return X


def mle_loss(spec, params: dict, consts: dict, batch) -> torch.Tensor:
    """-[log p(G | X) + log p(Y | G)] with masked padded points (JAX
    ``mle._mle_loss``)."""
    hp = merge_hyperparams(params, consts)
    kern_w = get_kernel(spec.kernel_warp)
    kern_d = get_kernel(spec.kernel_data)
    eps = spec.diagonal_offset
    names = spec.modality_names

    # Warp prior per view over the concatenated modalities.
    X_all = torch.cat([batch[m]["coords"] for m in names], dim=1)  # (V, N, D)
    G_all = torch.cat([params["G"][m] for m in names], dim=1)
    mask = torch.cat([batch[m]["mask"] for m in names], dim=1)  # (V, N)
    mu = X_all @ hp["mean_slopes"] + hp["mean_intercepts"][:, None, :]
    ls, var = hp["warp_kernel_lengthscales"], hp["warp_kernel_variances"]
    Kv = kern_w(X_all, X_all, ls[:, None, None], var[:, None, None])  # (V, N, N)
    # Padded rows and columns decoupled: zeroed, with a unit diagonal.
    Kv = Kv * (mask[:, :, None] * mask[:, None, :]) + torch.diag_embed(1.0 - mask)
    lp_warp = _mvn_logpdf_chol((G_all - mu) * mask[..., None], jittered_cholesky(Kv, eps))
    # The fixed views' terms times 0, as the JAX package masks them (made on
    # the device, with no host copy inside a captured step).
    not_fixed = torch.ones_like(lp_warp)
    for v, fixed in enumerate(spec.fixed_view_mask):
        if fixed:
            not_fixed[v].fill_(0.0)
    total = torch.sum(lp_warp * not_fixed)

    # Data marginal per modality over all views' aligned coords.
    noise_pos = torch.exp(hp["noise_variance"]) + eps
    for mm, mod in enumerate(spec.modalities):
        G = params["G"][mod.name].reshape(-1, spec.n_spatial_dims)
        maskm = batch[mod.name]["mask"].reshape(-1)
        Y = batch[mod.name]["outputs"].reshape(-1, mod.n_outputs)
        Kd = kern_d(G, G, hp["data_kernel_lengthscale"], hp["data_kernel_variance"])
        sigma2 = torch.square(noise_pos[-spec.n_modalities + mm])
        eye = torch.eye(Kd.shape[0], dtype=Kd.dtype, device=Kd.device)
        Kd = Kd * (maskm[:, None] * maskm[None, :]) + torch.diag(1.0 - maskm) + sigma2 * eye
        Ym = Y * maskm[:, None]
        if mod.use_lmc:
            # Outputs projected onto the latent GPs through W's
            # pseudo-inverse, as the JAX package does.
            Ym = Ym @ _pinv(hp["W"][mod.name])
        total = total + _mvn_logpdf_chol(Ym, jittered_cholesky(Kd, eps))
    return -total


class WarpGPMLE:
    """MLE GPSA: free aligned coordinates, exact GP marginals.

    ``device=None`` means ``"cuda"``; without a CUDA device that raises,
    and the caller passes ``device="cpu"`` to run the plain kernels.
    """

    def __init__(
        self,
        data_dict: Dict[str, dict],
        n_spatial_dims: int = 2,
        n_noise_variance_params: int = 2,
        kernel_func_warp="rbf",
        kernel_func_data="rbf",
        n_latent_gps: Optional[Dict[str, Optional[int]]] = None,
        mean_function: str = "identity_fixed",
        fixed_warp_kernel_variances=None,
        fixed_warp_kernel_lengthscales=None,
        fixed_data_kernel_lengthscales=None,
        fixed_view_idx=None,
        *,
        seed: int = 0,
        diagonal_offset: float = 1e-5,
        device=None,
    ):
        del n_spatial_dims  # derived from the data
        self.device = resolve_device(device)
        # m_X / m_G do not enter the exact model; the spec machinery is shared.
        spec = build_spec(
            data_dict,
            m_X_per_view=1,
            m_G=1,
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
        )
        self.spec = spec
        params, consts, _ = init_params(
            spec,
            data_dict,
            data_init=False,
            seed=seed,
            fixed_warp_kernel_variances=fixed_warp_kernel_variances,
            fixed_warp_kernel_lengthscales=fixed_warp_kernel_lengthscales,
            fixed_data_kernel_lengthscales=fixed_data_kernel_lengthscales,
            device=self.device,
        )
        # The hyperparameters and the LMC W stay; the variational state goes.
        for k in _VARIATIONAL:
            params.pop(k, None)
        self._batch = pack_batch(spec, data_dict, self.device)
        # Free aligned coordinates, initialized at the observed coordinates.
        params["G"] = {m: self._batch[m]["coords"].clone() for m in spec.modality_names}
        self.params = tree_map(lambda t: t.detach().requires_grad_(True), params)
        self.consts = consts
        self.fixed_view_idx = fixed_view_idx
        vi, Ns, Ps, n_total = create_view_idx_dict(spec)
        self.view_idx, self.Ns, self.Ps, self.n_total = vi, Ns, Ps, n_total
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._loop = None

    # -- reference-parity surface ------------------------------------------
    @property
    def n_views(self) -> int:
        return self.spec.n_views

    @property
    def G(self) -> Dict[str, np.ndarray]:
        """Aligned coordinates in reference layout {mod: (N, D)}."""
        return {m: unpack_points(self.spec, m, self.params["G"][m])
                for m in self.spec.modality_names}

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
        from .vgpsa import VariationalGPSA

        return VariationalGPSA.create_view_idx_dict(self, data_dict)

    def forward(self, X_spatial, view_idx=None, Ns=None):
        """The current aligned coords (the reference MLE model's forward
        updates its state; the loss reads the parameters directly)."""
        del X_spatial, view_idx, Ns
        return self.G

    def loss_fn(self, X_spatial=None, view_idx=None, data_dict=None) -> torch.Tensor:
        """Negative joint log-likelihood at the current parameters, a 0-d
        tensor that autograd differentiates (the reference's call pattern:
        ``loss_fn(X_spatial, view_idx, data_dict)``)."""
        del X_spatial, view_idx, data_dict
        return mle_loss(self.spec, self.params, self.consts, self._batch)

    def _step_loss(self):
        """temp -> the loss with the fixed views' G cut from the gradient
        (the JAX package zeroes their gradient before the update). It holds
        no reference to the model (see ``VariationalGPSA._step_loss``)."""
        spec, params, consts, batch = self.spec, self.params, self.consts, self._batch
        fixed = torch.tensor(spec.fixed_view_mask, device=self.device)[:, None, None]

        def loss(temp):
            del temp  # no warp noise in the exact model
            p = dict(params)
            if spec.any_fixed_view:
                p["G"] = {m: torch.where(fixed, g.detach(), g) for m, g in params["G"].items()}
            return mle_loss(spec, p, consts, batch)

        return loss

    def fit(self, n_epochs: int, lr: float = 1e-2, chunk_size: int = 100) -> np.ndarray:
        """Adam at ``lr`` for ``n_epochs`` steps from a fresh optimizer
        state; returns the per-step losses (float64). On CUDA each step is a
        replay of one captured step, and the losses are copied to the host
        every ``chunk_size`` steps; on the CPU the steps run eagerly."""
        if self._loop is None or self._loop_lr != lr:
            self._loop = None  # free the old graph first
            opt = torch.optim.Adam(self.parameters(), lr=lr,
                                   capturable=self.device.type == "cuda")
            self._loop = TrainLoop(named_leaves(self.params), self._step_loss(), opt, self._gen)
            self._loop_lr = lr
        else:
            self._loop.reset_state()
        losses = np.zeros(n_epochs)
        for t in range(0, n_epochs, max(1, int(chunk_size))):
            n = min(chunk_size, n_epochs - t)
            losses[t : t + n] = self._loop.run(np.ones(n, np.float32))
        return losses
