"""Static model specification and padded data layout (PyTorch port).

Counterpart of ``spatial_alignment_tpu/models/spec.py``. The data layout is
stacked and masked, per modality:

  coords  (n_views, N_pad, D)
  outputs (n_views, N_pad, P)
  mask    (n_views, N_pad)        1.0 = real point, 0.0 = pad

``ModelSpec`` has the same fields and ``auto`` resolutions as the JAX
package's, so spec dicts round-trip between the two. The port computes in
float32 whatever the precision names say (they count TPU matrix-unit
passes), and it dispatches every Cholesky of a CUDA tensor to its kernel
whatever ``cholesky_impl`` says; both fields are kept for the round trip.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ModalitySpec:
    """Static shape info for one modality (e.g. "expression")."""

    name: str
    n_padded: int  # per-view padded point count
    n_outputs: int  # P
    n_latent: int  # L: n_latent_gps if LMC enabled, else P
    use_lmc: bool
    n_samples: Tuple[int, ...]  # true per-view counts

    @property
    def n_total(self) -> int:
        return int(sum(self.n_samples))


@dataclass(frozen=True)
class ModelSpec:
    """Every shape and flag the model functions need to know statically.

    Field meanings are those of the JAX package's ``ModelSpec``.
    """

    modalities: Tuple[ModalitySpec, ...]
    n_views: int
    n_spatial_dims: int
    m_X_per_view: int
    m_G: int
    kernel_warp: str = "rbf"
    kernel_data: str = "rbf"
    mean_function: str = "identity_fixed"
    n_noise_variance_params: int = 2
    fixed_view_mask: Tuple[bool, ...] = ()
    fixed_warp_kernel_variances: bool = False
    fixed_warp_kernel_lengthscales: bool = False
    fixed_data_kernel_lengthscales: bool = False
    diagonal_offset: float = 1e-5
    # True replicates the reference's use of the marginal variance as the
    # Normal scale of the warp samples; False uses sqrt(variance).
    reference_sample_scale: bool = False
    mean_penalty_param: float = 0.0
    data_chunk_size: Optional[int] = None
    # Closed-form data-layer expected log-likelihood (only the warp layer
    # is sampled).
    analytic_data_likelihood: bool = False
    svgp_matmul_precision: str = "highest"
    svgp_variance_precision: str = "follow"
    # How Kuu^-1 is applied: "solve" (per-use triangular solves),
    # "kl_inverse" (the KL reuses an explicit chol(Kuu)^-1), "inverse" (the
    # predictive uses it too), "mixed" (the mean through a narrow width-C
    # solve, the variance terms through the inverse).
    svgp_solve_mode: str = "solve"
    triangular_variational: bool = False
    whitened_variational: bool = False
    merged_factor_dispatch: bool = True
    cholesky_impl: str = "auto"
    quad_diag_impl: str = "xla"
    fused_factor_inverse: str = "auto"

    @property
    def modality_names(self) -> Tuple[str, ...]:
        return tuple(m.name for m in self.modalities)

    @property
    def n_modalities(self) -> int:
        return len(self.modalities)

    def modality(self, name: str) -> ModalitySpec:
        for m in self.modalities:
            if m.name == name:
                return m
        raise KeyError(name)

    @property
    def any_fixed_view(self) -> bool:
        return any(self.fixed_view_mask)

    def replace(self, **kw) -> "ModelSpec":
        return dataclasses.replace(self, **kw)


def spec_to_dict(spec: ModelSpec) -> dict:
    """JSON-serializable dict of a ModelSpec."""
    return dataclasses.asdict(spec)


def spec_from_dict(d: dict) -> ModelSpec:
    """Inverse of ``spec_to_dict`` (lists from JSON become tuples again)."""
    mods = tuple(
        ModalitySpec(
            name=m["name"],
            n_padded=int(m["n_padded"]),
            n_outputs=int(m["n_outputs"]),
            n_latent=int(m["n_latent"]),
            use_lmc=bool(m["use_lmc"]),
            n_samples=tuple(int(c) for c in m["n_samples"]),
        )
        for m in d["modalities"]
    )
    rest = {k: v for k, v in d.items() if k not in ("modalities", "fixed_view_mask")}
    return ModelSpec(
        modalities=mods,
        fixed_view_mask=tuple(bool(b) for b in d["fixed_view_mask"]),
        **rest,
    )


def check_supported(spec: ModelSpec) -> None:
    """Raise NotImplementedError for spec options the port does not have yet,
    naming the ROADMAP.md item that ports each."""
    unsupported = [
        (spec.triangular_variational, "triangular_variational=True", "queue A item 10"),
        (spec.whitened_variational, "whitened_variational=True", "queue A item 10"),
        (spec.data_chunk_size is not None, "data_chunk_size", "queue A item 8"),
        (not spec.merged_factor_dispatch, "merged_factor_dispatch=False", "queue A item 14"),
        (spec.quad_diag_impl == "pallas", "quad_diag_impl='pallas'", "queue B item 4"),
        (spec.fused_factor_inverse == "fused", "fused_factor_inverse='fused'", "queue B item 5"),
    ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to PyTorch yet (ROADMAP.md {item})"
            )


def _as_numpy(x) -> np.ndarray:
    """Accept numpy arrays and torch tensors."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def build_spec(
    data_dict: Dict[str, dict],
    *,
    m_X_per_view: int,
    m_G: int,
    n_latent_gps: Optional[Dict[str, Optional[int]]] = None,
    kernel_warp: str = "rbf",
    kernel_data: str = "rbf",
    mean_function: str = "identity_fixed",
    n_noise_variance_params: int = 2,
    fixed_view_idx=None,
    fixed_warp_kernel_variances=None,
    fixed_warp_kernel_lengthscales=None,
    fixed_data_kernel_lengthscales=None,
    diagonal_offset: float = 1e-5,
    reference_sample_scale: bool = False,
    mean_penalty_param: float = 0.0,
    pad_multiple: int = 1,
    data_chunk_size=None,
    analytic_data_likelihood: bool = False,
    svgp_matmul_precision: str = "auto",
    svgp_variance_precision: str = "auto",
    svgp_solve_mode: str = "auto",
    triangular_variational: bool = False,
    whitened_variational: bool = False,
    cholesky_impl: str = "auto",
    quad_diag_impl: str = "auto",
    fused_factor_inverse: str = "auto",
) -> ModelSpec:
    """Derive a ModelSpec from a reference-format data_dict, with the same
    validation and ``auto`` resolutions as the JAX package's build_spec."""
    names = list(data_dict.keys())
    n_views_set = {len(data_dict[m]["n_samples_list"]) for m in names}
    if len(n_views_set) != 1:
        raise ValueError("Each modality must have the same number of views.")
    n_views = n_views_set.pop()

    dims = {_as_numpy(data_dict[m]["spatial_coords"]).shape[1] for m in names}
    if len(dims) != 1:
        raise ValueError("Each modality must have the same number of spatial dimensions.")
    n_spatial_dims = dims.pop()

    if n_latent_gps is None:
        n_latent_gps = {m: None for m in names}

    modalities = []
    for name in names:
        entry = data_dict[name]
        counts = tuple(int(c) for c in entry["n_samples_list"])
        P = int(_as_numpy(entry["outputs"]).shape[1])
        L_cfg = n_latent_gps.get(name)
        use_lmc = L_cfg is not None
        L = int(L_cfg) if use_lmc else P
        n_pad = max(max(counts), 1)
        if pad_multiple > 1:
            n_pad = int(-(-n_pad // pad_multiple) * pad_multiple)
        modalities.append(
            ModalitySpec(
                name=name,
                n_padded=n_pad,
                n_outputs=P,
                n_latent=L,
                use_lmc=use_lmc,
                n_samples=counts,
            )
        )

    total_points = sum(sum(m.n_samples) for m in modalities)
    if svgp_matmul_precision == "auto":
        svgp_matmul_precision = "high" if total_points >= 2000 else "highest"
    if svgp_variance_precision == "auto":
        svgp_variance_precision = (
            "default" if svgp_matmul_precision == "high" else "follow"
        )
    if svgp_variance_precision not in ("follow", "default", "high", "highest"):
        raise ValueError(
            "svgp_variance_precision must be 'auto', 'follow', 'default', "
            f"'high' or 'highest', got {svgp_variance_precision!r}"
        )
    if svgp_solve_mode == "auto":
        # "mixed" at m >= 64 or >= 2000 points, "kl_inverse" below.
        if max(m_X_per_view, m_G) >= 64 or total_points >= 2000:
            svgp_solve_mode = "mixed"
        else:
            svgp_solve_mode = "kl_inverse"
    if svgp_solve_mode not in ("solve", "kl_inverse", "inverse", "mixed"):
        raise ValueError(
            f"svgp_solve_mode must be 'solve', 'kl_inverse', 'inverse', "
            f"'mixed' or 'auto', got {svgp_solve_mode!r}"
        )
    if cholesky_impl not in ("auto", "xla", "pallas"):
        raise ValueError(
            f"cholesky_impl must be 'auto', 'xla' or 'pallas', got {cholesky_impl!r}"
        )
    if quad_diag_impl == "auto":
        quad_diag_impl = "xla"
    if quad_diag_impl not in ("xla", "pallas"):
        raise ValueError(
            f"quad_diag_impl must be 'auto', 'xla' or 'pallas', got {quad_diag_impl!r}"
        )
    if fused_factor_inverse not in ("auto", "fused", "off"):
        raise ValueError(
            "fused_factor_inverse must be 'auto', 'fused' or 'off', got "
            f"{fused_factor_inverse!r}"
        )

    if fixed_view_idx is None:
        fixed = tuple(False for _ in range(n_views))
    else:
        idxs = (
            set(int(i) for i in fixed_view_idx)
            if isinstance(fixed_view_idx, (list, tuple, set, np.ndarray))
            else {int(fixed_view_idx)}
        )
        fixed = tuple(v in idxs for v in range(n_views))

    return ModelSpec(
        modalities=tuple(modalities),
        n_views=n_views,
        n_spatial_dims=n_spatial_dims,
        m_X_per_view=m_X_per_view,
        m_G=m_G,
        kernel_warp=kernel_warp,
        kernel_data=kernel_data,
        mean_function=mean_function,
        n_noise_variance_params=n_noise_variance_params,
        fixed_view_mask=fixed,
        fixed_warp_kernel_variances=fixed_warp_kernel_variances is not None,
        fixed_warp_kernel_lengthscales=fixed_warp_kernel_lengthscales is not None,
        fixed_data_kernel_lengthscales=fixed_data_kernel_lengthscales is not None,
        diagonal_offset=diagonal_offset,
        reference_sample_scale=reference_sample_scale,
        mean_penalty_param=mean_penalty_param,
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


# ---------------------------------------------------------------------------
# Host-side packing between the reference layout and the padded layout
# ---------------------------------------------------------------------------


def view_slices(counts: Sequence[int]) -> list:
    """Per-view [start, stop) into the concatenated axis (reference layout)."""
    cs = np.insert(np.cumsum(counts), 0, 0)
    return [(int(cs[i]), int(cs[i + 1])) for i in range(len(counts))]


def create_view_idx_dict(spec: ModelSpec):
    """Reference bookkeeping: view_idx, Ns, Ps, n_total."""
    view_idx, Ns, Ps = {}, {}, {}
    n_total = 0
    for mod in spec.modalities:
        slices = view_slices(mod.n_samples)
        view_idx[mod.name] = [np.arange(lo, hi) for lo, hi in slices]
        Ns[mod.name] = int(sum(mod.n_samples))
        Ps[mod.name] = mod.n_outputs
        n_total += Ns[mod.name]
    return view_idx, Ns, Ps, n_total


def _pad_views(spec: ModelSpec, mod: ModalitySpec, arr: np.ndarray) -> np.ndarray:
    padded = np.zeros((spec.n_views, mod.n_padded, arr.shape[1]), np.float32)
    for v, (lo, hi) in enumerate(view_slices(mod.n_samples)):
        padded[v, : hi - lo] = arr[lo:hi]
    return padded


def view_mask(spec: ModelSpec, mod: ModalitySpec) -> np.ndarray:
    """(V, N_pad) float32 mask: 1.0 on real points."""
    mask = np.zeros((spec.n_views, mod.n_padded), np.float32)
    for v, (lo, hi) in enumerate(view_slices(mod.n_samples)):
        mask[v, : hi - lo] = 1.0
    return mask


def pack_coords(
    spec: ModelSpec, X_spatial: Dict[str, np.ndarray], device="cpu"
) -> Dict[str, torch.Tensor]:
    """Concatenated (N_mod, D) coords -> padded (V, N_pad, D) per modality."""
    out = {}
    for mod in spec.modalities:
        x = _as_numpy(X_spatial[mod.name]).astype(np.float32)
        out[mod.name] = torch.from_numpy(_pad_views(spec, mod, x)).to(device)
    return out


def pack_batch(
    spec: ModelSpec, data_dict: Dict[str, dict], device="cpu"
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Full padded batch: coords, outputs, mask per modality."""
    coords = pack_coords(
        spec, {m: data_dict[m]["spatial_coords"] for m in spec.modality_names}, device
    )
    batch = {}
    for mod in spec.modalities:
        y = _as_numpy(data_dict[mod.name]["outputs"]).astype(np.float32)
        batch[mod.name] = {
            "coords": coords[mod.name],
            "outputs": torch.from_numpy(_pad_views(spec, mod, y)).to(device),
            "mask": torch.from_numpy(view_mask(spec, mod)).to(device),
        }
    return batch


def unpack_points(spec: ModelSpec, mod_name: str, arr) -> np.ndarray:
    """Padded (..., V, N_pad, C) -> reference concatenated (..., N_mod, C)."""
    mod = spec.modality(mod_name)
    arr = _as_numpy(arr)
    pieces = [arr[..., v, : mod.n_samples[v], :] for v in range(spec.n_views)]
    return np.concatenate(pieces, axis=-2)
