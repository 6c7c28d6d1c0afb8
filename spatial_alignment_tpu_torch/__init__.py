"""PyTorch / CUDA port of spatial_alignment_tpu (GPSA) for NVIDIA Hopper.

A second package beside the JAX one: it imports torch, numpy and scipy only,
never jax or the JAX package. Entry points run on the GPU unless the caller
passes ``device="cpu"``. It exports every name of the JAX package's
``__all__``, and the two weight converters.
"""

from .models.vgpsa import GPSA, VariationalGPSA
from .models.mle import WarpGPMLE
from .models.spec import ModelSpec, ModalitySpec, build_spec, pack_batch
from .models import core
from .models.convert import load_jax_checkpoint, params_from_numpy
from .ops.kernels import (
    rbf_kernel,
    matern12_kernel,
    matern32_kernel,
    rbf_kernel_numpy,
)
from .utils.convergence import ConvergenceChecker, LossNotDecreasingChecker
from .utils.preprocess import (
    polar_warp,
    get_st_coordinates,
    compute_distance,
    make_pinwheel,
    compute_size_factors,
    poisson_deviance,
    deviance_feature_selection,
    deviance_residuals,
    pearson_residuals,
)

__all__ = [
    "VariationalGPSA",
    "GPSA",
    "WarpGPMLE",
    "ModelSpec",
    "ModalitySpec",
    "build_spec",
    "pack_batch",
    "core",
    "rbf_kernel",
    "matern12_kernel",
    "matern32_kernel",
    "rbf_kernel_numpy",
    "ConvergenceChecker",
    "LossNotDecreasingChecker",
    "polar_warp",
    "get_st_coordinates",
    "compute_distance",
    "make_pinwheel",
    "compute_size_factors",
    "poisson_deviance",
    "deviance_feature_selection",
    "deviance_residuals",
    "pearson_residuals",
    "load_jax_checkpoint",
    "params_from_numpy",
]
