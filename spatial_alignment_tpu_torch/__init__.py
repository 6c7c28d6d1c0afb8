"""PyTorch / CUDA port of spatial_alignment_tpu (GPSA) for NVIDIA Hopper.

A second package beside the JAX one: it imports torch, numpy and scipy only,
never jax or the JAX package. Entry points run on the GPU unless the caller
passes ``device="cpu"``.
"""

from .models.convert import load_jax_checkpoint, params_from_numpy
from .models.vgpsa import GPSA, VariationalGPSA
from .ops.kernels import rbf_kernel_numpy

__all__ = [
    "GPSA",
    "VariationalGPSA",
    "load_jax_checkpoint",
    "params_from_numpy",
    "rbf_kernel_numpy",
]
