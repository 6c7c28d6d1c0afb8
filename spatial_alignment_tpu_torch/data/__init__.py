"""Synthetic data generators, warps, real-data loaders and preprocessing
(numpy and scipy; ``load_h5ad`` also needs h5py): the JAX package's
``data`` names."""

from .warps import (
    apply_gp_warp,
    apply_gp_warp_multimodal,
    apply_linear_warp,
    apply_polar_warp,
)
from .simulated import (
    generate_oned_data_affine_warp,
    generate_oned_data_gp_warp,
    generate_twod_data,
    generate_twod_data_partial_overlap,
)
from .realdata import (
    load_h5ad,
    load_st_data,
    load_csv_expression,
    knn_r2_gene_filter,
    remove_outlier_spots,
    rotate_coords,
    synthetic_visium_like,
    synthetic_slideseq_like,
    synthetic_st_like,
)

__all__ = [
    "apply_gp_warp",
    "apply_gp_warp_multimodal",
    "apply_linear_warp",
    "apply_polar_warp",
    "generate_oned_data_affine_warp",
    "generate_oned_data_gp_warp",
    "generate_twod_data",
    "generate_twod_data_partial_overlap",
    "load_h5ad",
    "load_st_data",
    "load_csv_expression",
    "knn_r2_gene_filter",
    "remove_outlier_spots",
    "rotate_coords",
    "synthetic_visium_like",
    "synthetic_slideseq_like",
    "synthetic_st_like",
]
