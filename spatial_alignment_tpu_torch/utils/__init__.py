"""Host-side utilities of the port: checkpoints, convergence checkers,
profiling and debug switches, the numpy preprocessing, metrics and GSEA
copies, and the affine pre-alignment; the JAX package's ``utils`` names."""
from .convergence import ConvergenceChecker, LossNotDecreasingChecker
from .preprocess import (
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
from .checkpoint import save_checkpoint, load_checkpoint
from .metrics import morans_i, morans_i_test, landmark_distances
from .gsea import (
    load_gmt,
    bh_fdr,
    enrichment_score,
    permutation_gsea,
    fisher_exact_gsea,
)
from .profiling import StepTimer, trace, enable_debug
from .prealign import coarse_affine_prealign, moment_align
