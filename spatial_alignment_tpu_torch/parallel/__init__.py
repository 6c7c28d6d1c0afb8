"""Multi-GPU execution on ``torch.distributed``: one process a GPU.

Counterpart of ``spatial_alignment_tpu/parallel``. Importable without an
initialized process group; :func:`make_mesh` makes one from torchrun's
environment.
"""

from .sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
    batch_shardings,
    param_shardings,
    distribute,
)
from .shardmap import make_shardmap_neg_elbo, make_shardmap_train_step

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "make_mesh",
    "batch_shardings",
    "param_shardings",
    "distribute",
    "make_shardmap_neg_elbo",
    "make_shardmap_train_step",
]
