"""Live training-visualization callbacks (matplotlib, imported when a
callback is called): the JAX package's ``plotting`` names."""

from .callbacks import (
    callback_oned,
    callback_twod,
    callback_twod_aligned_only,
    callback_twod_multimodal,
)
