"""Synthetic data generators (numpy)."""

from .simulated import generate_twod_data
from .warps import apply_gp_warp

__all__ = ["apply_gp_warp", "generate_twod_data"]
