"""Kernels and linear algebra of the PyTorch port."""
