"""Numeric ops: uncertainty algebra, LUT linearization, filters, statistics,
the linearity energies and the HDR merge with its CUDA kernels."""
from . import uncertainty, linearize, filters  # noqa: F401
