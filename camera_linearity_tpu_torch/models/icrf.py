"""ICRF parameterization over a PCA basis.

Port of ``camera_linearity_tpu/models/icrf.py``.  The candidate inverse
camera response function is ``mean_icrf + PCA @ params`` or, without a mean
curve, ``linspace(0,1)**p0 + PCA @ params[1:]``
(reference: modules/ICRF_calibration_exposure.py:20-44).
"""
from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

__all__ = ["icrf_from_params"]


def icrf_from_params(params: Tensor, pca_basis: Tensor,
                     mean_icrf: Optional[Tensor] = None,
                     datapoints: Optional[int] = None) -> Tensor:
    """Candidate ICRF curves from PCA coefficients.

    ``params``: (..., K) with a mean curve, or (..., K+1) without one
    (params[..., 0] is the exponent of the power-law base curve);
    ``pca_basis``: (dp, K) shared, or (C, dp, K) per channel for a
    (C, S, K) population; ``mean_icrf``: (dp,) or (C, dp) to match.
    Returns curves (..., dp).

    On the card the product runs in float32 without TF32 (PyTorch's
    default): the JAX package pins it to HIGHEST precision because the
    TPU's default bf16 passes put ~1e-3 of noise on every curve.
    """
    if pca_basis.ndim == 3:  # per-channel bases under a population axis
        pca_basis = pca_basis[:, None]
        if mean_icrf is not None:
            mean_icrf = mean_icrf[:, None]
    coeffs = params if mean_icrf is not None else params[..., 1:]
    curve = torch.matmul(pca_basis, coeffs[..., None])[..., 0]
    if mean_icrf is not None:
        return mean_icrf + curve
    if datapoints is None:
        datapoints = pca_basis.shape[-2]
    x = torch.linspace(0.0, 1.0, datapoints, dtype=params.dtype,
                       device=params.device)
    return x ** params[..., :1] + curve
