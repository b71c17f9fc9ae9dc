"""Shared numeric utilities (reference: modules/general_functions.py).

Port of the helpers of ``camera_linearity_tpu/utils/general.py`` that the
linearity analysis and the calibration use.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import CameraConfig
from ..ops.linearize import _interp

Tensor = torch.Tensor

__all__ = ["choose_evenly_spaced_points", "predict_output_shape",
           "map_linearity_limits", "interpolate_data"]


def choose_evenly_spaced_points(array, step_x: int,
                                step_y: Optional[int] = None):
    """Stride-subsample the two leading axes (general_functions.py:27-44)."""
    if step_y is None:
        step_y = step_x
    return array[::step_x, ::step_y, ...]


def predict_output_shape(input_shape: Tuple[int, int], step_x: int,
                         step_y: Optional[int] = None) -> Tuple[int, int]:
    """Output shape of choose_evenly_spaced_points
    (general_functions.py:47-67)."""
    if step_y is None:
        step_y = step_x
    rows, cols = input_shape
    return (rows + step_x - 1) // step_x, (cols + step_y - 1) // step_y


def map_linearity_limits(lower_limit: Optional[int],
                         upper_limit: Optional[int], icrf: Optional[Tensor],
                         config: CameraConfig) -> Tuple[Tensor, Tensor]:
    """Map DN-domain inclusion limits into the linear domain via the ICRF
    (general_functions.py:97-129).

    ``lower_limit``/``upper_limit`` are DN distances from the range edges;
    None falls back to the config's linearity limits.  Without an ICRF the
    limits are normalized to [0,1] (float64 CPU tensors); with one they are
    its entries, on its device.
    """
    chs = config.num_of_chs
    lower = np.array([config.lower_linearity_limit if lower_limit is None
                      else lower_limit] * chs, dtype=float)
    upper = np.array([config.upper_linearity_limit if upper_limit is None
                      else config.max_dn - upper_limit] * chs, dtype=float)
    if icrf is None:
        return (torch.as_tensor(lower / config.max_dn),
                torch.as_tensor(upper / config.max_dn))

    icrf = torch.as_tensor(icrf)
    lo_idx = torch.as_tensor(lower.astype(int), device=icrf.device)
    hi_idx = torch.as_tensor(upper.astype(int), device=icrf.device)
    if icrf.ndim == 1:
        return icrf[lo_idx], icrf[hi_idx]
    ch_idx = torch.arange(chs, device=icrf.device)
    return icrf[lo_idx, ch_idx], icrf[hi_idx, ch_idx]


def interpolate_data(clean_data_arr: Tensor, bits: int,
                     datapoints: int) -> Tensor:
    """Row-wise resample of a (rows, bits) table to ``datapoints`` columns
    (general_functions.py:70-94)."""
    if bits == datapoints:
        return clean_data_arr
    kw = dict(dtype=clean_data_arr.dtype, device=clean_data_arr.device)
    x_old = torch.linspace(0.0, 1.0, bits, **kw)
    x_new = torch.linspace(0.0, 1.0, datapoints, **kw)
    return torch.stack([_interp(x_new, x_old, row)
                        for row in clean_data_arr])
