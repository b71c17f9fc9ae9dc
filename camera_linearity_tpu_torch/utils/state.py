"""State carried across from the JAX package: ICRF tables, payloads and
the calibration's inputs.

The ICRF tables and their 256-point base curves are this system's weights:
the calibration solves them (``models/calibration.py`` of either package,
or ``<icrf>.txt`` / ``<icrf>_base.txt`` files on disk) and every merge reads
them.  The calibration itself reads DN stacks and a PCA basis.  These
helpers turn the numpy arrays either package holds into the port's
tensors, on an explicit device, checked.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..measurand import Measurand
from .device import canonical_float

Tensor = torch.Tensor

__all__ = ["icrf_tables_from_numpy", "measurand_from_numpy",
           "channel_stacks_from_numpy", "pca_from_numpy"]


def _tensor(arr, device, dtype) -> Tensor:
    return torch.as_tensor(np.asarray(arr), device=device, dtype=dtype)


def icrf_tables_from_numpy(icrf, icrf_diff, icrf_base=None,
                           icrf_diff_base=None, *, device,
                           dtype: Optional[torch.dtype] = None
                           ) -> Tuple[Tensor, Tensor, Optional[Tensor],
                                      Optional[Tensor]]:
    """``(icrf, icrf_diff, icrf_base, icrf_diff_base)`` as tensors.

    ``icrf``/``icrf_diff``: (bits, C) tables (or (bits,) for one channel);
    ``icrf_base``/``icrf_diff_base``: optional (256, C) base curves, both or
    neither.  ``dtype`` defaults to the device's canonical float.
    """
    dtype = canonical_float(device) if dtype is None else dtype
    icrf, icrf_diff = np.asarray(icrf), np.asarray(icrf_diff)
    if icrf.shape != icrf_diff.shape or icrf.ndim not in (1, 2):
        raise ValueError(f"icrf {icrf.shape} and icrf_diff "
                         f"{icrf_diff.shape} must be one (bits, C) shape")
    if (icrf_base is None) != (icrf_diff_base is None):
        raise ValueError("pass both base curves or neither")
    base = diff_base = None
    if icrf_base is not None:
        icrf_base, icrf_diff_base = (np.asarray(icrf_base),
                                     np.asarray(icrf_diff_base))
        want = (256,) + icrf.shape[1:]
        if icrf_base.shape != want or icrf_diff_base.shape != want:
            raise ValueError(f"base curves {icrf_base.shape} and "
                             f"{icrf_diff_base.shape} must be {want}")
        base = _tensor(icrf_base, device, dtype)
        diff_base = _tensor(icrf_diff_base, device, dtype)
    return (_tensor(icrf, device, dtype), _tensor(icrf_diff, device, dtype),
            base, diff_base)


def measurand_from_numpy(val, std=None, *, device,
                         dtype: Optional[torch.dtype] = None) -> Measurand:
    """A :class:`Measurand` from numpy value (and std) arrays of one shape;
    ``dtype`` defaults to the device's canonical float."""
    dtype = canonical_float(device) if dtype is None else dtype
    val = np.asarray(val)
    if std is not None and np.shape(std) != val.shape:
        raise ValueError(f"std {np.shape(std)} must match val {val.shape}")
    return Measurand(_tensor(val, device, dtype),
                     None if std is None else _tensor(std, device, dtype))


def channel_stacks_from_numpy(value_stacks, std_stacks, exposures, *,
                              device, dtype: Optional[torch.dtype] = None
                              ) -> Tuple[Tensor, Optional[Tensor], Tensor]:
    """The calibration's ``channel_stacks``: (value_stacks (C, P, N) integer
    DNs as int64, std_stacks (C, P, N) or None, exposures (N,)), the floats
    in ``dtype`` (the device's canonical float by default)."""
    dtype = canonical_float(device) if dtype is None else dtype
    value_stacks, exposures = np.asarray(value_stacks), np.asarray(exposures)
    if value_stacks.ndim != 3 or not np.issubdtype(value_stacks.dtype,
                                                   np.integer):
        raise ValueError(f"value_stacks {value_stacks.shape} "
                         f"{value_stacks.dtype} must be (C, P, N) integers")
    if exposures.shape != value_stacks.shape[-1:]:
        raise ValueError(f"exposures {exposures.shape} must be "
                         f"({value_stacks.shape[-1]},)")
    if std_stacks is not None and np.shape(std_stacks) != value_stacks.shape:
        raise ValueError(f"std_stacks {np.shape(std_stacks)} must match "
                         f"value_stacks {value_stacks.shape}")
    return (_tensor(value_stacks, device, torch.int64),
            None if std_stacks is None
            else _tensor(std_stacks, device, dtype),
            _tensor(exposures, device, dtype))


def pca_from_numpy(pca, mean=None, *, device,
                   dtype: Optional[torch.dtype] = None
                   ) -> Tuple[Tensor, Optional[Tensor]]:
    """A PCA basis (C, dp, K) and its mean curves (C, dp) or None as
    tensors in ``dtype`` (the device's canonical float by default)."""
    dtype = canonical_float(device) if dtype is None else dtype
    pca = np.asarray(pca)
    if pca.ndim != 3:
        raise ValueError(f"pca {pca.shape} must be (C, dp, K)")
    if mean is not None and np.shape(mean) != pca.shape[:2]:
        raise ValueError(f"mean {np.shape(mean)} must be {pca.shape[:2]}")
    return (_tensor(pca, device, dtype),
            None if mean is None else _tensor(mean, device, dtype))
