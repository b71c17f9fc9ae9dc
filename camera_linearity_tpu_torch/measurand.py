"""Measurand: a value tensor paired with its uncertainty.

Port of ``camera_linearity_tpu/measurand.py``: an immutable dataclass over
torch tensors in place of the JAX pytree (reference: modules/measurand.py,
whose NumPy/CuPy class split becomes the tensor's device).  ``val`` and
``std`` have identical shapes; ``std`` may be None (no uncertainty
tracking).  The trailing axis is the channel axis.  All arithmetic
propagates uncertainty to first order with the reference's formulas (see
ops/uncertainty.py for per-op citations).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .ops import filters as filt_ops
from .ops import linearize as lin_ops
from .ops import stats as stats_ops
from .ops import uncertainty as u
from .utils.device import canonical_float

Tensor = torch.Tensor
InputType = Union[Tensor, np.ndarray, int, float, "Measurand"]

__all__ = ["Measurand"]


def _as_tensor(x) -> Optional[Tensor]:
    """Host scalars, lists and arrays become CPU tensors; tensors pass."""
    if x is None or isinstance(x, Tensor):
        return x
    if isinstance(x, (int, float)):
        return torch.tensor([float(x)], dtype=canonical_float("cpu"))
    return torch.as_tensor(np.asarray(x))


def _as_val_std(other: InputType) -> Tuple[Tensor, Optional[Tensor]]:
    if isinstance(other, Measurand):
        return other.val, other.std
    if isinstance(other, (int, float)):
        return torch.tensor(float(other), dtype=canonical_float("cpu")), None
    if isinstance(other, (Tensor, np.ndarray)):
        return torch.as_tensor(other), None
    raise TypeError(f"Invalid operand type: {type(other)}")


@dataclass(frozen=True)
class Measurand:
    """Immutable (value, uncertainty) pair with first-order propagation."""

    val: Tensor
    std: Optional[Tensor] = None

    def __post_init__(self):
        # normalize host scalars/lists/arrays at construction
        # (measurand.py:695-714)
        object.__setattr__(self, "val", _as_tensor(self.val))
        object.__setattr__(self, "std", _as_tensor(self.std))

    @property
    def shape(self):
        return self.val.shape

    @property
    def dtype(self):
        return self.val.dtype

    @property
    def device(self) -> torch.device:
        return self.val.device

    @property
    def channels(self) -> int:
        """Size of the trailing (independent) axis."""
        return self.val.shape[-1] if self.val.ndim else 1

    def __repr__(self):
        std_shape = None if self.std is None else tuple(self.std.shape)
        return (f"Measurand(val.shape={tuple(self.val.shape)}, "
                f"std.shape={std_shape})")

    def with_val(self, val: Tensor) -> "Measurand":
        return dataclasses.replace(self, val=val)

    def with_std(self, std: Optional[Tensor]) -> "Measurand":
        return dataclasses.replace(self, std=std)

    def zeros_like(self) -> "Measurand":
        """Zero-filled measurand of the same shape (measurand.py:304-316)."""
        return Measurand(torch.zeros_like(self.val),
                         None if self.std is None
                         else torch.zeros_like(self.std))

    # reference method name (measurand.py:304)
    zeros_like_measurand = zeros_like

    def to_numpy(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Host copies of (val, std)."""
        return (self.val.cpu().numpy(),
                None if self.std is None else self.std.cpu().numpy())

    # --- arithmetic ----------------------------------------------------
    def __add__(self, other: InputType) -> "Measurand":
        ov, os = _as_val_std(other)
        return Measurand(*u.add(self.val, self.std, ov, os))

    __radd__ = __add__

    def __sub__(self, other: InputType) -> "Measurand":
        ov, os = _as_val_std(other)
        return Measurand(*u.sub(self.val, self.std, ov, os))

    def __neg__(self) -> "Measurand":
        return Measurand(*u.neg(self.val, self.std))

    def __mul__(self, other: InputType) -> "Measurand":
        ov, os = _as_val_std(other)
        return Measurand(*u.mul(self.val, self.std, ov, os))

    __rmul__ = __mul__

    def __truediv__(self, other: InputType) -> "Measurand":
        ov, os = _as_val_std(other)
        return Measurand(*u.div(self.val, self.std, ov, os))

    def __pow__(self, other: InputType) -> "Measurand":
        ov, os = _as_val_std(other)
        return Measurand(*u.pow(self.val, self.std, ov, os))

    def log_e(self, compat: str = "corrected") -> "Measurand":
        return Measurand(*u.log_e(self.val, self.std, compat=compat))

    def log_10(self) -> "Measurand":
        return Measurand(*u.log_10(self.val, self.std))

    # --- statistics ----------------------------------------------------
    def compute_dimension_statistics(self, axis=None) -> dict:
        """NaN-aware (inverse-uncertainty-weighted) mean/std/error
        (measurand.py:318-350)."""
        return stats_ops.dimension_statistics(self.val, self.std, axis=axis)

    def _channel_std(self, c: int, use_std: bool) -> Optional[Tensor]:
        return self.std[..., c] if (use_std and self.std is not None) \
            else None

    def compute_channel_histogram(self, bins: int,
                                  included_range: Optional[Tuple[float, float]]
                                  = None,
                                  channels: Optional[List[int]] = None,
                                  use_std: bool = False) -> dict:
        """Per-channel weighted histograms (measurand.py:430-469)."""
        if channels is None:
            channels = list(range(self.channels))
        return {c: stats_ops.weighted_histogram(
                    self.val[..., c], bins, included_range,
                    self._channel_std(c, use_std))
                for c in channels}

    def compute_kernel_density_estimate(self, data_points: int,
                                        included_range: Optional[
                                            Tuple[float, float]] = None,
                                        channels: Optional[List[int]] = None,
                                        use_std: bool = False) -> dict:
        """Per-channel Gaussian KDE, Silverman bandwidth
        (measurand.py:716-761): {channel: (kde, x_range)}."""
        if channels is None:
            channels = list(range(self.channels))
        out = {}
        for c in channels:
            vals = self.val[..., c]
            if included_range is None:
                finite = vals[torch.isfinite(vals)]
                lo, hi = finite.min().item(), finite.max().item()
            else:
                lo, hi = included_range
            x_range = torch.linspace(lo, hi, data_points, dtype=vals.dtype,
                                     device=vals.device)
            out[c] = (stats_ops.gaussian_kde(vals, x_range,
                                             self._channel_std(c, use_std)),
                      x_range)
        return out

    # --- masking / extraction ------------------------------------------
    def apply_thresholds(self, lower=None, upper=None) -> "Measurand":
        """NaN-mask values outside per-channel thresholds
        (measurand.py:375-428), returning a new Measurand.  ``lower`` and
        ``upper`` hold one entry per channel; None entries (or None for the
        whole argument) skip that bound."""
        c = self.channels

        def norm(bounds, fill):
            if bounds is None:
                return None
            if isinstance(bounds, (list, tuple)):
                if len(bounds) != c:
                    raise ValueError(
                        "Threshold length must match the independent axis.")
                bounds = [fill if b is None else float(b) for b in bounds]
            return torch.as_tensor(bounds, dtype=self.val.dtype,
                                   device=self.val.device)
        return Measurand(*stats_ops.apply_thresholds(
            self.val, self.std, norm(lower, -np.inf), norm(upper, np.inf)))

    def extract(self, dims: Optional[Union[int, List[int]]] = None,
                axis: int = -1) -> "Measurand":
        """Take slices along ``axis`` (measurand.py:352-373)."""
        target = torch.as_tensor([dims] if isinstance(dims, int) else dims,
                                 device=self.val.device)
        val = torch.index_select(self.val, axis, target)
        std = None if self.std is None else torch.index_select(
            self.std, axis, target)
        return Measurand(val, std)

    # --- domain ops ----------------------------------------------------
    def linearize(self, icrf: Tensor, icrf_diff: Optional[Tensor] = None,
                  max_dn: Optional[int] = None) -> "Measurand":
        """ICRF LUT linearization (measurand.py:471-541)."""
        return Measurand(*lin_ops.linearize(self.val, self.std, icrf,
                                            icrf_diff, max_dn=max_dn))

    def apply_gaussian_weight(self) -> Tuple[Tensor, Tensor]:
        """HDR weighting function and derivative (measurand.py:606-618)."""
        return u.gaussian_weight(self.val)

    def filter_larger_than_by_map(self, map_m: "Measurand",
                                  threshold_value: float,
                                  kernel_size: int = 3) -> "Measurand":
        """Median-replace pixels where ``map_m.val > threshold``
        (measurand.py:543-557, with the masked-assignment bug fixed)."""
        return Measurand(*filt_ops.bad_pixel_filter(
            self.val, self.std, map_m.val, threshold_value, kernel_size))

    def normalize_by_map(self, map_m: "Measurand",
                         mid_percentage: float = 0.05) -> "Measurand":
        """Flat-field correction with 3-term uncertainty
        (measurand.py:559-604)."""
        return Measurand(*filt_ops.flat_field_correction(
            self.val, self.std, map_m.val, map_m.std, mid_percentage))

    # --- static combinators --------------------------------------------
    @staticmethod
    def compute_difference(x: "Measurand", y: "Measurand",
                           multiplier: float
                           ) -> Tuple["Measurand", "Measurand"]:
        """(absolute, relative) scaled difference (measurand.py:620-655)."""
        (av, as_), (rv, rs) = u.scale_difference(x.val, x.std, y.val, y.std,
                                                 multiplier)
        return Measurand(av, as_), Measurand(rv, rs)

    @staticmethod
    def interpolate(x0: "Measurand", x1: "Measurand", y0: float, y1: float,
                    y: float, compat: str = "corrected") -> "Measurand":
        """Linear interpolation between measurands (measurand.py:657-681)."""
        return Measurand(*u.lerp(x0.val, x0.std, x1.val, x1.std, y0, y1, y,
                                 compat=compat))
