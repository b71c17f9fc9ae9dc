"""NaN-aware weighted statistics, histograms and KDE.

Port of ``camera_linearity_tpu/ops/stats.py`` (reference:
modules/measurand.py:318-469,716-761 and
modules/general_functions.py:132-223).  NaN is the masking sentinel, as in
the reference, so reductions are NaN-aware rather than boolean-mask driven.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

__all__ = [
    "dimension_statistics", "nanaverage", "apply_thresholds",
    "weighted_avg_and_std", "weighted_histogram", "gaussian_kde",
    "weighted_percentile",
]


def _dims(x: Tensor, axis):
    return tuple(range(x.ndim)) if axis is None else axis


def _nanstd(x: Tensor, axis) -> Tensor:
    """``jnp.nanstd`` (ddof 0): the NaN-free mean of the squared deviations
    from the NaN-free mean."""
    mean = torch.nanmean(x, dim=axis, keepdim=True)
    return torch.sqrt(torch.nanmean((x - mean) ** 2, dim=axis))


def dimension_statistics(val: Tensor, std: Optional[Tensor] = None,
                         axis=None) -> dict:
    """Mean/std/error statistics along ``axis``.

    Unweighted: nanmean / nanstd.  With ``std``: inverse-uncertainty weighted
    mean and spread, plus ``error`` = nanmean of the stds
    (measurand.py:318-350).
    """
    axis = _dims(val, axis)
    if std is None:
        return {"mean": torch.nanmean(val, dim=axis),
                "std": _nanstd(val, axis), "error": None}
    weights = 1.0 / std
    sum_w = torch.nansum(weights, dim=axis)
    mean = torch.nansum(val * weights, dim=axis) / sum_w
    mean_keep = torch.nansum(val * weights, dim=axis, keepdim=True) / \
        torch.nansum(weights, dim=axis, keepdim=True)
    spread = torch.sqrt(torch.nansum(weights * (val - mean_keep) ** 2,
                                     dim=axis) / sum_w)
    error = torch.nanmean(std, dim=axis)
    return {"mean": mean, "std": spread, "error": error}


def nanaverage(values: Tensor, weights: Tensor, axis) -> Tensor:
    """Weighted average ignoring NaNs in both inputs
    (general_functions.py:149-176).  Positions with zero valid weight are NaN.
    """
    valid = ~torch.isnan(values) & ~torch.isnan(weights)
    weighted_sum = torch.nansum(torch.where(valid, values * weights, 0.0),
                                dim=axis)
    weight_sum = torch.nansum(torch.where(valid, weights, 0.0), dim=axis)
    out = weighted_sum / weight_sum
    return torch.where(weight_sum == 0, torch.nan, out)


def weighted_avg_and_std(values: Tensor, weights: Optional[Tensor]
                         ) -> Tuple[Tensor, Tensor]:
    """Weighted average and standard deviation
    (general_functions.py:132-146)."""
    def average(x):
        if weights is None:
            return torch.mean(x)
        return torch.sum(x * weights) / torch.sum(weights)
    avg = average(values)
    return avg, torch.sqrt(average((values - avg) ** 2))


def apply_thresholds(val: Tensor, std: Optional[Tensor],
                     lower: Optional[Tensor] = None,
                     upper: Optional[Tensor] = None):
    """Set values outside per-channel [lower, upper] to NaN.

    Thresholds broadcast over the last (channel) axis, as the reference's
    in-place variant does (measurand.py:375-428), but the result is
    returned.  ``lower``/``upper`` hold one entry per channel; None skips a
    side.
    """
    c = val.shape[-1]
    kw = dict(dtype=val.dtype, device=val.device)
    lower = torch.full((c,), -math.inf, **kw) if lower is None \
        else torch.as_tensor(lower, **kw)
    upper = torch.full((c,), math.inf, **kw) if upper is None \
        else torch.as_tensor(upper, **kw)
    mask = (val < lower) | (val > upper)
    new_val = torch.where(mask, torch.nan, val)
    new_std = None if std is None else torch.where(mask, torch.nan, std)
    return new_val, new_std


def _finite_weights(values: Tensor, std: Optional[Tensor]
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """Flattened values, their finite mask and their weights: 1/std (zero
    stds excluded) or 1, and 0 where excluded."""
    flat = values.reshape(-1)
    finite = torch.isfinite(flat)
    if std is None:
        return flat, finite, finite.to(flat.dtype)
    sflat = std.reshape(-1)
    finite = finite & (sflat != 0)
    weights = torch.where(finite, 1.0 / torch.where(sflat == 0, 1.0, sflat),
                          0.0)
    return flat, finite, weights


def weighted_histogram(values: Tensor, bins: int,
                       included_range: Optional[Tuple[float, float]] = None,
                       std: Optional[Tensor] = None):
    """Fixed-size weighted histogram of one channel's finite values
    (measurand.py:430-469): non-finite values (and zero-std entries when
    weighting) get zero weight, which yields the counts of the reference's
    boolean-masked ``np.histogram``.  Returns (hist, bin_edges)."""
    flat, finite, weights = _finite_weights(values, std)
    if included_range is None:
        lo = torch.min(torch.where(finite, flat, math.inf))
        hi = torch.max(torch.where(finite, flat, -math.inf))
    else:
        lo = torch.tensor(included_range[0], dtype=flat.dtype,
                          device=flat.device)
        hi = torch.tensor(included_range[1], dtype=flat.dtype,
                          device=flat.device)
    edges = lo + (hi - lo) * torch.linspace(0.0, 1.0, bins + 1,
                                            dtype=flat.dtype,
                                            device=flat.device)
    width = (hi - lo) / bins
    # np.histogram semantics: right-inclusive final bin; NaNs land anywhere
    # with zero weight
    idx = torch.floor((flat - lo) / width)
    idx = torch.nan_to_num(idx, nan=0.0).clamp(0, bins - 1).long()
    in_range = (flat >= lo) & (flat <= hi)
    w = torch.where(in_range, weights, 0.0)
    hist = torch.zeros(bins, dtype=w.dtype, device=w.device).index_add_(
        0, idx, w)
    return hist, edges


def gaussian_kde(values: Tensor, x_range: Tensor,
                 std: Optional[Tensor] = None,
                 chunk: int = 131072) -> Tensor:
    """Weighted Gaussian KDE with Silverman bandwidth, evaluated on x_range:
    ``scipy.stats.gaussian_kde`` as the reference uses it
    (measurand.py:716-761), weights 1/std with zero-std and non-finite
    points excluded.

    The evaluation walks data-point chunks of size ``chunk``, so the
    (points, samples) kernel matrix never materializes: peak memory is
    O(chunk * len(x_range)).
    """
    flat, finite, raw_w = _finite_weights(values, std)
    w = raw_w / torch.sum(raw_w)
    neff = 1.0 / torch.sum(w ** 2)
    x = torch.where(finite, flat, 0.0)
    mean = torch.sum(w * x)
    # scipy's weighted covariance divides by 1 - sum(w^2)
    var = torch.sum(w * (x - mean) ** 2) / (1.0 - torch.sum(w ** 2))
    factor = (neff * 3.0 / 4.0) ** (-1.0 / 5.0)   # Silverman, 1-D
    bw2 = var * factor ** 2
    norm = 1.0 / torch.sqrt(2.0 * math.pi * bw2)
    wv = torch.where(finite, w, 0.0)

    acc = torch.zeros_like(x_range)
    for start in range(0, x.numel(), chunk):
        diff = x_range[:, None] - x[None, start:start + chunk]
        acc = acc + torch.sum(torch.exp(-0.5 * diff ** 2 / bw2)
                              * wv[None, start:start + chunk], dim=1)
    return acc * norm


def weighted_percentile(values: Tensor,
                        percentiles: Optional[Tensor] = None,
                        weights: Optional[Tensor] = None) -> Tensor:
    """Weighted percentiles (general_functions.py:179-223).  An index past
    the end reads NaN, as ``jnp.take`` fills it."""
    kw = dict(dtype=values.dtype, device=values.device)
    if percentiles is None:
        percentiles = [75.0, 25.0]
    percentiles = torch.as_tensor(percentiles, **kw) / 100.0
    if weights is None:
        weights = torch.ones(values.numel(), **kw)
    idx = torch.argsort(values, stable=True)
    a_sort = values[idx]
    ecdf = torch.cumsum(weights[idx], dim=0)
    p = percentiles * (weights.sum() - 1)
    idx_low = torch.searchsorted(ecdf, p, right=True)
    idx_high = torch.searchsorted(ecdf, p + 1, right=True).clamp_max(
        ecdf.numel() - 1)
    weights_high = p - torch.floor(p)
    weights_low = 1.0 - weights_high

    def take(i):
        inside = i < a_sort.numel()
        return torch.where(inside, a_sort[i.clamp_max(a_sort.numel() - 1)],
                           torch.nan)
    return take(idx_low) * weights_low + take(idx_high) * weights_high
