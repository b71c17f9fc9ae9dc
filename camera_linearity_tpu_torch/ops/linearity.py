"""Pairwise exposure-linearity analysis and the calibration energy.

Port of ``camera_linearity_tpu/ops/linearity.py`` (reference:
modules/ICRF_calibration_exposure.py:66-201).  Pairs are enumerated once
as upper-triangle index vectors of length K = N(N-1)/2 and every reduction
streams over pixels, so no (P, N, N) all-pairs broadcast is built.

Where the JAX package multiplies one-hot matrices on the TPU (which has no
gather), the port gathers: a population's curves are looked up at the
observed DNs with ``torch.gather``, which returns the same entries a
one-hot row times a curve returns at HIGHEST precision.  The population
energies take any leading batch dimensions (the calibration passes a
channel axis): curves (..., S, dp), DN stacks (..., P, N), std stacks
(..., P, N) and histograms (..., K, bits, bits) give energies (..., S).
The exposures (N,) are shared.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .linearize import lut_lookup
from .stats import nanaverage

Tensor = torch.Tensor

__all__ = ["upper_triangle_pairs", "valid_exposure_pairs",
           "pairwise_linearity", "linearity_energy",
           "linearity_energy_chunked", "pin_endpoints",
           "monotonicity_penalty_mask", "constraint_violation",
           "population_linearity_energies",
           "population_linearity_energies_chunked",
           "pair_dn_histograms", "population_linearity_energies_hist",
           "linearity_energy_hist_smooth", "build_data_onehot"]


def upper_triangle_pairs(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static i<j index vectors, row-major: np.triu_indices(n, 1) order, as
    ICRF_calibration_exposure.py:93,143 uses."""
    ii, jj = np.triu_indices(n, k=1)
    return ii.astype(np.int32), jj.astype(np.int32)


def valid_exposure_pairs(exposures: np.ndarray, min_ratio: float = 0.1
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """i<j pairs whose exposure ratio t_i/t_j >= min_ratio
    (exposure_series.py:283-304 rejects ratio < 0.1)."""
    ii, jj = upper_triangle_pairs(len(exposures))
    ratio = exposures[ii] / exposures[jj]
    keep = ratio >= min_ratio
    return ii[keep], jj[keep]


def _index(idx, device) -> Tensor:
    return torch.as_tensor(np.asarray(idx) if not isinstance(idx, Tensor)
                           else idx, device=device).long()


def _ratios(exposures: Tensor, ii: Tensor, jj: Tensor, dtype) -> Tensor:
    """Per-pair exposure ratios t_i/t_j, computed in the exposures' type
    and cast, as the JAX package casts them."""
    return (exposures[ii] / exposures[jj]).to(dtype)


def pairwise_linearity(stack_val: Tensor, stack_std: Optional[Tensor],
                       exposures: Tensor, ii, jj, use_relative: bool
                       ) -> Tuple[Tensor, Optional[Tensor]]:
    """Per-pair |difference| over a stack whose last axis is the exposure.

    ``stack_val``: (..., N); returns (..., K) of |g_i - r g_j| (absolute) or
    |(g_i - r g_j)/(r g_j)| (relative) plus the first-order std of the
    (relative) difference when ``stack_std`` is given
    (ICRF_calibration_exposure.py:108-130).
    """
    ii, jj = _index(ii, stack_val.device), _index(jj, stack_val.device)
    r = _ratios(torch.as_tensor(exposures, device=stack_val.device), ii, jj,
                stack_val.dtype)
    return _pair_terms(stack_val[..., ii], stack_val[..., jj],
                       None if stack_std is None else stack_std[..., ii],
                       None if stack_std is None else stack_std[..., jj],
                       r, use_relative)


def _pair_terms(g_i: Tensor, g_j: Tensor, s_i: Optional[Tensor],
                s_j: Optional[Tensor], r: Tensor, use_relative: bool
                ) -> Tuple[Tensor, Optional[Tensor]]:
    """|difference| of every pair and its std, from the two sides' values
    and stds; ``r`` broadcasts against them."""
    scaled = g_j * r
    diff = g_i - scaled
    if use_relative:
        diff = diff / scaled
    abs_diff = torch.abs(diff)
    if s_i is None:
        return abs_diff, None
    if use_relative:
        std = torch.sqrt((s_i / scaled) ** 2
                         + ((g_i * s_j) / (r * g_j ** 2)) ** 2)
    else:
        std = torch.sqrt(s_i ** 2 + (r * s_j) ** 2)
    return abs_diff, std


def pin_endpoints(icrf: Tensor) -> Tensor:
    """Anchor candidate ICRF curves (..., dp): shift so the top end hits 1,
    pin the bottom to 0 (ICRF_calibration_exposure.py:167-168)."""
    shifted = icrf + (1.0 - icrf[..., -1:])
    return torch.cat([torch.zeros_like(shifted[..., :1]), shifted[..., 1:]],
                     dim=-1)


def monotonicity_penalty_mask(icrf: Tensor) -> Tensor:
    """True where a curve (..., dp) is invalid: outside [0,1] or not
    strictly increasing.  The reference returns inf early
    (ICRF_calibration_exposure.py:174-179); here the mask selects the
    penalty."""
    out_of_range = (torch.amax(icrf, -1) > 1.0) | (torch.amin(icrf, -1) < 0.0)
    non_monotone = torch.any(icrf[..., 1:] <= icrf[..., :-1], dim=-1)
    return out_of_range | non_monotone


def _relu(x: Tensor) -> Tensor:
    # torch.maximum, not clamp: at a tie it splits the gradient in half,
    # as jnp.maximum does
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def constraint_violation(icrf: Tensor) -> Tensor:
    """Graded magnitude of the [0,1]-range and monotonicity violations of
    curves (..., dp); zero for valid curves.  The solver's 'soft' penalty
    ranks infeasible candidates by it, which gives differential evolution
    a way into the feasible region, while feasible curves keep their
    exact energies."""
    decreasing = torch.sum(_relu(icrf[..., :-1] - icrf[..., 1:]), dim=-1)
    over = _relu(torch.amax(icrf, -1) - 1.0)
    under = _relu(-torch.amin(icrf, -1))
    return decreasing + over + under


def _penalize(energies: Tensor, pinned: Tensor, invalid: Tensor,
              penalty: str) -> Tensor:
    if penalty == "soft":
        soft = 1e3 * (1.0 + constraint_violation(pinned))
        return torch.where(invalid, soft, energies)
    return torch.where(invalid, math.inf, energies)


def _finish(per_pair: Tensor, pinned: Tensor, invalid: Tensor,
            penalty: str) -> Tensor:
    """NaN-mean over the pair axis (-2), NaN to inf, then the penalty."""
    energies = torch.nanmean(per_pair, dim=-2)
    energies = torch.where(torch.isnan(energies), math.inf, energies)
    return _penalize(energies, pinned, invalid, penalty)


def linearity_energy(icrf_curve: Tensor, stack_dn: Tensor,
                     stack_std: Optional[Tensor], exposures: Tensor,
                     lower_dn: int, upper_dn: int, ii, jj,
                     use_relative: bool = True,
                     penalty: str = "hard") -> Tensor:
    """Scalar linearity energy of one candidate ICRF over one channel stack:
    _energy_function + analyze_linearity (ICRF_calibration_exposure.py:
    66-201): endpoint pinning, validity, candidate-mapped thresholds, the
    curve looked up at the integer DNs, per-pair NaN-masked (optionally
    1/std-weighted) mean over pixels, then the NaN-mean over pairs.

    ``stack_dn``: (P, N) integer DNs; ``stack_std``: (P, N) or None.
    """
    icrf = pin_endpoints(icrf_curve)
    invalid = monotonicity_penalty_mask(icrf)
    lo, hi = icrf[lower_dn], icrf[upper_dn]
    g = lut_lookup(stack_dn.long()[..., None], icrf[:, None])[..., 0]
    g = torch.where((g < lo) | (g > hi), torch.nan, g)
    abs_diff, pair_std = pairwise_linearity(g, stack_std, exposures, ii, jj,
                                            use_relative)
    if stack_std is not None:
        finite = torch.isfinite(abs_diff) & (pair_std != 0)
        weights = torch.where(finite, 1.0 / pair_std, torch.nan)
        per_pair = nanaverage(abs_diff, weights, axis=0)
    else:
        per_pair = torch.nanmean(abs_diff, dim=0)
    return _finish(per_pair[:, None], icrf, invalid, penalty)[0]


def _population_setup(curves: Tensor, lower_dn: int, upper_dn: int):
    pinned = pin_endpoints(curves)                            # (..., S, dp)
    return (pinned, monotonicity_penalty_mask(pinned),
            pinned[..., lower_dn], pinned[..., upper_dn])


def _lookup(pinned: Tensor, stack_dn: Tensor) -> Tensor:
    """Every curve at every observed DN: pinned (..., S, dp) and DNs
    (..., P, N) give (..., P, N, S)."""
    s = pinned.shape[-2]
    table = pinned.transpose(-1, -2)                          # (..., dp, S)
    lead = stack_dn.shape[:-2]
    idx = stack_dn.reshape(*lead, -1, 1).long().expand(*lead, -1, s)
    return torch.gather(table, -2, idx).reshape(*stack_dn.shape, s)


def _masked_lookup(pinned, lo_t, hi_t, stack_dn):
    g = _lookup(pinned, stack_dn)
    lo, hi = lo_t[..., None, None, :], hi_t[..., None, None, :]
    return torch.where((g < lo) | (g > hi), torch.nan, g)


def _population_pairs(g: Tensor, stack_std: Optional[Tensor], r: Tensor,
                      ii: Tensor, jj: Tensor, use_relative: bool):
    """Pair terms of looked-up values g (..., P, N, S): (..., P, K, S)."""
    return _pair_terms(
        g[..., ii, :], g[..., jj, :],
        None if stack_std is None else stack_std[..., ii, None],
        None if stack_std is None else stack_std[..., jj, None],
        r[:, None], use_relative)


def _weighted_sums(abs_diff: Tensor, pair_std: Optional[Tensor]
                   ) -> Tuple[Tensor, Tensor]:
    """Sums over the pixel axis (-3) of the finite, 1/std-weighted (or
    unit-weighted) differences, and of their weights."""
    if pair_std is not None:
        finite = torch.isfinite(abs_diff) & (pair_std != 0)
        wgt = torch.where(finite, 1.0 / pair_std, 0.0)
    else:
        finite = torch.isfinite(abs_diff)
        wgt = finite.to(abs_diff.dtype)
    num = torch.sum(torch.where(finite, abs_diff * wgt, 0.0), dim=-3)
    return num, torch.sum(wgt, dim=-3)


def population_linearity_energies(curves: Tensor, stack_dn: Tensor,
                                  stack_std: Optional[Tensor],
                                  exposures: Tensor,
                                  lower_dn: int, upper_dn: int, ii, jj,
                                  use_relative: bool = True,
                                  penalty: str = "soft") -> Tensor:
    """Energies of a whole candidate population over the whole stack.

    The JAX package's ``population_linearity_energies`` multiplies a
    precomputed one-hot of the data, (P*N, bits), by the curves; here the
    curves are gathered at the DNs themselves (``stack_dn`` (..., P, N),
    integer), which gives the same values.  ``curves``: (..., S, dp) raw
    candidates (un-pinned); ``stack_std``: (..., P, N) or None.  Returns
    (..., S) energies with the semantics of :func:`linearity_energy` under
    ``penalty``.
    """
    dev = curves.device
    ii, jj = _index(ii, dev), _index(jj, dev)
    r = _ratios(exposures, ii, jj, curves.dtype)
    pinned, invalid, lo_t, hi_t = _population_setup(curves, lower_dn,
                                                    upper_dn)
    g = _masked_lookup(pinned, lo_t, hi_t, stack_dn)          # (..., P, N, S)
    abs_diff, pair_std = _population_pairs(g, stack_std, r, ii, jj,
                                           use_relative)
    if stack_std is not None:
        num, den = _weighted_sums(abs_diff, pair_std)
        per_pair = torch.where(den == 0, torch.nan, num / den)
    else:
        per_pair = torch.nanmean(abs_diff, dim=-3)            # (..., K, S)
    return _finish(per_pair, pinned, invalid, penalty)


def build_data_onehot(stack_dn: Tensor, bits: int,
                      dtype=torch.float32) -> Tensor:
    """(P*N, bits) one-hot of the observed DNs, the operand of the JAX
    package's population matmul.  ``build_data_onehot(dn) @ curves.T``
    equals the gather ``curves.T[dn.reshape(-1)]`` that
    :func:`population_linearity_energies` makes instead."""
    flat = stack_dn.reshape(-1).long()
    iota = torch.arange(bits, device=flat.device)
    return (flat[:, None] == iota).to(dtype)


def population_linearity_energies_chunked(curves: Tensor, stack_dn: Tensor,
                                          stack_std: Optional[Tensor],
                                          exposures: Tensor,
                                          lower_dn: int, upper_dn: int,
                                          ii, jj,
                                          use_relative: bool = True,
                                          penalty: str = "soft",
                                          chunk: int = 16384) -> Tensor:
    """:func:`population_linearity_energies` at any pixel count: pixel
    chunks of ``chunk`` (the last one may be short) are looked up and
    reduced one at a time into per-(K, S) weighted sums, so peak memory is
    O(chunk * N * K * S) whatever P is."""
    dev = curves.device
    ii, jj = _index(ii, dev), _index(jj, dev)
    r = _ratios(exposures, ii, jj, curves.dtype)
    pinned, invalid, lo_t, hi_t = _population_setup(curves, lower_dn,
                                                    upper_dn)
    num = den = 0.0
    for start in range(0, stack_dn.shape[-2], chunk):
        sl = slice(start, start + chunk)
        g = _masked_lookup(pinned, lo_t, hi_t, stack_dn[..., sl, :])
        terms = _population_pairs(
            g, None if stack_std is None else stack_std[..., sl, :], r, ii,
            jj, use_relative)
        n_c, d_c = _weighted_sums(*terms)
        num, den = num + n_c, den + d_c
    per_pair = torch.where(den == 0, torch.nan, num / den)   # (..., K, S)
    return _finish(per_pair, pinned, invalid, penalty)


def pair_dn_histograms(stack_dn: Tensor, ii, jj, bits: int) -> Tensor:
    """Joint (dn_i, dn_j) occupancy per exposure pair: (..., K, bits, bits)
    int32 counts from DN stacks (..., P, N) with DNs in [0, bits).

    The unweighted linearity energy depends on the data only through these
    counts, so the pixel axis condenses once and every energy afterwards
    costs O(K * bits^2) whatever the resolution.  One ``torch.bincount``
    per pair (the JAX package sorts, with ``segment_sum``, because a
    scatter-add serializes on the TPU).
    """
    dn = stack_dn.long()
    lo, hi = int(dn.min()), int(dn.max())
    if lo < 0 or hi >= bits:
        raise ValueError(f"DNs span [{lo}, {hi}], outside [0, {bits})")
    lead = dn.shape[:-2]
    flat = dn.reshape(-1, *dn.shape[-2:])                     # (B, P, N)
    b = flat.shape[0]
    offset = torch.arange(b, device=dn.device)[:, None] * (bits * bits)
    hists = [torch.bincount((flat[:, :, i] * bits + flat[:, :, j]
                             + offset).reshape(-1),
                            minlength=b * bits * bits).reshape(b, -1)
             for i, j in zip(_index(ii, "cpu").tolist(),
                             _index(jj, "cpu").tolist())]
    return torch.stack(hists, dim=1).reshape(
        *lead, len(hists), bits, bits).to(torch.int32)


def population_linearity_energies_hist(curves: Tensor, hists: Tensor,
                                       exposures: Tensor,
                                       lower_dn: int, upper_dn: int, ii, jj,
                                       use_relative: bool = True,
                                       penalty: str = "soft") -> Tensor:
    """Resolution-independent population energies from joint histograms.

    For the unweighted objective the per-pair mean over pixels of
    |g[dn_i] - r g[dn_j]| / (r g[dn_j]) is exactly

        sum_ab H_k(a,b) valid(a,b) d_k(a,b) / sum_ab H_k(a,b) valid(a,b)

    with ``H_k`` from :func:`pair_dn_histograms` ((..., K, b, b)).  One pair
    at a time, each an (..., S, b, b) computation.  Same masking and NaN
    semantics as :func:`linearity_energy`.
    """
    dev = curves.device
    ii, jj = _index(ii, dev), _index(jj, dev)
    r_all = _ratios(exposures, ii, jj, curves.dtype)
    pinned, invalid, lo_t, hi_t = _population_setup(curves, lower_dn,
                                                    upper_dn)
    valid_dn = (pinned >= lo_t[..., None]) & (pinned <= hi_t[..., None])
    g_mask = torch.where(valid_dn, pinned, torch.nan)         # (..., S, b)
    hists_f = hists.to(curves.dtype)
    per = []
    for k in range(ii.shape[0]):
        gj = g_mask[..., None, :] * r_all[k]                  # (..., S, 1, b)
        diff = g_mask[..., :, None] - gj
        if use_relative:
            diff = diff / gj
        d = torch.abs(diff)                                   # (..., S, b, b)
        ok = torch.isfinite(d)
        h_k = hists_f[..., k, None, :, :]                     # (..., 1, b, b)
        num = torch.sum(torch.where(ok, d, 0.0) * h_k, dim=(-2, -1))
        den = torch.sum(ok.to(d.dtype) * h_k, dim=(-2, -1))
        per.append(torch.where(den == 0, torch.nan, num / den))
    return _finish(torch.stack(per, dim=-2), pinned, invalid, penalty)


def linearity_energy_hist_smooth(icrf_curve: Tensor, hists: Tensor,
                                 exposures: Tensor,
                                 lower_dn: int, upper_dn: int, ii, jj,
                                 use_relative: bool = True,
                                 penalty_weight: float = 1e3) -> Tensor:
    """Gradient-safe energy of curves (..., dp) from joint DN histograms
    (..., K, b, b), all pairs at once.

    Same value as :func:`linearity_energy` on feasible curves: masked
    entries drop out through explicit 0/1 weights, not NaN, and masked
    curve values are replaced by 1 before any division, so autograd stays
    finite (``torch.where`` passes a NaN gradient as ``jnp.where`` does).
    An additive graded constraint penalty keeps a descent direction on
    infeasible iterates.  The polish after DE uses it; acceptance is
    checked against the exact DE objective.
    """
    icrf = pin_endpoints(icrf_curve)
    lo = icrf[..., lower_dn:lower_dn + 1]
    hi = icrf[..., upper_dn:upper_dn + 1]
    valid = (icrf >= lo) & (icrf <= hi)                       # (..., b)
    gsafe = torch.where(valid, icrf, 1.0)
    ii, jj = _index(ii, icrf.device), _index(jj, icrf.device)
    r = _ratios(exposures, ii, jj, icrf.dtype)[:, None, None]  # (K, 1, 1)
    hists_f = hists.to(icrf.dtype)
    ok = (valid[..., :, None] & valid[..., None, :]).to(icrf.dtype)
    gj = gsafe[..., None, None, :] * r                        # (..., K, 1, b)
    diff = gsafe[..., None, :, None] - gj                     # (..., K, b, b)
    if use_relative:
        diff = diff / gj
    w = ok[..., None, :, :] * hists_f
    num = torch.sum(torch.abs(diff) * w, dim=(-2, -1))        # (..., K)
    den = torch.sum(w, dim=(-2, -1))
    per = num / torch.clamp_min(den, 1.0)
    alive = (den > 0).to(icrf.dtype)
    base = torch.sum(per * alive, dim=-1) / torch.clamp_min(
        torch.sum(alive, dim=-1), 1.0)
    return base + penalty_weight * constraint_violation(icrf)


def linearity_energy_chunked(icrf_curve: Tensor, stack_dn: Tensor,
                             stack_std: Optional[Tensor], exposures: Tensor,
                             lower_dn: int, upper_dn: int, ii, jj,
                             use_relative: bool = True,
                             penalty: str = "hard",
                             chunk: int = 65536) -> Tensor:
    """Pixel-streamed :func:`linearity_energy`: chunks of ``chunk`` pixels
    accumulate per-pair weighted sums and weights (or sums and counts), so
    peak memory is O(chunk * K) whatever P is."""
    icrf = pin_endpoints(icrf_curve)
    invalid = monotonicity_penalty_mask(icrf)
    lo_t, hi_t = icrf[lower_dn], icrf[upper_dn]
    num = den = 0.0
    for start in range(0, stack_dn.shape[0], chunk):
        sl = slice(start, start + chunk)
        g = lut_lookup(stack_dn[sl].long()[..., None], icrf[:, None])[..., 0]
        g = torch.where((g < lo_t) | (g > hi_t), torch.nan, g)
        abs_diff, pair_std = pairwise_linearity(
            g, None if stack_std is None else stack_std[sl], exposures, ii,
            jj, use_relative)
        if pair_std is not None:
            finite = torch.isfinite(abs_diff) & (pair_std != 0)
            wgt = torch.where(finite, 1.0 / pair_std, 0.0)
            num = num + torch.sum(torch.where(finite, abs_diff * wgt, 0.0),
                                  dim=0)
            den = den + torch.sum(wgt, dim=0)
        else:
            finite = torch.isfinite(abs_diff)
            num = num + torch.sum(torch.where(finite, abs_diff, 0.0), dim=0)
            den = den + torch.sum(finite, dim=0)
    per_pair = torch.where(den == 0, torch.nan, num / den)
    return _finish(per_pair[:, None], icrf, invalid, penalty)[0]
