"""Multi-process merge and statistics.

Port of ``camera_linearity_tpu/parallel/sharded.py``.  Each process holds
its own block of the mesh (parallel/mesh.py) as a plain tensor:

* the HDR merge is pointwise over pixels, so each process merges its
  (B_loc, N, H_loc, W, C) block on its own card, through the same kernel
  as the single-process path (K1, or K2 with base curves), and nothing
  crosses processes;
* the statistics reduce over the sharded rows: each process sums its own
  rows, and the partial sums combine by ``all_reduce`` over the mesh axis,
  as the JAX package's ``psum`` does (the reference's
  ``compute_dimension_statistics``, measurand.py:318-350).

The partial sums accumulate in float64 whatever the values' type.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import hdr as hdr_ops
from ..ops.uncertainty import scale_difference

Tensor = torch.Tensor

__all__ = ["merge_batch_sharded", "dimension_statistics_sharded",
           "pair_stats_sharded"]


def merge_batch_sharded(batch_val: Tensor, batch_std: Optional[Tensor],
                        exposures: Tensor, icrf: Tensor, icrf_diff: Tensor,
                        mesh: DeviceMesh, compat: str = "corrected",
                        icrf_base: Optional[Tensor] = None,
                        icrf_diff_base: Optional[Tensor] = None
                        ) -> Tuple[Tensor, Optional[Tensor]]:
    """HDR-merge this process's (B_loc, N, H_loc, W, C) block of a batch of
    scenes laid out on ``mesh`` (scenes over ``data``, rows over
    ``pixel``; parallel/mesh.py::shard_batch_of_scenes).  Returns its
    (B_loc, H_loc, W, C) block of the merged batch (and of the std).

    The block merges through ``ops/hdr.py::merge_batch``: one launch of K1
    on CUDA, or of K2 when 256-point base curves come with a >8-bit
    table.  A value-only merge does not take the diff curve.
    """
    if icrf_base is not None and batch_std is not None \
            and icrf_diff_base is None:
        raise ValueError("merge_batch_sharded: icrf_diff_base is required "
                         "when batch_std is given alongside icrf_base "
                         "(uncertainty needs the base derivative curve)")
    return hdr_ops.merge_batch(
        batch_val, batch_std, exposures, icrf, icrf_diff, compat=compat,
        icrf_base=icrf_base,
        icrf_diff_base=None if batch_std is None else icrf_diff_base)


def _sums(group, *terms: Tensor) -> Tuple[Tensor, ...]:
    """Each (H_loc, W, C) term summed over its rows and columns in float64,
    then over the group's processes (one ``all_reduce``)."""
    parts = torch.stack([torch.sum(t, dim=(0, 1), dtype=torch.float64)
                         for t in terms])
    dist.all_reduce(parts, group=group)
    return tuple(parts.unbind(0))


def dimension_statistics_sharded(val: Tensor, std: Optional[Tensor],
                                 mesh: DeviceMesh, axis_name: str = "pixel"):
    """NaN-aware (weighted) mean/std/error over the leading two axes of an
    (H, W, C) array whose rows shard over ``axis_name``; ``val`` and
    ``std`` are this process's rows.

    Equal to ``ops.stats.dimension_statistics(axis=(0, 1))`` of the whole
    array; every process gets the result.  The weighted spread takes a
    second round of sums, because it needs the global mean.
    """
    group = mesh.get_group(axis_name)
    if std is None:
        finite = torch.isfinite(val)
        v = torch.where(finite, val, 0.0)
        n, s1, s2 = _sums(group, finite, v, v * v)
        mean = s1 / n
        var = s2 / n - mean ** 2
        spread = torch.sqrt(torch.clamp(var, min=0.0))
        return {"mean": mean.to(val.dtype), "std": spread.to(val.dtype),
                "error": None}

    finite = torch.isfinite(val) & torch.isfinite(std)
    w = torch.where(finite, 1.0 / std, 0.0)
    sw, swv, n, s_sum = _sums(group, w, torch.where(finite, w * val, 0.0),
                              finite, torch.where(finite, std, 0.0))
    mean = swv / sw
    swd, = _sums(group, torch.where(finite,
                                    w * (val - mean.to(val.dtype)) ** 2,
                                    0.0))
    return {"mean": mean.to(val.dtype),
            "std": torch.sqrt(swd / sw).to(val.dtype),
            "error": (s_sum / n).to(val.dtype)}


def pair_stats_sharded(short_val: Tensor, long_val: Tensor,
                       short_std: Optional[Tensor],
                       long_std: Optional[Tensor], ratio: float,
                       mesh: DeviceMesh, axis_name: str = "pixel"):
    """Sharded absolute/relative exposure-pair statistics: the elementwise
    difference stays with each process's rows, only the statistics reduce
    (exposure_series.py:443-446 across processes)."""
    (av, astd), (rv, rstd) = scale_difference(
        short_val, short_std, long_val, long_std, ratio)
    return (dimension_statistics_sharded(av, astd, mesh, axis_name),
            dimension_statistics_sharded(rv, rstd, mesh, axis_name))
