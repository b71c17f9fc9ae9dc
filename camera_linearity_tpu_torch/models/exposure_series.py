"""ExposureSeries: exposure stacks, their linearity analysis and their
HDR merge.

Port of ``camera_linearity_tpu/models/exposure_series.py`` (reference:
modules/exposure_series.py:18-476).  The series materializes its images as
one ``(N, H, W, C)`` tensor plus an ``(N,)`` exposure vector.  The merge is
one call over that stack (ops/hdr.py): on CUDA, the fused repair-and-merge
kernel.  The pair statistics of the linearity analysis are batched calls
over the same stack, a few pairs at a time.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import CameraConfig, DEFAULT_CONFIG
from ..measurand import Measurand
from ..ops import hdr as hdr_ops
from ..ops import stats as stats_ops
from ..ops.linearize import icrf_derivative
from ..ops.uncertainty import scale_difference
from ..utils import general as gf
from ..utils import io
from .image_set import ImageSet

Tensor = torch.Tensor

__all__ = ["ExposurePair", "ExposureSeries"]


class ExposurePair:
    """A (short, long) exposure pairing with its computed statistics
    (exposure_series.py:18-76)."""

    def __init__(self, short_exposure: ImageSet, long_exposure: ImageSet):
        self.short_exposure = short_exposure
        self.long_exposure = long_exposure
        self.exposure_ratio = (short_exposure.features["exposure"]
                               / long_exposure.features["exposure"])
        self.absolute_difference: Optional[ImageSet] = None
        self.relative_difference: Optional[ImageSet] = None
        self.absolute_stats: Optional[Dict] = None
        self.relative_stats: Optional[Dict] = None

    def compute_difference(self) -> None:
        self.absolute_difference, self.relative_difference = \
            ImageSet.compute_difference(self.short_exposure,
                                        self.long_exposure)

    def compute_stats(self, axis=None, release_memory_after: bool = True
                      ) -> None:
        self.absolute_stats = (self.absolute_difference.measurand
                               .compute_dimension_statistics(axis=axis))
        self.relative_stats = (self.relative_difference.measurand
                               .compute_dimension_statistics(axis=axis))
        if release_memory_after:
            self.absolute_difference = None
            self.relative_difference = None

    def process_linearity_distribution(self, bins: int,
                                       included_range=None, channels=None,
                                       use_std: bool = False):
        """Histograms of the difference images (exposure_series.py:56-76)."""
        abs_h = self.absolute_difference.measurand.compute_channel_histogram(
            bins, included_range, channels, use_std)
        rel_h = self.relative_difference.measurand.compute_channel_histogram(
            bins, included_range, channels, use_std)
        return abs_h, rel_h


# ---------------------------------------------------------------------------
# pair statistics: (short, long) comparisons over space
# ---------------------------------------------------------------------------

def _pair_stats(short_val: Tensor, long_val: Tensor,
                short_std: Optional[Tensor], long_std: Optional[Tensor],
                ratio: Tensor, use_std: bool):
    """Absolute and relative difference statistics of one pair of (H, W, C)
    frames, over space."""
    (av, astd), (rv, rstd) = scale_difference(
        short_val, short_std if use_std else None, long_val,
        long_std if use_std else None, ratio)
    return (stats_ops.dimension_statistics(av, astd, axis=(0, 1)),
            stats_ops.dimension_statistics(rv, rstd, axis=(0, 1)))


def _pair_stats_all(stack_val: Tensor, stack_std: Optional[Tensor],
                    short_idx: Tensor, long_idx: Tensor, ratios: Tensor,
                    use_std: bool, batch_size: int = 8):
    """All K exposure-pair statistics over the (N, H, W, C) stack.

    The pairs are gathered from the stack ``batch_size`` at a time, as the
    JAX package's ``lax.map(batch_size=8)`` does, so live memory stays at a
    few pair-planes instead of all K difference images.  Returns the
    absolute and relative statistics as dicts of (K, C) tensors.
    """
    parts = []
    for start in range(0, short_idx.shape[0], batch_size):
        si = short_idx[start:start + batch_size]
        li = long_idx[start:start + batch_size]
        r = ratios[start:start + batch_size].to(stack_val.dtype)
        (av, astd), (rv, rstd) = scale_difference(
            stack_val[si], stack_std[si] if use_std else None,
            stack_val[li], stack_std[li] if use_std else None,
            r[:, None, None, None])
        parts.append((stats_ops.dimension_statistics(av, astd, axis=(1, 2)),
                      stats_ops.dimension_statistics(rv, rstd, axis=(1, 2))))

    def cat(kind):
        return {key: None if parts[0][kind][key] is None
                else torch.cat([p[kind][key] for p in parts])
                for key in parts[0][kind]}
    return cat(0), cat(1)


class ExposureSeries:
    """Manager of an exposure-matched image stack
    (exposure_series.py:79-476)."""

    def __init__(self, merged_image_set: Optional[ImageSet] = None,
                 directory_path: Optional[Path] = None,
                 input_image_sets: Optional[List[ImageSet]] = None,
                 config: CameraConfig = DEFAULT_CONFIG):
        self.merged_image_set = merged_image_set
        self.input_image_sets: List[ImageSet] = input_image_sets or []
        if isinstance(directory_path, Path) and directory_path.suffix != "":
            self.directory_path: Optional[Path] = directory_path.parent
        else:
            self.directory_path = directory_path
        self.exposure_pairs: Optional[List[ExposurePair]] = None
        self.config = config

    # --- constructors ---------------------------------------------------
    @classmethod
    def from_image_set(cls, reference_image_set: ImageSet,
                       directory_path: Optional[Path] = None,
                       config: CameraConfig = DEFAULT_CONFIG
                       ) -> "ExposureSeries":
        """Collect exposure matches of a reference image from a directory
        (exposure_series.py:117-145)."""
        search_path = directory_path if directory_path is not None \
            else reference_image_set.path.parent
        found = ImageSet.multiple_from_path(
            search_path, config=config, device=reference_image_set.device)
        matches = [s for s in found
                   if reference_image_set.is_exposure_match(s)]
        matches.sort(key=lambda s: s.features["exposure"])
        return cls(directory_path=search_path, input_image_sets=matches,
                   config=config)

    @classmethod
    def from_dir_path(cls, directory_path: Path,
                      config: CameraConfig = DEFAULT_CONFIG,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> List["ExposureSeries"]:
        """One ExposureSeries per distinct feature group in a directory
        (exposure_series.py:147-161), on ``device`` (by default the
        card)."""
        sets = ImageSet.multiple_from_path(directory_path, config=config,
                                           device=device)
        return cls.from_multiple_image_sets(sets, config=config)

    @classmethod
    def from_multiple_image_sets(cls, list_of_image_sets: List[ImageSet],
                                 config: CameraConfig = DEFAULT_CONFIG
                                 ) -> List["ExposureSeries"]:
        """Greedy grouping of ImageSets into exposure-matched series
        (exposure_series.py:163-203)."""
        sublists: List[List[ImageSet]] = []
        for image_set in list_of_image_sets:
            for sublist in sublists:
                if sublist[0].is_exposure_match(image_set):
                    sublist.append(image_set)
                    break
            else:
                sublists.append([image_set])
        out = []
        for sublist in sublists:
            sublist.sort(key=lambda s: s.features["exposure"])
            out.append(cls(input_image_sets=sublist, config=config))
        return out

    # --- loading --------------------------------------------------------
    def load_value_images(self, bit_64: bool = False) -> None:
        for image_set in self.input_image_sets:
            image_set.load_value_image(bit64=bit_64)

    def load_std_images(self, bit_64: bool = True) -> None:
        for image_set in self.input_image_sets:
            image_set.load_std_image(bit64=bit_64)

    @property
    def exposures(self) -> np.ndarray:
        return np.array([s.features["exposure"]
                         for s in self.input_image_sets])

    def stack(self, with_std: bool = False
              ) -> Tuple[Tensor, Optional[Tensor], Tensor]:
        """Materialize the series as tensors on the images' device:
        (N,H,W,C) values, optional (N,H,W,C) stds, (N,) exposures."""
        vals = torch.stack([s.measurand.val for s in self.input_image_sets])
        stds = None
        if with_std:
            stds = torch.stack([s.measurand.std
                                for s in self.input_image_sets])
        return vals, stds, torch.as_tensor(self.exposures, device=vals.device)

    # --- transforms -----------------------------------------------------
    def linearize(self, icrf: Tensor, icrf_diff: Optional[Tensor] = None,
                  release_memory: bool = False) -> "ExposureSeries":
        """Linearize every input image (exposure_series.py:226-250).

        Functional, unlike the reference's in-place variant: returns a new
        series and leaves ``self`` untouched."""
        new_sets = []
        for s in self.input_image_sets:
            new_sets.append(s.linearize(icrf, icrf_diff))
            if release_memory:
                s.release()
        return ExposureSeries(merged_image_set=self.merged_image_set,
                              directory_path=self.directory_path,
                              input_image_sets=new_sets, config=self.config)

    def extract(self, channels: Optional[Union[int, List[int]]] = None,
                release_memory: bool = False) -> "ExposureSeries":
        """Channel extraction across the series (exposure_series.py:252-281);
        functional like :meth:`linearize`."""
        merged = None if self.merged_image_set is None else \
            self.merged_image_set.extract(channels)
        new_sets = []
        for s in self.input_image_sets:
            new_sets.append(s.extract(channels))
            if release_memory:
                s.release()
        return ExposureSeries(merged_image_set=merged,
                              directory_path=self.directory_path,
                              input_image_sets=new_sets, config=self.config)

    # --- pairing --------------------------------------------------------
    def initialize_exposure_pairs(self, min_ratio: float = 0.1) -> None:
        """All i<j pairs with exposure ratio >= min_ratio
        (exposure_series.py:283-304)."""
        valid = []
        sets = self.input_image_sets
        for i, x in enumerate(sets):
            for j, y in enumerate(sets):
                if i >= j:
                    continue
                if x.features["exposure"] / y.features["exposure"] < min_ratio:
                    continue
                valid.append(ExposurePair(x, y))
        self.exposure_pairs = valid

    # --- HDR merge ------------------------------------------------------
    def _stacks_with_darks(self,
                           list_of_dark_fields: Optional[List[ImageSet]],
                           with_std: bool
                           ) -> Tuple[Tensor, Optional[Tensor], Tensor,
                                      Tensor]:
        """The raw stack plus a per-exposure dark-frame stack for the
        corrections prologue (exposure_series.py:317-345,371-381).

        Host code only selects which dark matches each exposure
        (exact-or-scale-down, image_set.py:157-198); exposures without a
        match get an all-zero dark plane, making the bad-pixel repair an
        exact no-op there (the reference skips those images).
        """
        vals, stds, darks = [], [], []
        for s in self.input_image_sets:
            if s.measurand is None or s.measurand.val is None:
                s.load_value_image()
            if with_std and s.measurand.std is None:
                s.load_std_image()
            vals.append(s.measurand.val)
            if with_std:
                stds.append(s.measurand.std)
            dark = s.get_dark_field(list_of_dark_fields)
            darks.append(torch.zeros_like(s.measurand.val) if dark is None
                         else dark.measurand.val)
        stack_val = torch.stack(vals)
        stack_std = torch.stack(stds) if with_std else None
        return (stack_val, stack_std, torch.stack(darks),
                torch.as_tensor(self.exposures, device=stack_val.device))

    def process_HDR_image(self, ICRF: Optional[Tensor] = None,
                          ICRF_diff: Optional[Tensor] = None,
                          list_of_dark_fields: Optional[List[ImageSet]]
                          = None,
                          use_std: bool = True,
                          flat_field: Optional[ImageSet] = None,
                          apply_flat_field: bool = True,
                          ICRF_base: Optional[Tensor] = None,
                          ICRF_diff_base: Optional[Tensor] = None
                          ) -> ImageSet:
        """Merge the series into an HDR image (exposure_series.py:399-419).

        Loads the calibrated ICRF from config when none is given; repairs
        hot pixels against matched dark frames; merges; optionally
        flat-field-corrects the result.  For >8-bit depths, pass the
        256-point solved curves as ``ICRF_base``/``ICRF_diff_base`` to merge
        through their interpolant on CUDA (ops/hdr.py:merge_hdr).  The
        tables move to the stack's device.
        """
        cfg = self.config
        if ICRF is None:
            ICRF, ICRF_diff = io.read_icrf_file(
                Path(cfg.data_path).joinpath(cfg.icrf_calibrated_file),
                cfg.bits)
        elif ICRF_diff is None:
            ICRF_diff = icrf_derivative(torch.as_tensor(ICRF), cfg.bits)

        if list_of_dark_fields is None and cfg.default_dark_path is not None:
            list_of_dark_fields = ImageSet.multiple_from_path(
                cfg.default_dark_path, config=cfg,
                device=self.input_image_sets[0].device)

        stack_val, stack_std, dark_stack, exposures = \
            self._stacks_with_darks(list_of_dark_fields, use_std)

        first = self.input_image_sets[0]
        flat_val = flat_std = None
        if apply_flat_field:
            flat = flat_field if flat_field is not None \
                else first.get_flat_field()
            # unconditional when a flat exists, matching the reference
            # (exposure_series.py:415-417); value-only merges flat-field
            # the value and keep std None.
            if flat is not None:
                if flat.measurand is None or flat.measurand.val is None:
                    flat.load_value_image()
                if flat.measurand.std is None:
                    flat.load_std_image()
                flat_val = flat.measurand.val
                flat_std = flat.measurand.std

        def table(t):
            return None if t is None else \
                torch.as_tensor(t, device=stack_val.device)

        hdr_val, hdr_std = hdr_ops.merge_corrected(
            stack_val, stack_std, dark_stack, exposures, table(ICRF),
            table(ICRF_diff),
            # the threshold is f32, as the JAX package passes it
            torch.tensor(cfg.dark_threshold, dtype=torch.float32),
            flat_val, flat_std,
            mid_percentage=cfg.flat_field_mid_percentage,
            compat=cfg.compat_mode
            if cfg.compat_mode in ("corrected", "reference")
            else "corrected",
            kernel_size=cfg.median_filter_kernel_size,
            icrf_base=table(ICRF_base), icrf_diff_base=table(ICRF_diff_base))

        hdr_set = ImageSet(
            file_path=first.get_file_path_without_exposure(),
            features=first.features,
            measurand=Measurand(hdr_val, hdr_std), config=cfg,
            device=stack_val.device)
        hdr_set.is_hdr = True

        self.merged_image_set = hdr_set
        return hdr_set

    # --- linearity analysis ----------------------------------------------
    def process_linearity(self, ICRF: Optional[Tensor] = None,
                          linearity_limit: Optional[int] = None,
                          use_std: bool = False) -> None:
        """Per-pair linearity statistics (exposure_series.py:421-446).

        Thresholds each image via ICRF-mapped limits, then computes the
        absolute/relative difference statistics of every exposure pair over
        the materialized (N, H, W, C) stack (``_pair_stats_all``).  Pairs
        built by hand from sets outside this series take one call each.
        """
        cfg = self.config
        lower, upper = gf.map_linearity_limits(linearity_limit,
                                               linearity_limit, ICRF, cfg)
        for s in self.input_image_sets:
            if s.measurand is None or s.measurand.val is None:
                s.load_value_image()
            if use_std and s.measurand.std is None:
                s.load_std_image()
            s.measurand = s.measurand.apply_thresholds(lower, upper)

        if self.exposure_pairs is None:
            self.initialize_exposure_pairs()
        if not self.exposure_pairs:
            return

        sets = self.input_image_sets
        index_of = {id(s): i for i, s in enumerate(sets)}
        if any(id(p.short_exposure) not in index_of
               or id(p.long_exposure) not in index_of
               for p in self.exposure_pairs):
            for pair in self.exposure_pairs:
                sm = pair.short_exposure.measurand
                lm = pair.long_exposure.measurand
                pair.absolute_stats, pair.relative_stats = _pair_stats(
                    sm.val, lm.val, sm.std, lm.std,
                    torch.tensor(pair.exposure_ratio, dtype=sm.val.dtype,
                                 device=sm.val.device),
                    use_std and sm.std is not None)
            return
        short_idx = [index_of[id(p.short_exposure)]
                     for p in self.exposure_pairs]
        long_idx = [index_of[id(p.long_exposure)]
                    for p in self.exposure_pairs]
        ratios = [p.exposure_ratio for p in self.exposure_pairs]

        effective_std = use_std and all(s.measurand.std is not None
                                        for s in sets)
        stack_val, stack_std, _ = self.stack(with_std=effective_std)
        dev = stack_val.device
        abs_all, rel_all = _pair_stats_all(
            stack_val, stack_std, torch.tensor(short_idx, device=dev),
            torch.tensor(long_idx, device=dev),
            torch.tensor(ratios, dtype=torch.float64, device=dev),
            effective_std)

        for k, pair in enumerate(self.exposure_pairs):
            pair.absolute_stats = {key: (None if v is None else v[k])
                                   for key, v in abs_all.items()}
            pair.relative_stats = {key: (None if v is None else v[k])
                                   for key, v in rel_all.items()}

    def collect_exposure_pair_stats(self) -> Tuple[Dict, Dict]:
        """Per-pair stats stacked into (pairs, channels) numpy arrays
        (exposure_series.py:448-476)."""
        def host(t):
            return None if t is None else t.detach().cpu().numpy()

        def collect(kind):
            out = {"ratios": [], "means": [], "stds": [], "errors": []}
            for pair in self.exposure_pairs:
                stats = (pair.absolute_stats if kind == "abs"
                         else pair.relative_stats)
                out["ratios"].append(pair.exposure_ratio)
                out["means"].append(host(stats["mean"]))
                out["stds"].append(host(stats["std"]))
                out["errors"].append(host(stats["error"]))
            return {key: None if all(e is None for e in v) else np.asarray(v)
                    for key, v in out.items()}
        return collect("abs"), collect("rel")
