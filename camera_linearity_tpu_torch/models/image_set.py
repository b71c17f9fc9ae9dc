"""ImageSet: one acquired image (value + uncertainty) with its metadata.

Port of ``camera_linearity_tpu/models/image_set.py`` (reference:
modules/image_set.py:25-501): filename-grammar features, dark/flat-frame
matching, exposure scaling, differences and interpolation between frames,
tif loading and saving, and the dark/flat calibration helpers.  The
payload is a :class:`~camera_linearity_tpu_torch.measurand.Measurand`;
images loaded from files land on the set's ``device``, and saving moves
the payload to the host.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..config import CameraConfig, DEFAULT_CONFIG
from ..measurand import Measurand
from ..utils import io
from ..utils.device import canonical_float, resolve_device

Tensor = torch.Tensor

__all__ = ["ImageSet", "calibrate_flats", "calibrate_dark_frames"]


def _host(t: Optional[Tensor]) -> Optional[np.ndarray]:
    return None if t is None else t.detach().cpu().numpy()


class ImageSet:
    """An image + features + Measurand payload (image_set.py:25-53).

    ``device`` is where images loaded from files land: by default the
    payload's device, or the card for a set without a payload."""

    def __init__(self, file_path: Optional[Union[str, Path]] = None,
                 value: Optional[Tensor] = None, std: Optional[Tensor] = None,
                 features: Optional[Dict] = None,
                 measurand: Optional[Measurand] = None,
                 config: CameraConfig = DEFAULT_CONFIG,
                 device: Optional[Union[str, torch.device]] = None):
        self.path = Path(file_path) if isinstance(file_path, str) \
            else file_path
        self.config = config
        if measurand is not None:
            self.measurand = measurand
        elif value is not None or std is not None:
            self.measurand = Measurand(value, std)
        else:
            self.measurand = None
        # a payload decides the device; without one, the default (the card)
        if device is None and self.measurand is not None:
            device = self.measurand.device
        self.device = resolve_device(device)

        if features is not None:
            self.features = features
        elif self.path is not None:
            self.features = io.features_from_file_name(self.path)
        else:
            self.features = None
        self.is_hdr = False

    def __repr__(self):
        return (f"ImageSet(path={self.path}, features={self.features}, "
                f"measurand={self.measurand})")

    def _derived(self, measurand: Measurand,
                 features: Optional[Dict] = None) -> "ImageSet":
        return ImageSet(file_path=self.path,
                        features=self.features if features is None
                        else features,
                        measurand=measurand, config=self.config,
                        device=self.device)

    # --- loading -------------------------------------------------------
    @property
    def val(self) -> Optional[Tensor]:
        return None if self.measurand is None else self.measurand.val

    @property
    def std(self) -> Optional[Tensor]:
        return None if self.measurand is None else self.measurand.std

    def _to_device(self, arr) -> Tensor:
        return torch.as_tensor(arr, device=self.device,
                               dtype=canonical_float(self.device))

    def load_value_image(self, bit64: bool = False) -> "ImageSet":
        """Load the value image (image_set.py:214-226)."""
        arr = io.load_image(self.path, bit64=bit64,
                            max_dn=self.config.max_dn)
        if arr is None:
            raise FileNotFoundError(self.path)
        self.measurand = Measurand(self._to_device(arr), self.std)
        return self

    def load_std_image(self, std_data: Optional[Tensor] = None,
                       bit64: bool = True) -> "ImageSet":
        """Load '<name> STD.tif', falling back to the numerical noise model
        (image_set.py:228-243)."""
        arr = io.load_image(io.std_path_for(self.path), bit64=bit64,
                            max_dn=self.config.max_dn)
        std = self.calculate_numerical_std(std_data) if arr is None \
            else self._to_device(arr)
        if std is None:
            return self
        self.measurand = Measurand(self.val, std)
        return self

    def release(self) -> None:
        """Drop the payload (reference sets .val/.std = None)."""
        self.measurand = None

    # --- metadata-driven lookup ----------------------------------------
    def is_exposure_match(self, other: "ImageSet") -> bool:
        return io.is_exposure_match(self.features, other.features)

    def get_file_path_without_exposure(self) -> Optional[Path]:
        if self.path is None:
            return None
        return io.path_without_exposure(self.path, self.features)

    def get_flat_field(self, list_of_flat_fields: Optional[List["ImageSet"]]
                       = None) -> Optional["ImageSet"]:
        """Match a flat field by illumination + magnification
        (image_set.py:146-155)."""
        if list_of_flat_fields is None:
            if self.config.default_flat_path is None:
                return None
            list_of_flat_fields = ImageSet.multiple_from_path(
                self.config.default_flat_path, config=self.config,
                device=self.device)
        for flat in list_of_flat_fields:
            if (self.features["illumination"] == flat.features["illumination"]
                    and self.features["magnification"]
                    == flat.features["magnification"]):
                return flat
        return None

    def get_dark_field(self, list_of_dark_fields: Optional[List["ImageSet"]]
                       = None) -> Optional["ImageSet"]:
        """Exact-exposure dark frame, or nearest longer one scaled down
        (image_set.py:157-198).  As in the reference, an exposure below
        ``config.dark_threshold`` (in seconds) gets no dark frame."""
        if list_of_dark_fields is None:
            if self.config.default_dark_path is None:
                return None
            list_of_dark_fields = ImageSet.multiple_from_path(
                self.config.default_dark_path, config=self.config,
                device=self.device)

        target_exposure = self.features["exposure"]
        if target_exposure < self.config.dark_threshold:
            return None

        lesser_exp = False
        greater_exp = False
        greater_index = 0
        for i, dark in enumerate(list_of_dark_fields):
            if dark.features["exposure"] < target_exposure:
                lesser_exp = True
            if dark.features["exposure"] > target_exposure:
                greater_exp = True
                greater_index = i
            if dark.features["exposure"] == target_exposure:
                if dark.measurand is None:
                    dark.load_value_image()
                return dark
            if lesser_exp and greater_exp:
                greater_dark = list_of_dark_fields[greater_index]
                if greater_dark.measurand is None:
                    greater_dark.load_value_image()
                return greater_dark.scale_to_exposure(target_exposure)
        return None

    # --- transforms ----------------------------------------------------
    def linearize(self, icrf: Tensor,
                  icrf_diff: Optional[Tensor] = None) -> "ImageSet":
        """New ImageSet with LUT-linearized payload (image_set.py:102-115)."""
        return self._derived(self.measurand.linearize(
            icrf, icrf_diff, max_dn=self.config.max_dn))

    def extract(self, channels: Optional[Union[int, List[int]]] = None
                ) -> "ImageSet":
        return self._derived(self.measurand.extract(channels, axis=-1))

    def scale_to_exposure(self, target_exp: float) -> "ImageSet":
        """Scale payload linearly by exposure ratio (image_set.py:245-262)."""
        new_features = dict(self.features)
        new_features["exposure"] = target_exp
        return self._derived(
            (target_exp / self.features["exposure"]) * self.measurand,
            new_features)

    def bad_pixel_filter(self, dark_set: "ImageSet",
                         threshold_value: Optional[float] = None
                         ) -> "ImageSet":
        """Median-repair hot pixels flagged by a dark frame
        (image_set.py:387-400)."""
        if threshold_value is None:
            threshold_value = self.config.dark_threshold
        return self._derived(self.measurand.filter_larger_than_by_map(
            dark_set.measurand, threshold_value,
            self.config.median_filter_kernel_size))

    def flat_field_correction(self, flat_set: "ImageSet") -> "ImageSet":
        """Flat-field correction with uncertainty (image_set.py:402-421)."""
        if flat_set.measurand is None or flat_set.measurand.val is None:
            flat_set.load_value_image()
        if flat_set.measurand.std is None:
            flat_set.load_std_image()
        return self._derived(self.measurand.normalize_by_map(
            flat_set.measurand, self.config.flat_field_mid_percentage))

    def calculate_numerical_std(self, std_data: Optional[Tensor] = None
                                ) -> Optional[Tensor]:
        """Per-DN noise-model uncertainty via the STD LUT
        (image_set.py:365-385)."""
        if std_data is None:
            cfg = self.config
            if cfg.std_file_name is None or cfg.data_path is None:
                return None
            try:
                std_data = io.read_txt_to_array(cfg.std_file_name,
                                                cfg.data_path)
            except OSError:
                return None
        lut = self.measurand.linearize(self._to_device(std_data),
                                       max_dn=self.config.max_dn)
        return lut.val

    # --- persistence ---------------------------------------------------
    def save_64bit(self, save_path: Optional[Path] = None,
                   is_hdr: bool = False,
                   separate_channels: bool = False) -> None:
        """Save value (+std) as float64 tif (image_set.py:264-319)."""
        file_path = save_path if save_path is not None else \
            self.path.parent.joinpath("64bit", self.path.name)
        acq_suffix = " HDR.tif" if is_hdr else ".tif"
        std_suffix = " HDR STD.tif" if is_hdr else " STD.tif"
        base = str(file_path).removesuffix(".tif")
        val, std = _host(self.measurand.val), _host(self.measurand.std)
        if not separate_channels:
            io.save_image(base + acq_suffix, val)
            if std is not None:
                io.save_image(base + std_suffix, std)
            return
        for c in range(self.config.num_of_chs):
            name = f" {self.config.ch_names[c]}.tif"
            io.save_image(base + acq_suffix.replace(".tif", name),
                          val[:, :, c])
            if std is not None:
                io.save_image(base + std_suffix.replace(".tif", name),
                              std[:, :, c])

    def save_8bit(self, save_path: Optional[Path] = None,
                  force_8_bit: bool = False) -> None:
        """Save quantized 8-bit tif (image_set.py:321-363); the std is
        saved as float64 unless ``force_8_bit``."""
        file_path = Path(save_path) if save_path is not None else \
            self.path.parent.joinpath("8bit", self.path.name)
        if file_path.suffix != ".tif":  # directory given, use own name
            file_path = file_path.joinpath(self.path.name)
        io.save_image(file_path, _host(self.measurand.val), as_8bit=True,
                      max_dn=self.config.max_dn)
        if self.measurand.std is not None:
            io.save_image(io.std_path_for(file_path),
                          _host(self.measurand.std), as_8bit=force_8_bit,
                          max_dn=self.config.max_dn)

    def show_image(self, block: bool = True) -> None:
        """Display the value image in an OpenCV window
        (image_set.py:423-435); needs cv2 and a display."""
        if self.measurand is None or self.measurand.val is None:
            raise ValueError("No image to show.")
        try:
            import cv2 as cv
        except ImportError as exc:
            raise ImportError("show_image needs OpenCV (cv2), which is not "
                              "installed; save_8bit or save_64bit write the "
                              "image instead") from exc
        cv.namedWindow(self.path.name, cv.WINDOW_NORMAL)
        cv.imshow(self.path.name, _host(self.measurand.val))
        if block:
            cv.waitKey(0)
            cv.destroyAllWindows()

    # --- static combinators --------------------------------------------
    @staticmethod
    def compute_difference(short_set: "ImageSet", long_set: "ImageSet"):
        """(absolute, relative) exposure-ratio-scaled difference
        (image_set.py:437-451)."""
        ratio = short_set.features["exposure"] / long_set.features["exposure"]
        abs_m, rel_m = Measurand.compute_difference(short_set.measurand,
                                                    long_set.measurand, ratio)
        return short_set._derived(abs_m), short_set._derived(rel_m)

    @staticmethod
    def exposure_interpolation(short_set: "ImageSet", long_set: "ImageSet",
                               exp: float) -> "ImageSet":
        """Linear interpolation between frames by exposure
        (image_set.py:453-480); the result keeps the short frame's
        features and has no path."""
        if not isinstance(exp, float):
            raise TypeError("Interpolation point has unsupported type.")
        exp0 = short_set.features["exposure"]
        exp1 = long_set.features["exposure"]
        if exp > exp1 or exp < exp0:
            raise ValueError(
                "Interpolation point is not between the reference values.")
        m = Measurand.interpolate(short_set.measurand, long_set.measurand,
                                  exp0, exp1, exp)
        return ImageSet(features=short_set.features, measurand=m,
                        config=short_set.config, device=short_set.device)

    @classmethod
    def multiple_from_path(cls, path: Union[str, Path],
                           config: CameraConfig = DEFAULT_CONFIG,
                           device: Optional[Union[str, torch.device]] = None
                           ) -> List["ImageSet"]:
        """ImageSets for every non-STD tif in a directory, unloaded
        (image_set.py:482-501), on ``device`` (by default the card)."""
        device = resolve_device(device)
        return [cls(file_path=p, config=config, device=device)
                for p in io.list_image_paths(path)]


def calibrate_flats(config: CameraConfig = DEFAULT_CONFIG,
                    dark_path: Optional[Path] = None,
                    flat_path: Optional[Path] = None,
                    out_path: Optional[Path] = None,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> List[ImageSet]:
    """Bias-subtract flat frames: bias = shortest dark (image_set.py:504-521),
    on ``device`` (by default the card)."""
    dark_path = dark_path or config.default_dark_path
    flat_path = flat_path or config.uncalibrated_flat_path
    out_path = out_path or config.default_flat_path
    darks = ImageSet.multiple_from_path(dark_path, config=config,
                                        device=device)
    darks.sort(key=lambda s: s.features["exposure"])
    flats = ImageSet.multiple_from_path(flat_path, config=config,
                                        device=device)
    bias = darks[0]
    bias.load_value_image()
    bias.load_std_image()
    out = []
    for flat in flats:
        flat.load_value_image()
        flat.load_std_image()
        flat.measurand = flat.measurand - bias.measurand
        flat.save_8bit(Path(out_path))
        out.append(flat)
    return out


def calibrate_dark_frames(config: CameraConfig = DEFAULT_CONFIG,
                          in_path: Optional[Path] = None,
                          out_path: Optional[Path] = None,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> List[ImageSet]:
    """Bias-subtract dark frames (image_set.py:524-539), on ``device`` (by
    default the card).  The bias is the shortest dark itself: at its own
    turn it becomes its difference from itself, and the later darks
    subtract that difference, as in the JAX package."""
    in_path = in_path or config.uncalibrated_dark_path
    out_path = out_path or config.default_dark_path
    darks = ImageSet.multiple_from_path(in_path, config=config,
                                        device=device)
    darks.sort(key=lambda s: s.features["exposure"])
    bias = darks[0]
    bias.load_value_image()
    bias.load_std_image()
    out = []
    for dark in darks:
        dark.load_value_image()
        dark.load_std_image()
        dark.measurand = dark.measurand - bias.measurand
        dark.save_8bit(Path(out_path))
        out.append(dark)
    return out
