"""Host-side file IO: filename grammar, txt tables, ICRF files, tif loading.

The framework-free parts of ``camera_linearity_tpu/utils/io.py``, copied
(importing the JAX package would import JAX).  Filename grammar (reference
image_set.py docstring / :542-568): a name like ``'5ms BF sample 50x.tif'``
carries exposure, illumination, subject and magnification as space-separated
descriptors; uncertainty images carry an extra ``STD`` descriptor.

The image codec (OpenCV, else imageio) is imported inside :func:`_imread`,
only when a file is read: machines that merge in-memory stacks need neither.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "features_from_file_name", "path_without_exposure", "is_exposure_match",
    "load_image", "std_path_for", "read_txt_to_array", "read_icrf_file",
    "list_image_paths",
]


# ---------------------------------------------------------------------------
# filename grammar
# ---------------------------------------------------------------------------

def features_from_file_name(file_path: Path | str) -> Dict:
    """Parse feature descriptors out of an image file name
    (image_set.py:542-568)."""
    file_path = Path(file_path)
    features: Dict = {"illumination": "", "magnification": "",
                      "exposure": 0.0, "subject": ""}
    for element in file_path.name.removesuffix(".tif").split():
        low = element.casefold()
        if low in ("bf", "df"):
            features["illumination"] = element
        elif re.match(r"^[0-9]+.*[xX]$", element):
            features["magnification"] = element
        elif re.match(r"^[0-9]+.*ms$", element):
            features["exposure"] = float(element.removesuffix("ms")) / 1000
        else:
            features["subject"] = element
    return features


def path_without_exposure(path: Path, features: Dict) -> Path:
    """Merged-image path from features (image_set.py:117-121)."""
    return path.parent.joinpath(
        f"{features['subject']} {features['illumination']} "
        f"{features['magnification']}.tif")


def is_exposure_match(features_a: Optional[Dict],
                      features_b: Optional[Dict]) -> bool:
    """All features equal except exposure (image_set.py:123-144)."""
    if features_a is None or features_b is None:
        return False
    for key in features_a:
        if key == "exposure":
            continue
        if features_a[key] != features_b.get(key):
            return False
    return True


def std_path_for(path: Path | str) -> Path:
    """'<name>.tif' -> '<name> STD.tif' (image_set.py:235)."""
    return Path(str(path).removesuffix(".tif") + " STD.tif")


def list_image_paths(path: Path | str) -> List[Path]:
    """All non-STD .tif files in a directory (image_set.py:482-501)."""
    return sorted(p for p in Path(path).glob("*.tif") if "STD" not in p.name)


# ---------------------------------------------------------------------------
# image codec (imported on first read)
# ---------------------------------------------------------------------------

def _imread(path: str, unchanged: bool) -> Optional[np.ndarray]:
    try:  # OpenCV is the reference's codec; fall back to imageio if absent.
        import cv2 as cv
    except ImportError:
        import imageio.v3 as iio
        try:
            return iio.imread(path)
        except FileNotFoundError:
            return None
    flags = cv.IMREAD_UNCHANGED if unchanged else cv.IMREAD_COLOR
    return cv.imread(path, flags)


def load_image(path: Path | str, bit64: bool = False,
               max_dn: int = 255, dtype=np.float64) -> Optional[np.ndarray]:
    """Load a tif: 8-bit images normalize to [0,1] floats, ``bit64`` loads
    raw float data unchanged (image_set.py:214-226)."""
    arr = _imread(str(path), unchanged=bit64)
    if arr is None:
        return None
    if bit64:
        return arr
    return arr.astype(dtype) / max_dn


# ---------------------------------------------------------------------------
# txt tables
# ---------------------------------------------------------------------------

def read_txt_to_array(file_name: str | Path,
                      path: Optional[str | Path] = None) -> np.ndarray:
    """Load a whitespace txt table (general_functions.py:280-302)."""
    load_path = Path(path).joinpath(str(file_name)) if path is not None \
        else Path(file_name)
    return np.loadtxt(load_path, dtype=float)


def save_txt(file_path: str | Path, arr: np.ndarray) -> None:
    Path(file_path).parent.mkdir(parents=True, exist_ok=True)
    np.savetxt(file_path, np.asarray(arr))


def read_icrf_file(file_path: str | Path, bits: int,
                   return_derivative: bool = True
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read an ICRF txt and compute its derivative.

    Fixes the reference bug where the ICRF itself was returned as its own
    derivative (general_functions.py:275); spacing convention dx=2/(bits-1)
    kept for parity (general_functions.py:270).
    """
    icrf = np.loadtxt(file_path, dtype=float)
    if not return_derivative:
        return icrf, None
    dx = 2.0 / (bits - 1)
    icrf_diff = np.gradient(icrf, dx, axis=0)
    return icrf, icrf_diff
