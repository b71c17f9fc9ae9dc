"""Host-side file IO: filename grammar, txt tables, ICRF files, tif loading.

The framework-free parts of ``camera_linearity_tpu/utils/io.py``, copied
(importing the JAX package would import JAX).  Filename grammar (reference
image_set.py docstring / :542-568): a name like ``'5ms BF sample 50x.tif'``
carries exposure, illumination, subject and magnification as space-separated
descriptors; uncertainty images carry an extra ``STD`` descriptor.

TIFFs go through the port's own codec (``utils/tiff.py``), which returns
what OpenCV returns for them, so the card's machine, which has no OpenCV,
reads and writes captures.  Other formats need OpenCV, imported where a
file of another format is read or written.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import tiff

__all__ = [
    "features_from_file_name", "path_without_exposure", "is_exposure_match",
    "load_image", "save_image", "std_path_for", "read_txt_to_array",
    "save_txt", "read_icrf_file", "list_image_paths",
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
# image codecs
# ---------------------------------------------------------------------------

def _is_tiff(path: str) -> bool:
    return Path(path).suffix.lower() in (".tif", ".tiff")


def _cv2(path: str):
    try:
        import cv2
    except ImportError as exc:
        raise ImportError(f"{path}: formats other than TIFF need OpenCV "
                          "(cv2), which is not installed") from exc
    return cv2


def _imread(path: str, unchanged: bool) -> Optional[np.ndarray]:
    """``cv2.imread`` with IMREAD_UNCHANGED or IMREAD_COLOR (the JAX
    package's flags); None for a missing file."""
    if _is_tiff(path):
        return tiff.imread(path, tiff.IMREAD_UNCHANGED if unchanged
                           else tiff.IMREAD_COLOR)
    cv = _cv2(path)
    return cv.imread(path, cv.IMREAD_UNCHANGED if unchanged
                     else cv.IMREAD_COLOR)


def _imwrite(path: str, arr: np.ndarray) -> None:
    if _is_tiff(path):
        tiff.imwrite(path, arr)
    elif not _cv2(path).imwrite(path, arr):
        raise ValueError(f"cv2 could not write {path}")


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


def save_image(path: Path | str, arr: np.ndarray, as_8bit: bool = False,
               max_dn: int = 255) -> None:
    """Save float data as 64-bit tif, or quantized 8-bit
    (image_set.py:264-363).  8-bit saving rescales >1 data to [0,1] first."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if as_8bit:
        arr = np.asarray(arr, dtype=np.float64).copy()
        peak = np.amax(arr) if arr.size else 0.0
        if peak > 1:
            arr /= peak
        arr = np.around(arr * max_dn).astype(np.uint8)
        _imwrite(str(path), arr)
    else:
        _imwrite(str(path), np.asarray(arr, dtype=np.float64))


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
