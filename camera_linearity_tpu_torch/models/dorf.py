"""DoRF database import: CRF parsing, inversion, mean curves, PCA basis.

Port of ``camera_linearity_tpu/models/dorf.py``.  Builds the PCA
parameterization of ICRF space from the DoRF ``dorfCurves.txt`` database
(reference: modules/DoRF_data_import.py).  Parsing, inversion and the mean
stay on the host in NumPy, copied; the covariance and the PCA are torch
tensors.  The PCA step reproduces the reference's use of sklearn (fit on
the covariance matrix, transform it, unit-normalize and zero-anchor each
component, DoRF_data_import.py:143-162) via an SVD with sklearn's
deterministic sign convention (svd_flip).
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import CameraConfig, DEFAULT_CONFIG
from ..utils import io

Tensor = torch.Tensor

__all__ = [
    "read_dorf_data", "invert_and_interpolate", "mean_curve",
    "covariance_matrix", "principal_components", "process_CRF_data",
    "analyze_principal_components",
]


def read_dorf_data(file_path: Path, include_gamma: bool = False,
                   color_split: bool = True,
                   dorf_datapoints: int = 1024) -> List[np.ndarray]:
    """Parse dorfCurves.txt 6-line records into per-channel CRF arrays
    (DoRF_data_import.py:14-83).

    Records whose name line ends in red/green/blue (or r/g/b markers) are
    classified to that channel; unclassified curves join every channel when
    ``include_gamma`` (or always when not ``color_split``).  Returns
    [blue, green, red] stacks.
    """
    red, green, blue = [], [], []
    is_red = is_green = is_blue = False
    with open(file_path) as f:
        for line_no, line in enumerate(f, start=1):
            text = line.rstrip().casefold()
            if (line_no + 5) % 6 == 0:  # curve-name line
                if text.endswith("red") or (len(text) >= 2 and
                                            ("r" in text[-2:])):
                    is_red, is_green, is_blue = True, False, False
                elif text.endswith("green") or (len(text) >= 2 and
                                                ("g" in text[-2:])):
                    is_red, is_green, is_blue = False, True, False
                elif text.endswith("blue") or (len(text) >= 2 and
                                               ("b" in text[-2:])):
                    is_red, is_green, is_blue = False, False, True
                elif include_gamma:
                    is_red = is_green = is_blue = True
                else:
                    is_red = is_green = is_blue = False
            if not color_split:
                is_red = is_green = is_blue = True
            if line_no % 6 == 0:  # response-value line
                arr = np.fromstring(text, dtype=float, sep=" ")
                if arr.size != dorf_datapoints:
                    continue
                if is_red:
                    red.append(arr)
                    is_red = False
                if is_green:
                    green.append(arr)
                    is_green = False
                if is_blue:
                    blue.append(arr)
                    is_blue = False
    empty = np.zeros((0, dorf_datapoints))
    return [np.vstack(blue) if blue else empty,
            np.vstack(green) if green else empty,
            np.vstack(red) if red else empty]


def invert_and_interpolate(list_of_curves: List[np.ndarray],
                           new_datapoints: int,
                           dorf_datapoints: int = 1024) -> List[np.ndarray]:
    """CRF -> ICRF by swap-axis interpolation, regridded to
    ``new_datapoints`` (DoRF_data_import.py:86-121)."""
    x_old = np.linspace(0.0, 1.0, dorf_datapoints)
    x_new = np.linspace(0.0, 1.0, new_datapoints)
    out = []
    for arr in list_of_curves:
        rows = []
        for i in range(arr.shape[0]):
            y_inv = np.interp(x_old, arr[i], x_old)
            rows.append(np.interp(x_new, x_old, y_inv))
        out.append(np.vstack(rows) if rows
                   else np.zeros((0, new_datapoints)))
    return out


def mean_curve(curves: np.ndarray) -> np.ndarray:
    """Mean over the curve collection (DoRF_data_import.py:124-140)."""
    return np.mean(curves, axis=0)


def covariance_matrix(data_array, mean_data_array) -> Tensor:
    """centered^T @ centered (DoRF_data_import.py:165-185)."""
    centered = torch.as_tensor(data_array) - torch.as_tensor(mean_data_array)
    return centered.T @ centered


def principal_components(covariance, n_components: int) -> Tensor:
    """First ``n_components`` PCs of the covariance matrix, unit-normalized
    and zero-anchored (DoRF_data_import.py:143-162).

    Reproduces sklearn's PCA(fit+transform on the same matrix): column-center,
    SVD with svd_flip sign convention (largest-|u| component positive per
    column), project.
    """
    cov = torch.as_tensor(covariance)
    centered = cov - torch.mean(cov, dim=0)
    u, s, _ = torch.linalg.svd(centered, full_matrices=False)
    # sklearn svd_flip: sign from the max-|u| entry of each column of u.
    max_rows = torch.argmax(torch.abs(u), dim=0)
    signs = torch.sign(u[max_rows, torch.arange(u.shape[1],
                                                device=u.device)])
    u = u * signs
    transformed = u[:, :n_components] * s[:n_components]
    norms = torch.linalg.norm(transformed, dim=0)
    result = transformed / norms
    return result - result[0]


def process_CRF_data(config: CameraConfig = DEFAULT_CONFIG,
                     include_gamma: bool = False, color_split: bool = True,
                     dorf_path: Optional[Path] = None,
                     save: bool = True
                     ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Parse + invert DoRF, save per-channel ICRF collections and mean
    curves (DoRF_data_import.py:209-228)."""
    cfg = config
    if dorf_path is None:
        dorf_path = Path(cfg.data_path).joinpath(cfg.dorf_file)
    curves = read_dorf_data(dorf_path, include_gamma, color_split,
                            cfg.dorf_datapoints)
    processed = invert_and_interpolate(curves, cfg.datapoints,
                                       cfg.dorf_datapoints)
    means = [mean_curve(p) for p in processed]
    if save:
        for i in range(len(cfg.icrf_files)):
            io.save_txt(Path(cfg.data_path).joinpath(cfg.icrf_files[i]),
                        processed[i])
            io.save_txt(Path(cfg.data_path).joinpath(cfg.mean_icrf_files[i]),
                        means[i])
    return processed, means


def analyze_principal_components(config: CameraConfig = DEFAULT_CONFIG,
                                 save: bool = True) -> List[np.ndarray]:
    """Covariance + PCA per channel, saving the bases
    (DoRF_data_import.py:188-206)."""
    cfg = config
    out = []
    for i in range(len(cfg.icrf_files)):
        # single-curve collections round-trip through savetxt as 1-D
        icrf = np.atleast_2d(io.read_txt_to_array(cfg.icrf_files[i],
                                                  cfg.data_path))
        mean = io.read_txt_to_array(cfg.mean_icrf_files[i], cfg.data_path)
        cov = covariance_matrix(icrf, mean)
        pca = principal_components(cov, cfg.num_of_pca_params).cpu().numpy()
        if save:
            io.save_txt(Path(cfg.data_path).joinpath(cfg.pca_files[i]), pca)
        out.append(pca)
    return out
