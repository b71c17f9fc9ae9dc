"""Visualization of pipeline outputs (reference: modules/data_visualization.py).

Copied from ``camera_linearity_tpu/utils/visualization.py`` (importing the
JAX package would import JAX).  Host-side matplotlib rendering of noise
profiles, ICRF curves, image-channel panels, linearity statistics (with a
closed-form orthogonal/ODR line fit — scipy.odr is deprecated and removed
in SciPy 1.19), histograms and KDEs.  Figures save to files.  matplotlib
is imported inside each plotting function, with the Agg backend, never at
module import: the card's machine has no matplotlib, and
:func:`orthogonal_line_fit` needs only SciPy.  Tensors are accepted
wherever arrays are and are moved to the host first.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

from ..config import CameraConfig, DEFAULT_CONFIG

__all__ = [
    "plot_noise_profiles_3d", "plot_noise_profiles_2d", "plot_ICRF",
    "plot_image_set_channels_separately", "create_linearity_plots",
    "linearity_fits", "orthogonal_line_fit", "plot_histograms", "plot_kde",
]


def _plt():
    """matplotlib.pyplot on the headless Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _np(x) -> np.ndarray:
    """A host array of ``x`` (a tensor is moved off its device)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


# Channel-character -> matplotlib color for the reference's b/g/r names.
_COLOR = {"b": "tab:blue", "g": "tab:green", "r": "tab:red"}


def _color_for(config: CameraConfig, c: int) -> str:
    return _COLOR.get(config.ch_chars[c], f"C{c}")


def _normalize_rows_by_sum(arr: np.ndarray) -> np.ndarray:
    sums = arr.sum(axis=1, keepdims=True)
    sums[sums == 0] = 1
    return arr / sums


def plot_noise_profiles_3d(noise_data_array: np.ndarray,
                           file_name: Union[Path, str],
                           save_path: Union[Path, str],
                           config: CameraConfig = DEFAULT_CONFIG) -> None:
    """Per-channel 3-D surface of the noise profiles
    (data_visualization.py:14-58)."""
    plt = _plt()
    save_path, file_name = Path(save_path), Path(file_name)
    noise_data_array = _np(noise_data_array)
    for c in range(config.num_of_chs):
        channel = _normalize_rows_by_sum(
            noise_data_array[:, :, c].astype(float))
        x = np.linspace(0, 1, num=channel.shape[1])
        y = np.linspace(0, 1, num=channel.shape[0])
        X, Y = np.meshgrid(x, y)
        fig = plt.figure()
        ax = plt.axes(projection="3d")
        ax.plot_surface(X, Y, channel, rstride=4, cstride=4,
                        cmap="viridis", edgecolor="none")
        ax.view_init(45, -30)
        out = save_path.joinpath(
            f"{file_name.stem} {config.ch_names[c]}{file_name.suffix}")
        plt.savefig(out, dpi=150)
        plt.close(fig)


def plot_noise_profiles_2d(noise_data_array: np.ndarray,
                           number_of_profiles: int, lower_bound: int,
                           upper_bound: int, file_name: Union[Path, str],
                           save_path: Union[Path, str],
                           config: CameraConfig = DEFAULT_CONFIG) -> None:
    """Line plots of selected noise-profile rows
    (data_visualization.py:61-105)."""
    plt = _plt()
    save_path, file_name = Path(save_path), Path(file_name)
    noise_data_array = _np(noise_data_array)
    bound_diff = upper_bound - lower_bound
    row_step = 1 if number_of_profiles >= bound_diff else \
        int(bound_diff / number_of_profiles)
    sampled = noise_data_array[lower_bound:upper_bound:row_step, :, :]
    x_range = np.linspace(0, config.max_dn, sampled.shape[1])
    for c in range(config.num_of_chs):
        normalized = _normalize_rows_by_sum(sampled[:, :, c].astype(float))
        fig = plt.figure()
        for i in range(min(number_of_profiles, normalized.shape[0])):
            row = normalized[i, :]
            mode_index = int(np.argmax(row))
            plt.xlim(lower_bound, upper_bound)
            plt.plot(x_range, row)
            plt.vlines(x_range[mode_index], 0, row[mode_index])
        out = save_path.joinpath(
            f"{file_name.stem} {config.ch_names[c]}{file_name.suffix}")
        plt.savefig(out, dpi=150)
        plt.close(fig)


def plot_ICRF(icrf_array: np.ndarray, file_name: Union[Path, str],
              save_path: Union[Path, str],
              config: CameraConfig = DEFAULT_CONFIG) -> None:
    """All-channel ICRF plot (data_visualization.py:108-127)."""
    plt = _plt()
    save_path = Path(save_path)
    icrf_array = _np(icrf_array)
    fig = plt.figure()
    x_range = np.linspace(0, 1, icrf_array.shape[0])
    plt.ylabel("Normalized exposure X (arb. units)")
    plt.xlabel("Normalized brightness B (arb. units)")
    for c in range(config.num_of_chs):
        plt.plot(x_range, icrf_array[:, c], color=_color_for(config, c))
    plt.savefig(save_path.joinpath(str(file_name)), dpi=150)
    plt.close(fig)


def plot_image_set_channels_separately(image_set,
                                       title: str =
                                       "Pixel values (arb. units)",
                                       color_map: str = "inferno",
                                       use_std: bool = False,
                                       save_path: Optional[Path] = None,
                                       config: Optional[CameraConfig] = None
                                       ) -> Path:
    """Row of per-channel image panels with colorbars
    (data_visualization.py:142-171)."""
    plt = _plt()
    cfg = config or image_set.config
    fig, axes = plt.subplots(1, cfg.num_of_chs, figsize=(20, 5))
    if cfg.num_of_chs == 1:
        axes = [axes]
    image = _np(image_set.measurand.std if
                (use_std and image_set.measurand.std is not None)
                else image_set.measurand.val)
    for c, ax in enumerate(axes):
        panel = ax.imshow(image[:, :, c], cmap=color_map)
        fig.colorbar(panel, ax=ax)
        ax.set_axis_off()
        ax.set_title(f"{cfg.ch_names[c]} {title}", fontsize=14)
    fig.tight_layout(pad=1.2)
    if save_path is None:
        save_path = image_set.path.parent.joinpath(
            image_set.path.name.replace(".tif", ".png"))
    plt.savefig(save_path, dpi=150)
    plt.close(fig)
    return save_path


def _linear_function(beta, x):
    return beta[0] + beta[1] * x


def orthogonal_line_fit(x: np.ndarray, y: np.ndarray, sy: np.ndarray
                        ) -> Dict:
    """Weighted orthogonal (ODR) line fit ``y ≈ A + B·x``.

    Reproduces what the reference obtains from
    ``ODR(RealData(x, y, sy=sy), linear_model, beta0=[0, 0]).run()``
    (data_visualization.py:203-206) — unit x-weights, ``1/sy²``
    y-weights — WITHOUT the deprecated ``scipy.odr`` package (removed in
    SciPy 1.19).  For the 2-parameter line the ODR problem has an
    analytic core: eliminating the per-point x-offsets δᵢ (each is a
    scalar quadratic) profiles the objective to

        S(A, B) = Σᵢ (yᵢ − A − B·xᵢ)² / (syᵢ² + B²),

    A profiles out in closed form for fixed B, and the optimal B is the
    root of dS/dB (envelope theorem) — located by a slope-angle grid
    scan plus a machine-precision Brent root solve.  ``sd_beta`` follows
    ODRPACK's covariance construction: the (A, B) Schur complement of
    the augmented Gauss–Newton normal matrix,
    ``M = Σᵢ w̃ᵢ·[[1, uᵢ], [uᵢ, uᵢ²]]`` with ``w̃ᵢ = 1/(syᵢ²+B²)`` and
    ``uᵢ = xᵢ + δᵢ``, scaled by ``res_var = S/(n−2)``.

    Returns ``{"beta": (A, B), "sd_beta": (dA, dB)}`` — agreement with
    scipy.odr is pinned in tests/unit/test_visualization.py at
    ODRPACK's own convergence tolerance while that package still exists.
    """
    from scipy.optimize import brentq

    x = np.asarray(x, float)
    y = np.asarray(y, float)
    s2 = np.asarray(sy, float) ** 2
    n = x.size

    def a_of(b):
        w = 1.0 / (s2 + b * b)
        return float(np.sum(w * (y - b * x)) / np.sum(w))

    def d_s(b):
        # envelope theorem: ∂S/∂B at the profiled A — the dA/dB term
        # vanishes because A is optimal
        a = a_of(b)
        w = 1.0 / (s2 + b * b)
        r = y - a - b * x
        return float(np.sum(-2.0 * x * r * w - 2.0 * b * r * r * w * w))

    # coarse scan in slope-angle space (covers every slope uniformly,
    # unlike a B-grid) to bracket the global minimum
    theta = np.linspace(-np.pi / 2, np.pi / 2, 2049)[1:-1]
    bs = np.tan(theta)
    w = 1.0 / (s2[None, :] + (bs * bs)[:, None])
    a_grid = np.sum(w * (y[None, :] - bs[:, None] * x[None, :]),
                    axis=1) / np.sum(w, axis=1)
    r = y[None, :] - a_grid[:, None] - bs[:, None] * x[None, :]
    s_grid = np.sum(r * r * w, axis=1)
    k = int(np.argmin(s_grid))
    lo = bs[max(k - 1, 0)]
    hi = bs[min(k + 1, bs.size - 1)]
    # The optimum can sit BEYOND the grid's slope range (|B| > tan(pi/2 -
    # pi/2048) ~ 652, i.e. argmin on a grid edge): expand the bracket
    # geometrically until the derivative changes sign across it, so
    # near-vertical data still resolves instead of handing brentq /
    # minimize_scalar a bracket that excludes the minimum.
    for _ in range(80):
        if d_s(lo) < 0:
            break
        lo -= abs(lo) + 1.0
    for _ in range(80):
        if d_s(hi) > 0:
            break
        hi += abs(hi) + 1.0
    if d_s(lo) < 0 < d_s(hi):
        b_hat = brentq(d_s, lo, hi, xtol=1e-300, rtol=4 * np.finfo(float).eps,
                       maxiter=200)
    else:  # degenerate bracket (flat objective): bounded golden-section —
        # never scipy's default (0, 1) auto-bracket, which can crash or
        # land on the wrong local minimum for data far from unit slope
        from scipy.optimize import minimize_scalar
        b_hat = float(minimize_scalar(
            lambda b: np.sum((y - a_of(b) - b * x) ** 2 / (s2 + b * b)),
            bounds=(lo, hi), method="bounded",
            options={"xatol": 1e-14}).x)

    a_hat = a_of(b_hat)
    w = 1.0 / (s2 + b_hat * b_hat)
    resid = y - a_hat - b_hat * x
    s_min = float(np.sum(resid * resid * w))
    u = x + b_hat * resid * w  # xᵢ + δᵢ at the solution
    sw, swu, swuu = np.sum(w), np.sum(w * u), np.sum(w * u * u)
    det = sw * swuu - swu * swu
    res_var = s_min / max(n - 2, 1)
    sd_a = float(np.sqrt(swuu / det * res_var))
    sd_b = float(np.sqrt(sw / det * res_var))
    return {"beta": (float(a_hat), float(b_hat)), "sd_beta": (sd_a, sd_b)}


def linearity_fits(stats: Dict, config: CameraConfig = DEFAULT_CONFIG
                   ) -> Dict:
    """The per-channel ODR fits that :func:`create_linearity_plots` draws
    and returns, ``{ch_char: {"beta": (A, B), "sd_beta": (dA, dB)}}``
    (empty for fewer than 2 points); SciPy only, no matplotlib."""
    x = np.asarray(stats["ratios"])
    if len(x) < 2:
        return {}
    fits: Dict = {}
    for c in range(config.num_of_chs):
        y = np.asarray(stats["means"])[:, c]
        y_std = np.asarray(stats["stds"])[:, c]
        fits[config.ch_chars[c]] = orthogonal_line_fit(
            x, y, np.where(y_std == 0, 1e-12, y_std))
    return fits


def create_linearity_plots(stats: Dict, save_path: Path, fit_line: bool,
                           ylabel: str, symbol: str,
                           config: CameraConfig = DEFAULT_CONFIG) -> Dict:
    """Per-channel linearity scatter with uncertainty bars and an optional
    orthogonal (ODR) line fit (data_visualization.py:178-232).

    Returns the per-channel ODR fits of :func:`linearity_fits` (empty when
    ``fit_line`` is off or there are fewer than 2 points), so the fitted
    coefficients are data, not just title text; the fit itself is
    :func:`orthogonal_line_fit`, a closed-form replacement for the
    reference's scipy.odr call (removed in SciPy 1.19).  Intentional
    divergences from the reference renderer, as in the JAX package:
    matplotlib color comes from a name->color map instead of passing the
    channel NAME as the color (reference crashes on 'blue'≠valid for
    non-RGB configs), a 1-channel config gets a 1-element axes list
    (reference indexes axes[1] unconditionally), and a missing 'errors'
    entry skips the error bars instead of raising."""
    plt = _plt()
    x = np.asarray(stats["ratios"])
    fits = linearity_fits(stats, config) if fit_line else {}
    fig, axes = plt.subplots(1, config.num_of_chs, figsize=(20, 5))
    if config.num_of_chs == 1:
        axes = [axes]
    for c, ax in enumerate(axes):
        color = _color_for(config, c)
        cc = config.ch_chars[c]
        y = np.asarray(stats["means"])[:, c]
        y_std = np.asarray(stats["stds"])[:, c]
        y_err = None if stats.get("errors") is None else \
            np.asarray(stats["errors"])[:, c]

        if cc in fits:
            beta, sd_beta = fits[cc]["beta"], fits[cc]["sd_beta"]
            ax.plot(x, _linear_function(beta, x), c="black")
            ax.set_title(
                f"{cc}: A={beta[0]:.4f} $\\pm$ {sd_beta[0]:.4f}, "
                f"B={beta[1]:.4f} $\\pm$ {sd_beta[1]:.4f}", fontsize=12)

        ax.errorbar(x, y, yerr=(y_std / 5), elinewidth=1, c=color,
                    marker=None, linestyle="none", markersize=3, alpha=0.5,
                    label=f"$\\sigma_{{{cc}, {symbol}}}$")
        if y_err is not None:
            ax.errorbar(x, y, yerr=y_err, elinewidth=1, c="0", marker="x",
                        linestyle="none", markersize=3, alpha=1,
                        label=f"$\\delta {symbol}_{cc}$")
        ax.legend(loc="best")
    axes[0].set(ylabel=ylabel)
    axes[min(1, len(axes) - 1)].set(
        xlabel=r"Exposure time ratio $t_s/t_l$")
    plt.savefig(save_path, dpi=150)
    plt.close(fig)
    return fits


def plot_histograms(histogram_dictionary: Dict, save_path: Path,
                    file_name: str,
                    config: CameraConfig = DEFAULT_CONFIG) -> None:
    """Bar plots of per-channel histograms (data_visualization.py:235-254).
    """
    plt = _plt()
    for channel_key, (hist, bin_edges) in histogram_dictionary.items():
        hist = np.asarray(hist, float)
        bin_edges = np.asarray(bin_edges)
        total = hist.sum()
        if total:
            hist = hist / total
        width = float(abs(bin_edges[1] - bin_edges[0]))
        fig = plt.figure()
        plt.bar(bin_edges[:-1], hist, width=width,
                fc=_color_for(config, channel_key), ec=None)
        plt.savefig(Path(save_path).joinpath(
            f"{file_name} {config.ch_names[channel_key]}.png"), dpi=150)
        plt.close(fig)


def plot_kde(kde_dictionary: Dict, save_path: Path, file_name: str,
             config: CameraConfig = DEFAULT_CONFIG) -> None:
    """Line plots of per-channel KDEs (data_visualization.py:257-277)."""
    plt = _plt()
    for channel_key, (kde, x_range) in kde_dictionary.items():
        kde = np.asarray(kde, float)
        total = kde.sum()
        if total:
            kde = kde / total
        fig = plt.figure()
        plt.plot(np.asarray(x_range), kde,
                 c=_color_for(config, channel_key), label="KDE", linewidth=3)
        plt.legend(loc="best")
        plt.savefig(Path(save_path).joinpath(
            f"{file_name} {config.ch_names[channel_key]}.png"), dpi=150)
        plt.close(fig)
