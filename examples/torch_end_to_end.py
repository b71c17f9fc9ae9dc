"""End-to-end walkthrough through the PyTorch port: synthetic captures ->
calibration -> HDR -> linearity.

The port's counterpart of ``examples/end_to_end.py``.  It writes a
synthetic exposure series of a gamma-encoded scene as 8-bit TIFFs (the
port's own codec), solves the inverse camera response function with the
differential-evolution solver, merges the series into an
uncertainty-tracked HDR radiance map (on CUDA, one launch of the fused
merge kernel) and runs the pairwise linearity analysis.  Everything runs
on ``--device`` (default ``cuda``, which raises without a card; ``cpu`` on
request).

Usage: python examples/torch_end_to_end.py [outdir] [--device cpu]
       [--size 64] [--maxiter 150]
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from camera_linearity_tpu_torch import CameraConfig  # noqa: E402
from camera_linearity_tpu_torch.models import calibration as cal  # noqa
from camera_linearity_tpu_torch.models.exposure_series import \
    ExposureSeries  # noqa: E402
from camera_linearity_tpu_torch.models.image_set import ImageSet  # noqa
from camera_linearity_tpu_torch.ops.linearize import icrf_derivative  # noqa
from camera_linearity_tpu_torch.utils.device import resolve_device  # noqa


def make_captures(outdir: Path, device, gamma: float = 2.2, size: int = 64,
                  exposures_ms=(4, 8, 16), seed: int = 0):
    """Write a synthetic exposure series: radiance * t, gamma-encoded."""
    rng = np.random.default_rng(seed)
    outdir.mkdir(parents=True, exist_ok=True)
    radiance = rng.uniform(0.05, 0.55, (size, size, 3))
    for ms in exposures_ms:
        linear = np.clip(radiance * (ms / max(exposures_ms)), 0, 1)
        encoded = linear ** (1 / gamma)          # camera response
        std = rng.uniform(0.002, 0.006, (size, size, 3))
        path = outdir / f"{ms}ms BF scene 50x.tif"
        ImageSet(path, value=torch.as_tensor(encoded, device=device),
                 std=torch.as_tensor(std, device=device),
                 device=device).save_8bit(path)
    return radiance


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir", nargs="?", type=Path)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    ap.add_argument("--size", type=int, default=64,
                    help="captures are size x size x 3")
    ap.add_argument("--maxiter", type=int, default=150,
                    help="differential-evolution generations")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    outdir = args.outdir or Path(tempfile.mkdtemp(prefix="clt_demo_"))
    cfg = CameraConfig(num_of_chs=3, datapoints=256)
    gamma = 2.2
    make_captures(outdir / "captures", dev, gamma=gamma, size=args.size)

    # --- 1. load the series ------------------------------------------------
    series = ExposureSeries.from_dir_path(outdir / "captures", config=cfg,
                                          device=dev)[0]
    series.load_value_images()
    series.load_std_images()
    print(f"loaded {len(series.input_image_sets)} exposures on {dev}")

    # --- 2. solve the ICRF (PCA basis around a power-law family) -----------
    x = np.linspace(0, 1, 256)
    curves = np.stack([x ** g for g in np.linspace(1.4, 3.2, 25)])
    mean_icrf = curves.mean(axis=0)
    _, _, vt = np.linalg.svd(curves - mean_icrf, full_matrices=False)
    pca = vt[:5].T

    stack = torch.stack([torch.round(s.measurand.val * 255).to(torch.int32)
                         for s in series.input_image_sets])  # (N, H, W, C)
    stacks = stack.permute(3, 1, 2, 0).reshape(3, -1, stack.shape[0])
    exp = torch.as_tensor([s.features["exposure"]
                           for s in series.input_image_sets], device=dev)
    icrf_solved, e0, e1, _ = cal.calibration(
        -1.0, 1.0,
        channel_stacks=(stacks, None, exp),
        pca_arrays=np.stack([pca] * 3),
        mean_icrf_arrays=np.stack([mean_icrf] * 3),
        config=cfg, popsize=12, maxiter=args.maxiter, tol=0.01, rng_seed=3,
        device=dev)
    true_icrf = x ** gamma
    err = float(np.abs(icrf_solved - true_icrf[:, None]).mean())
    print(f"ICRF solved: energy {[round(float(e), 4) for e in e1]}, "
          f"mean |solved - x^{gamma}| = {err:.4f}")

    # --- 3. merge the stack into an HDR radiance map -----------------------
    icrf_t = torch.as_tensor(icrf_solved, device=dev)
    hdr = series.process_HDR_image(ICRF=icrf_t,
                                   ICRF_diff=icrf_derivative(icrf_t,
                                                             cfg.bits),
                                   use_std=True, apply_flat_field=False)
    hdr.save_64bit(outdir / "hdr.tif")
    print(f"HDR merged: val {tuple(hdr.measurand.val.shape)}, "
          f"std tracked: {hdr.measurand.std is not None} -> "
          f"{outdir / 'hdr.tif'}")

    # --- 4. linearity analysis across exposure pairs -----------------------
    # linearize() returns a NEW series, as the JAX package's does
    lin = series.linearize(icrf_t)
    lin.initialize_exposure_pairs()
    lin.process_linearity(ICRF=icrf_t, use_std=True)
    abs_stats, rel_stats = lin.collect_exposure_pair_stats()
    rel_means = np.asarray(rel_stats["means"])
    print("pairwise relative-difference means per channel:",
          np.round(rel_means, 4).tolist())
    if not np.abs(rel_means).max() < 0.05:
        raise SystemExit("synthetic scene is ideally linear; large pairwise "
                         "differences mean the linearization went wrong")
    print(f"done — artifacts in {outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
