"""Video statistics walkthrough through the PyTorch port: Welford stacking
-> noise model -> HDR.

The port's counterpart of ``examples/video_pipeline.py``.  It writes short
synthetic exposure videos of a static noisy scene as lossless ``RGBA``
AVIs (with a small writer of its own: the port reads them with NumPy and
needs no cv2), computes exact mean/uncertainty frames with the streaming
Welford machinery, builds the sensor noise model (the per-DN std LUT from
noise-profile histograms, the reference's process_STD_data flow) and
merges the per-exposure statistics into one uncertainty-tracked HDR
radiance map (``pipeline.video_to_hdr``; on CUDA, one launch of the
repair-and-merge kernel).  Everything runs on ``--device`` (default
``cuda``, which raises without a card; ``cpu`` on request).

Usage: python examples/torch_video_pipeline.py [outdir] [--device cpu]
       [--frames 40] [--size 48 64]
"""
import argparse
import struct
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from camera_linearity_tpu_torch.models import pipeline  # noqa: E402
from camera_linearity_tpu_torch.models import video as video_mod  # noqa
from camera_linearity_tpu_torch.utils.device import resolve_device  # noqa


def write_rgba_avi(path: Path, frames_bgr: np.ndarray) -> None:
    """An AVI of uint8 BGR frames as ``cv2.VideoWriter_fourcc(*"RGBA")``
    lays one out: one video stream, one movi LIST of ``00dc`` chunks of
    R, G, B, A bytes, top-down; no index."""
    n, h, w = frames_bgr.shape[:3]
    size = h * w * 4

    def chunk(fourcc, payload):
        return struct.pack("<4sI", fourcc, len(payload)) + payload
    avih = struct.pack("<14I", 100000, size * 10, 0, 0x10, n, 0, 1, size, w,
                       h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIII4h", b"vids", b"RGBA", 0, 0, 0, 0, 1,
                       10, 0, n, size, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 32, b"RGBA", size, 0, 0,
                       0, 0)
    hdrl = chunk(b"LIST", b"hdrl" + chunk(b"avih", avih) + chunk(
        b"LIST", b"strl" + chunk(b"strh", strh) + chunk(b"strf", strf)))
    rgba = np.concatenate([frames_bgr[..., ::-1],
                           np.full((n, h, w, 1), 255, np.uint8)], -1)
    movi = b"movi" + b"".join(chunk(b"00dc", f.tobytes()) for f in rgba)
    path.write_bytes(struct.pack("<4sI4s", b"RIFF", 4 + len(hdrl) + 8
                                 + len(movi), b"AVI ") + hdrl
                     + chunk(b"LIST", movi))


def make_videos(outdir: Path, exposures_ms=(4, 8, 16), frames: int = 40,
                size=(48, 64), noise: float = 5.0, seed: int = 0):
    outdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    h, w = size
    base = rng.uniform(0.1, 0.7, (h, w, 3))
    paths = []
    for ms in exposures_ms:
        level = np.clip(base * (ms / max(exposures_ms)), 0, 1) * 255
        u8 = np.around(np.clip(level + rng.normal(0, noise, (frames, h, w, 3)),
                               0, 255)).astype(np.uint8)
        paths.append(outdir / f"scene {ms}ms.avi")
        write_rgba_avi(paths[-1], u8)
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("outdir", nargs="?", type=Path)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--size", type=int, nargs=2, default=(48, 64),
                    metavar=("H", "W"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    outdir = args.outdir or Path(tempfile.mkdtemp(prefix="clt_video_demo_"))
    paths = make_videos(outdir, frames=args.frames, size=tuple(args.size))

    # --- 1. streaming statistics of one video --------------------------
    stats = video_mod.welford_algorithm(paths[-1], None, use_std=True,
                                        dtype=np.float32, device=dev)
    print(f"welford: mean {stats['mean'].shape} "
          f"std-of-mean {stats['std'].shape} "
          f"(exact over {args.frames} frames)")

    # --- 2. sensor noise model from the frame stream -------------------
    profiles, _ = video_mod.compute_noise_profiles([paths[-1]], device=dev)
    counts = int(np.asarray(profiles).sum())
    std_lut = torch.stack([
        video_mod.calculate_std(np.asarray(profiles[..., c]), device=dev)
        for c in range(3)], dim=1).cpu().numpy()
    print(f"noise profiles: {counts} samples -> per-DN std LUT "
          f"{std_lut.shape}, peak std {std_lut.max():.4f} DN-scale")

    # --- 3. exposure videos -> uncertainty-tracked HDR -----------------
    icrf = np.linspace(0, 1, 256)[:, None].repeat(3, 1)  # identity camera
    hdr = pipeline.video_to_hdr(paths, torch.as_tensor(icrf, device=dev),
                                device=dev)
    val = hdr.measurand.val.cpu().numpy()
    std = hdr.measurand.std.cpu().numpy()
    print(f"HDR from video on {dev}: val {val.shape}, median "
          f"rel-uncertainty {np.median(std / np.maximum(val, 1e-9)):.4f}")
    hdr.save_64bit(outdir / "video_hdr.tif")
    print(f"done — artifacts in {outdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
