"""Decode time of one 4K MJPG frame: the port's decoder against the JAX
package's libjpeg-turbo decoder, on this machine's CPU.

    python -m tests._torch_jpeg_rate [--quality 25] [--runs 5]

The frame is ``chip_smoke.py``'s config-5 content (a uniform base x 230
plus N(0, 6) noise, seeded; NumPy here), encoded by
``tests/_torch_mjpeg_writer.py`` as cv2's MJPG writer lays it out.  It
prints the frame's bytes, then the median ms of one frame on one thread
for each decoder and mode (the port's three, libjpeg-turbo's two), and the
port's ms a frame over a batch of 12 on every core; then the same for
the other frame modes of the ``ffmpeg`` mode (grayscale, the frame's
green channel; 4:1:1; 4:4:0; progressive 4:2:0).  Where the JAX
package's decoder did not build (no libjpeg headers), its lines are left
out.  Test tooling: a host-CPU measurement,
not a device one.
"""
import argparse
import os
import time

import numpy as np

from camera_linearity_tpu_torch import native
from tests._torch_mjpeg_writer import encode_jpeg

H, W = 2160, 3840


def median_ms(fn, runs: int) -> float:
    fn()  # warm
    samples = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quality", type=int, default=25)
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    rng = np.random.default_rng(42)
    frame = np.clip(rng.random((H, W, 3)) * 230
                    + rng.normal(0, 6, (H, W, 3)), 0, 255).astype(np.uint8)
    data = encode_jpeg(frame, args.quality)
    print(f"one {H} x {W} frame, quality {args.quality}: "
          f"{len(data) / 1e6:.3f} MB; {os.cpu_count()} CPUs")
    decoders = {"jpeg.cpp": native.jpeg_decode_bgr}
    from camera_linearity_tpu import native as jnative
    if jnative.mjpeg_available():
        decoders["libjpeg-turbo (JAX package)"] = jnative.jpeg_decode_bgr
    dst = np.empty((H, W, 3), np.uint8)
    for mode in native.JPEG_MODES:
        for name, decode in decoders.items():
            if name != "jpeg.cpp" and mode == "ffmpeg":
                continue  # libjpeg-turbo has the two turbo modes only
            ms = median_ms(lambda: decode(
                data, dst, **({"mode": mode} if name == "jpeg.cpp" else
                              {"fast": mode == "turbo_fast"})), args.runs)
            print(f"{mode}, {name}: {ms:.1f} ms on one thread")
        batch = np.empty((12, H, W, 3), np.uint8)
        ms = median_ms(lambda: native.jpeg_decode_bgr_batch(
            [data] * 12, batch, mode=mode), args.runs) / 12
        print(f"{mode}, jpeg.cpp: {ms:.1f} ms a frame over a batch of 12 on "
              f"{os.cpu_count()} threads")
    batch = np.empty((12, H, W, 3), np.uint8)
    for name, src, kwargs in (
            ("grayscale", np.ascontiguousarray(frame[..., 1]), {}),
            ("4:1:1", frame, {"sampling": "411"}),
            ("4:4:0", frame, {"sampling": "440"}),
            ("progressive 4:2:0", frame, {"progressive": True})):
        coded = encode_jpeg(src, args.quality, **kwargs)
        one = median_ms(lambda: native.jpeg_decode_bgr(coded, dst,
                                                       mode="ffmpeg"),
                        args.runs)
        many = median_ms(lambda: native.jpeg_decode_bgr_batch(
            [coded] * 12, batch, mode="ffmpeg"), args.runs) / 12
        print(f"ffmpeg {name} ({len(coded) / 1e6:.3f} MB), jpeg.cpp: "
              f"{one:.1f} ms on one thread, {many:.1f} ms a frame over a "
              f"batch of 12 on {os.cpu_count()} threads")


if __name__ == "__main__":
    main()
