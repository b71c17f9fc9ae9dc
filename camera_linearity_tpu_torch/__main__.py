"""Command-line interface of the PyTorch / CUDA port: the JAX package's
commands and arguments (``camera_linearity_tpu/__main__.py``).

    python -m camera_linearity_tpu_torch merge     --images DIR --icrf FILE
    python -m camera_linearity_tpu_torch linearity --images DIR [--icrf FILE]
    python -m camera_linearity_tpu_torch calibrate --images DIR --out FILE
    python -m camera_linearity_tpu_torch video     --videos DIR
    python -m camera_linearity_tpu_torch dorf      --data DIR
    python -m camera_linearity_tpu_torch doctor    [--video FILE]

All commands take --config pointing at a reference-format config.ini, and
--device (default cuda: without a card the commands raise; --device cpu
runs them on the CPU).  TIFFs are read and written by the port's own codec
(utils/tiff.py), so no OpenCV is needed.  --coordinator, --num-processes
and --process-id (or CL_COORDINATOR_ADDRESS, CL_NUM_PROCESSES,
CL_PROCESS_ID and CL_LOCAL_DEVICE_IDS) join a multi-process run
(parallel/distributed.py): NCCL on the card, gloo with --device cpu.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

def _load_config(args):
    from .config import CameraConfig
    if args.config:
        return CameraConfig.from_ini(args.config)
    return CameraConfig()


def _device(args):
    from .utils.device import resolve_device
    return resolve_device(args.device)


def _tensor(arr, dev):
    import torch
    from .utils.device import canonical_float
    return torch.as_tensor(arr, dtype=canonical_float(dev), device=dev)


def _load_icrf(path, cfg, dev):
    from .utils import io
    icrf, icrf_diff = io.read_icrf_file(path, cfg.bits)
    return _tensor(icrf, dev), _tensor(icrf_diff, dev)


def _base_path(icrf_path) -> Path:
    p = Path(icrf_path)
    return p.with_name(p.stem + "_base" + p.suffix)


def _load_icrf_base(path, dev):
    """The datapoints-resolution solved curve saved alongside the ICRF by
    ``calibrate`` (``<name>_base.txt``), if present: with it the merge
    takes the interpolant kernel at >8-bit depths.  The uncertainty
    derivative is the interpolant of the base gradient (spacing
    2/(n-1))."""
    from .utils import io
    bp = _base_path(path)
    if not bp.exists():
        return None, None
    base = io.read_txt_to_array(bp)
    diff_base = np.gradient(base, 2.0 / (base.shape[0] - 1), axis=0)
    return _tensor(base, dev), _tensor(diff_base, dev)


def _loaded_frames(path, cfg, dev, with_std: bool):
    """Every ImageSet of a calibration-frame directory, loaded; None when
    the config names no such directory."""
    from .models.image_set import ImageSet
    if path is None:
        return None
    sets = ImageSet.multiple_from_path(path, config=cfg, device=dev)
    for s in sets:
        s.load_value_image()
        if with_std:
            s.load_std_image()
    return sets


def cmd_merge(args) -> int:
    """Merge every exposure series of a directory.  Stage times (read,
    merge, write) accumulate in ``utils.observability.stage_times``; the
    dark and flat frames the config names are read once, up front."""
    from .models.exposure_series import ExposureSeries
    from .utils.observability import get_logger, stage, timed
    log = get_logger()
    cfg = _load_config(args)
    dev = _device(args)
    with stage("read_s"):
        icrf, icrf_diff = _load_icrf(args.icrf, cfg, dev)
        base, diff_base = _load_icrf_base(args.icrf, dev)
        darks = _loaded_frames(cfg.default_dark_path, cfg, dev, False)
        flats = None if args.no_flat else \
            _loaded_frames(cfg.default_flat_path, cfg, dev, True)
    if base is not None:
        log.info("using base curves from %s", _base_path(args.icrf).name)
    series_list = ExposureSeries.from_dir_path(Path(args.images), config=cfg,
                                               device=dev)
    log.info("found %d exposure series", len(series_list))
    for series in series_list:
        first = series.input_image_sets[0]
        with stage("read_s"):
            series.load_value_images()
            if args.std:
                series.load_std_images()
        flat = None if flats is None else first.get_flat_field(flats)
        with stage("merge_s"), timed(f"merge {first.features['subject']}",
                                     device=dev):
            hdr = series.process_HDR_image(
                ICRF=icrf, ICRF_diff=icrf_diff, list_of_dark_fields=darks,
                use_std=args.std, flat_field=flat,
                apply_flat_field=not args.no_flat, ICRF_base=base,
                ICRF_diff_base=diff_base)
        out_dir = Path(args.out) if args.out else Path(args.images) / "hdr"
        with stage("write_s"):
            hdr.save_64bit(out_dir / hdr.path.name, is_hdr=True)
        log.info("wrote %s", out_dir / hdr.path.name)
    return 0


def cmd_linearity(args) -> int:
    """Analyse every exposure series of a directory and log the ODR fits
    of its absolute and relative differences; draw them into
    ``linearity_<kind>_<k>.png`` where matplotlib is installed (the fits
    are logged either way)."""
    import importlib.util
    from .models.exposure_series import ExposureSeries
    from .utils import visualization as viz
    from .utils.observability import get_logger
    log = get_logger()
    cfg = _load_config(args)
    dev = _device(args)
    plots = importlib.util.find_spec("matplotlib") is not None
    if not plots:
        log.warning("matplotlib is not installed: the linearity plots "
                    "(linearity_<kind>_<k>.png) are not written; the fits "
                    "are logged")
    icrf = None
    if args.icrf:
        icrf, _ = _load_icrf(args.icrf, cfg, dev)
    series_list = ExposureSeries.from_dir_path(Path(args.images), config=cfg,
                                               device=dev)
    for k, series in enumerate(series_list):
        series.load_value_images()
        if args.std:
            series.load_std_images()
        series.initialize_exposure_pairs()
        series.process_linearity(ICRF=icrf, use_std=args.std)
        abs_stats, rel_stats = series.collect_exposure_pair_stats()
        out = Path(args.out) if args.out else Path(args.images)
        for name, stats in (("absolute", abs_stats), ("relative",
                                                      rel_stats)):
            for cc, fit in viz.linearity_fits(stats, cfg).items():
                log.info("series %d %s ODR fit %s: A=%.5g±%.2g "
                         "B=%.5g±%.2g", k, name, cc, fit["beta"][0],
                         fit["sd_beta"][0], fit["beta"][1],
                         fit["sd_beta"][1])
            if plots:
                viz.create_linearity_plots(
                    stats, out / f"linearity_{name}_{k}.png", fit_line=True,
                    ylabel=f"{name} difference", symbol="R", config=cfg)
        log.info("series %d: %d pairs, mean |rel| = %s", k,
                 len(series.exposure_pairs),
                 np.abs(rel_stats["means"]).mean(axis=0))
    return 0


def cmd_calibrate(args) -> int:
    from .models import calibration as cal
    from .utils import io
    from .utils.observability import get_logger, timed
    log = get_logger()
    cfg = _load_config(args)
    dev = _device(args)
    out = args.out or (Path(cfg.data_path or ".")
                       / (cfg.icrf_calibrated_file or "ICRF_calibrated.txt"))
    if args.strict or args.hybrid:
        # host float64 parity modes: reproduce the reference's SciPy solve
        # to the RNG draw, cold (--strict) or seeded by a fast device
        # solve (--hybrid) (models/scipy_strict.py)
        from .models import scipy_strict
        stacks, stds, exposures, _ratio = \
            cal.initialize_channel_image_stacks(Path(args.images), args.std,
                                                args.spacing, config=cfg,
                                                device=dev)
        pca = np.stack([io.read_txt_to_array(cfg.pca_files[c],
                                             cfg.data_path)
                        for c in range(cfg.num_of_chs)])
        mean = np.stack([io.read_txt_to_array(cfg.mean_icrf_files[c],
                                              cfg.data_path)
                         for c in range(cfg.num_of_chs)])
        channel_stacks = (stacks.cpu().numpy().astype(np.int32),
                          None if stds is None else stds.cpu().numpy(),
                          exposures.cpu().numpy())
        if args.hybrid:
            device_kwargs = dict(maxiter=args.maxiter,
                                 energy_form=args.energy_form, device=dev)
            if args.checkpoint:
                # the device phase supports checkpoint/resume; the strict
                # phase (a short seeded polish) does not
                device_kwargs.update(checkpoint_path=args.checkpoint,
                                     checkpoint_every=100)
            with timed("calibration_hybrid", device=dev):
                icrf, dev_e, e0, e1, iters = scipy_strict.calibration_hybrid(
                    args.lower, args.upper, channel_stacks=channel_stacks,
                    pca_arrays=pca, mean_icrf_arrays=mean,
                    rng_seed=args.seed, config=cfg,
                    strict_maxiter=args.strict_maxiter,
                    strict_stall_limit=args.strict_stall_limit,
                    device_kwargs=device_kwargs)
            log.info("hybrid mode: device energies (f32 objective): %s",
                     dev_e)
            log.info("hybrid mode: %s strict iterations per channel", iters)
        else:
            if args.checkpoint:
                log.warning("--checkpoint is ignored in --strict mode "
                            "(the reference's SciPy solve has no resume)")
            with timed("calibration_strict", device=dev):
                icrf, e0, e1, iters = scipy_strict.calibration_strict(
                    args.lower, args.upper, channel_stacks=channel_stacks,
                    pca_arrays=pca, mean_icrf_arrays=mean,
                    rng_seed=args.seed, maxiter=args.maxiter, config=cfg)
            log.info("strict mode: %s iterations per channel", iters)
        log.info("initial energies: %s", e0)
        log.info("final energies:   %s", e1)
        io.save_txt(out, icrf)
        log.info("wrote %s", out)
        return 0
    with timed("calibration", device=dev):
        icrf, e0, e1, _ratio, base = cal.calibration(
            args.lower, args.upper, data_spacing=args.spacing,
            use_std=args.std, image_path=Path(args.images),
            rng_seed=args.seed, config=cfg, maxiter=args.maxiter,
            checkpoint_path=args.checkpoint,
            checkpoint_every=100 if args.checkpoint else 0,
            return_base=True, energy_form=args.energy_form, device=dev)
    log.info("initial energies: %s", e0)
    log.info("final energies:   %s", e1)
    io.save_txt(out, icrf)
    # the datapoints-resolution solved curve rides along: merge loads it
    # to take the interpolant kernel at >8-bit depths
    io.save_txt(_base_path(out), base)
    log.info("wrote %s (+ %s)", out, _base_path(out).name)
    return 0


def cmd_video(args) -> int:
    from .models import video
    cfg = _load_config(args)
    icrf = None
    if args.icrf:
        icrf, _ = _load_icrf(args.icrf, cfg, _device(args))
    video.process_directory(Path(args.videos), ICRF=icrf,
                            separately=args.separately, config=cfg,
                            decoder=args.decoder, device=args.device)
    return 0


def cmd_dorf(args) -> int:
    from .models import dorf
    cfg = _load_config(args)
    if args.data:
        cfg = cfg.replace(data_path=args.data)
    dorf.process_CRF_data(cfg)
    dorf.analyze_principal_components(cfg)
    return 0


def _power_limit(index: int) -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unknown ({exc})"
    return out.stdout.strip()


def cmd_doctor(args) -> int:
    """Environment diagnostic: what will this install actually run on?

    Probes the pieces whose availability and speed decide every pipeline:
    torch and CUDA, the device (name and power limit), TF32, the native
    host library, MJPEG decoder (and rawvideo reader) and TIFF codec, host
    parallelism, the pinned
    host-to-device rate, a warm dispatch round trip, and (with --video)
    the decode rate of the port's readers.
    """
    import time

    import torch

    from . import __version__, native
    dev = _device(args)
    print(f"camera_linearity_tpu_torch {__version__}")
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device={dev}")
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        print(f"  device: {torch.cuda.get_device_name(index)}, power limit "
              f"{_power_limit(index)}, {torch.cuda.device_count()} visible")
    from .parallel import distributed
    if distributed.process_count() > 1:
        print(f"multi-host: process {distributed.process_index()} of "
              f"{distributed.process_count()}, backend "
              f"{torch.distributed.get_backend()}, this process on {dev}")
    print(f"TF32 matmul: allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"float32_matmul_precision="
          f"{torch.get_float32_matmul_precision()}")
    print(f"host: {os.cpu_count()} cpu core(s)")
    ok = native.available()
    print(f"native staging library: {'built' if ok else 'NumPy fallback'}")
    if ok:
        batch = np.random.default_rng(0).integers(
            0, 255, (8, 540, 960, 3), np.uint8)
        s = np.zeros((540, 960, 3), np.uint64)
        q = np.zeros_like(s)
        native.accum_moments_u8(batch, s, q)  # warm
        t0 = time.perf_counter()
        native.accum_moments_u8(batch, s, q)
        rate = batch.shape[0] * 540 * 960 / 1e6 / (time.perf_counter() - t0)
        print(f"  exact-moment accumulation: {rate:.0f} MP/s "
              f"({native._NTHREADS} thread(s))")
    if native.tiff_available():
        plane = np.random.default_rng(0).integers(
            0, 255, (1200, 1920 * 3), np.uint8).reshape(-1)
        rows = np.arange(0, plane.size, 5760)
        sizes = np.full(rows.size, 5760)
        strips = native.lzw_encode_chunks(plane, rows, sizes)
        packed = np.concatenate(strips)
        at = np.concatenate([[0], np.cumsum([s.size for s in strips])[:-1]])
        dst = np.empty_like(plane)
        t0 = time.perf_counter()
        native.lzw_decode_chunks(packed, at, [s.size for s in strips], dst,
                                 rows, sizes)
        mbps = plane.size / 1e6 / (time.perf_counter() - t0)
        print(f"native TIFF codec: built; LZW decode {mbps:.0f} MB/s "
              "(one 1200 x 1920 x 3 u8 plane of noise); also PackBits, "
              "CCITT (compression 2, 3, 4), and JPEG (7) through the MJPEG "
              "decoder")
    else:
        print(f"native TIFF codec: unavailable ({native.build_error('_tiff')})"
              "; TIFFs cannot be read or written")
    print("native MJPEG decoder: " + (
        "built; modes " + ", ".join(native.JPEG_MODES) + " (an MJPG AVI "
        "takes 'ffmpeg', cv2's bytes, unless CL_DECODER names another); "
        "rawvideo layouts " + ", ".join(native.RAW_LAYOUTS) + " (the "
        "uncompressed AVIs, cv2's bytes); TIFF JPEG chunks as "
        + ", ".join(native.TIFF_JPEG_FORMS)
        if native.mjpeg_available() else
        f"unavailable ({native.build_error('_mjpeg')}); MJPG, "
        "uncompressed AVIs other than RGBA and JPEG-compressed TIFFs "
        "cannot be read"))
    for name, ok, stem, what in (
            ("PNG", native.png_available, "_png", "PNG AVIs (MPNG, PNG1, "
             "'png '): gray 1-16 bits, RGB(A) and gray+alpha at 8 bits, "
             "gray+alpha 16, palettes, Adam7"),
            ("HuffYUV", native.huffyuv_available, "_huffyuv", "HuffYUV "
             "AVIs (HFYU, FFVH): RGB24, RGB32, YUY2, yuv420p; left, "
             "gradient and median predictors"),
            ("FFV1", native.ffv1_available, "_ffv1", "FFV1 AVIs: versions "
             "0-3, Golomb-Rice and range coders, RGB(A), gray8, gray16, "
             "yuv420p, yuv422p, yuv444p; a slice a thread"),
            ("UtVideo", native.utvideo_available, "_utvideo", "UtVideo "
             "AVIs (ULRG, ULRA, ULY0, ULY2, ULY4, ULH0, ULH2, ULH4): every "
             "predictor and slice count; a frame a thread"),
            ("Lagarith", native.lagarith_available, "_lagarith", "Lagarith "
             "AVIs (LAGS): RGB24, RGBA, YUY2, YV12 and solid frames, every "
             "escape form; a plane a thread"),
            ("MPEG-4 Part 2", native.mpeg4_available, "_mpeg4", "MPEG-4 "
             "Part 2 AVIs (" + ", ".join(native.mpeg4_plain.MPEG4_FOURCCS)
             + "): Simple "
             "Profile I-, P- and N-VOPs, 1MV/4MV, dquant, AC prediction, "
             "video packets; Xvid and DivX 5 Advanced Simple streams: "
             "B-VOPs, packed bitstreams, MPEG quantisation, the Xvid IDCT "
             "(not quarter-pel or GMC); a macroblock row a thread"),
            ("H.264", native.h264_available, "_h264", "H.264 AVIs ("
             + ", ".join(native.h264_plain.H264_FOURCCS) + "), MP4/MOV "
             "avc1/avc3 and Matroska V_MPEG4/ISO/AVC: I and P slices of the "
             "Constrained Baseline, Main and High profiles (CAVLC and "
             "CABAC, the 8x8 transform, scaling matrices, weighted "
             "prediction, every MMCO, several slices; not B slices or "
             "interlaced coding); a GOP a "
             "thread, a picture's slices side by side")):
        print(f"native {name} decoder: " + (
            f"built; {what} (cv2's bytes)" if ok() else
            f"unavailable ({native.build_error(stem)}); such AVIs cannot "
            "be read"))
    print("video containers: AVI, QuickTime MOV and MP4 (ISO BMFF), "
          "Matroska and WebM, each by the port's own demuxer (the codecs "
          "above in any of them)")
    if dev.type == "cuda":
        # one-time costs are paid before each timed window: the point is
        # the steady rate
        from .utils.general import stage_to_device_async
        payload = torch.ones((16 << 20) // 4, dtype=torch.float32,
                             pin_memory=True).numpy()
        stage_to_device_async(payload, dev)[1].synchronize()  # warm
        t0 = time.perf_counter()
        stage_to_device_async(payload, dev)[1].synchronize()
        secs = time.perf_counter() - t0
        print(f"host->device: {payload.nbytes / 1e6 / secs:.0f} MB/s "
              "(16 MB pinned probe, steady rate)")
    x = torch.ones((256, 256), device=dev)
    float(torch.sum(x @ x))  # warm outside the window
    t0 = time.perf_counter()
    float(torch.sum(x @ x))
    print(f"device dispatch+matmul round trip: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms (warm)")
    if args.video:
        _doctor_video(Path(args.video))
    return 0


def _doctor_video(path: Path) -> None:
    """Decode rate of each reader the port has for ``path`` (an AVI, MOV,
    MP4 or Matroska file, whose container it names); for MJPEG, the port's
    decoder in each mode, and for PNG, HuffYUV, FFV1, UtVideo, Lagarith or
    MPEG-4 Part 2 its decoder, on one thread and on all."""
    import importlib.util
    import itertools
    import time

    from . import native
    from .models import video as video_mod
    from .utils import avi, containers
    h, w = video_mod.probe_geometry(path)
    info = containers.probe_video(path)
    if info is not None:
        print(f"container: {info.container_name}, codec "
              f"{info.codec_name!r}, {info.width}x{info.height} stored"
              + (f", shown turned {info.rotation} degrees"
                 if info.rotation else ""))
        h, w = info.height, info.width   # the decoders' geometry
    decoders = ["native"]
    if info is not None and info.codec == "MJPG":
        decoders = []
        payloads = list(itertools.islice(containers.mjpg_chunks(path, info),
                                         120))
        cores = os.cpu_count() or 1
        dst = np.empty((min(cores, len(payloads)), h, w, 3), np.uint8)
        for mode in native.JPEG_MODES:
            for threads in sorted({1, cores}):
                t0 = time.perf_counter()
                for at in range(0, len(payloads), len(dst)):
                    part = payloads[at:at + len(dst)]
                    native.jpeg_decode_bgr_batch(
                        part, dst[:len(part)], mode=mode, threads=threads)
                secs = time.perf_counter() - t0
                print(f"decode ({mode}, {threads} thread(s)): "
                      f"{len(payloads) * h * w / 1e6 / secs:.0f} MP/s "
                      f"({w}x{h}, {len(payloads)} frames, "
                      f"{secs / len(payloads) * 1e3:.1f} ms a frame)")
    codecs = avi.PNG_CODECS + avi.HUFFYUV_CODECS + avi.FFV1_CODECS + \
        avi.UTVIDEO_CODECS + avi.LAGARITH_CODECS + avi.MPEG4_CODECS + \
        avi.H264_CODECS
    if info is not None and info.codec in codecs:
        kind = "png" if info.codec in avi.PNG_CODECS else \
            "huffyuv" if info.codec in avi.HUFFYUV_CODECS else \
            "ffv1" if info.codec in avi.FFV1_CODECS else \
            "lagarith" if info.codec in avi.LAGARITH_CODECS else \
            "mpeg4" if info.codec in avi.MPEG4_CODECS else \
            "h264" if info.codec in avi.H264_CODECS else "utvideo"
        payloads = [bytes(c) for c in itertools.islice(
            containers.frame_chunks(path, info), 120)]
        cores = os.cpu_count() or 1
        dst = np.empty((min(cores, len(payloads)), h, w, 3), np.uint8)
        params = avi.huffyuv_params(info) if kind == "huffyuv" else \
            avi.utvideo_params(info) if kind == "utvideo" else None
        for threads in sorted({1, cores}):
            # FFV1 carries its states from frame to frame: a decoder a pass
            ffv1 = native.Ffv1Decoder(avi.ffv1_params(info), h, w) \
                if kind == "ffv1" else None
            # MPEG-4 chains its P-VOPs from the last I-VOP: a decoder too
            mpeg4 = native.Mpeg4Decoder(*avi.mpeg4_params(info), h, w) \
                if kind == "mpeg4" else None
            # and H.264 its P pictures from the IDR
            h264 = native.H264Decoder(avi.h264_params(info)) \
                if kind == "h264" else None
            t0 = time.perf_counter()
            for at in range(0, len(payloads), len(dst)):
                part = payloads[at:at + len(dst)]
                if kind == "png":
                    native.png_decode_bgr_batch(part, dst[:len(part)],
                                                info.png, threads=threads)
                elif kind == "ffv1":
                    native.ffv1_decode_bgr_batch(part, dst[:len(part)], ffv1,
                                                 threads=threads)
                elif kind == "utvideo":
                    native.utvideo_decode_bgr_batch(
                        part, dst[:len(part)], params, threads=threads)
                elif kind == "lagarith":
                    native.lagarith_decode_bgr_batch(
                        part, dst[:len(part)], threads=threads)
                elif kind == "mpeg4":
                    native.mpeg4_decode_bgr_batch(
                        part, dst[:len(part)], mpeg4, threads=threads)
                elif kind == "h264":
                    native.h264_decode_bgr_batch(
                        part, dst[:len(part)], h264, threads=threads)
                else:
                    native.huffyuv_decode_bgr_batch(
                        part, dst[:len(part)], params, threads=threads)
            secs = time.perf_counter() - t0
            print(f"decode ({kind}, {threads} "
                  f"thread(s)): {len(payloads) * h * w / 1e6 / secs:.0f} "
                  f"MP/s ({w}x{h}, {len(payloads)} frames, "
                  f"{secs / len(payloads) * 1e3:.1f} ms a frame)")
    if importlib.util.find_spec("cv2") is not None:
        decoders.append("cv2")
    for decoder in decoders:
        n = 0
        t0 = time.perf_counter()
        for frame in video_mod.video_frame_generator(path, decoder=decoder):
            if frame is None or n >= 120:
                break
            n += 1
        rate = n * h * w / 1e6 / (time.perf_counter() - t0)
        print(f"decode ({decoder}): {rate:.0f} MP/s ({w}x{h}, {n} frames; "
              "this rate ceilings the video pipelines on 1-core hosts)")


def build_parser() -> argparse.ArgumentParser:
    from .models.video import DECODERS
    p = argparse.ArgumentParser(prog="camera_linearity_tpu_torch",
                                description=__doc__,
                                formatter_class=
                                argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", help="path to a config.ini")
    p.add_argument("--device", default="cuda",
                   help="torch device the commands run on (default cuda; "
                        "cpu runs them on the CPU)")
    p.add_argument("--coordinator",
                   help="multi-process: coordinator address host:port "
                        "(or env CL_COORDINATOR_ADDRESS)")
    p.add_argument("--num-processes", type=int,
                   help="multi-process: total process count "
                        "(or env CL_NUM_PROCESSES)")
    p.add_argument("--process-id", type=int,
                   help="multi-process: this process's id "
                        "(or env CL_PROCESS_ID)")
    sub = p.add_subparsers(dest="command", required=True)

    m = sub.add_parser("merge", help="HDR-merge exposure stacks")
    m.add_argument("--images", required=True)
    m.add_argument("--icrf", required=True)
    m.add_argument("--out")
    m.add_argument("--std", action="store_true",
                   help="propagate uncertainty images")
    m.add_argument("--no-flat", action="store_true")
    m.set_defaults(fn=cmd_merge)

    li = sub.add_parser("linearity", help="exposure-pair linearity analysis")
    li.add_argument("--images", required=True)
    li.add_argument("--icrf")
    li.add_argument("--out")
    li.add_argument("--std", action="store_true")
    li.set_defaults(fn=cmd_linearity)

    c = sub.add_parser("calibrate", help="solve the ICRF")
    c.add_argument("--images", required=True)
    c.add_argument("--out")
    c.add_argument("--lower", type=float, default=-1.0)
    c.add_argument("--upper", type=float, default=1.0)
    c.add_argument("--spacing", type=int, default=150)
    c.add_argument("--maxiter", type=int, default=1000)
    c.add_argument("--seed", type=int, default=7)
    c.add_argument("--std", action="store_true")
    c.add_argument("--checkpoint")
    c.add_argument("--energy-form", default="auto",
                   choices=["auto", "onehot", "hist", "chunked"],
                   help="pin the objective formulation (default: auto "
                        "by memory footprint)")
    mode = c.add_mutually_exclusive_group()
    mode.add_argument("--strict", action="store_true",
                      help="host float64 parity mode: reproduce the "
                           "reference's seeded SciPy solve to the RNG draw")
    mode.add_argument("--hybrid", action="store_true",
                      help="fast-then-exact: device solve finds the basin, "
                           "then seeds the strict float64 SciPy solver")
    c.add_argument("--strict-maxiter", type=int, default=100,
                   help="iteration cap for the hybrid's strict polish "
                        "phase (--maxiter caps the device phase)")
    c.add_argument("--strict-stall-limit", type=int, default=None,
                   help="hybrid polish early stop: end when the best "
                        "energy has not improved for this many "
                        "iterations (the match-or-improve guarantee is "
                        "unaffected)")
    c.set_defaults(fn=cmd_calibrate)

    v = sub.add_parser("video", help="video mean/std frames")
    v.add_argument("--videos", required=True)
    v.add_argument("--icrf")
    v.add_argument("--separately", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="one mean/std pair per video (default), or "
                        "--no-separately for one pooled pair")
    v.add_argument("--decoder", default="auto", choices=["auto", *DECODERS],
                   help="video reader: native (the container decides: NumPy "
                        "for RGBA AVIs, the port's JPEG decoder in its ffmpeg "
                        "mode, cv2's bytes, for MJPG), cv2, ffmpeg, turbo or "
                        "turbo_fast (libjpeg-turbo's bytes); auto = env "
                        "CL_DECODER, default native")
    v.set_defaults(fn=cmd_video)

    d = sub.add_parser("dorf", help="build the DoRF PCA basis")
    d.add_argument("--data")
    d.set_defaults(fn=cmd_dorf)

    dr = sub.add_parser("doctor", help="diagnose the runtime environment")
    dr.add_argument("--video", help="also probe decode rate on this file")
    dr.set_defaults(fn=cmd_doctor)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # with no --coordinator/--num-processes/--process-id and no CL_*
    # environment this is a no-op (single-process mode)
    from .parallel import distributed
    owner = not distributed.is_initialized()
    distributed.initialize(coordinator_address=args.coordinator,
                           num_processes=args.num_processes,
                           process_id=args.process_id, device=args.device)
    try:
        return args.fn(args)
    finally:
        if owner:  # a group this call joined ends with it
            distributed.shutdown()


if __name__ == "__main__":
    sys.exit(main())
