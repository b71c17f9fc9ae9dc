"""End-to-end pipelines composing the framework's stages.

Port of ``camera_linearity_tpu/models/pipeline.py``: BASELINE config 5's
video -> HDR path.  Per-exposure videos reduce to mean/std frames on the
host (exact integer moments, ``native``), the frames form an exposure
stack, and the stack merges into an HDR radiance map with uncertainty on
the device.

In the batched flow each video's planes upload as soon as they finalize,
overlapping the next video's decode: the host stacks are pinned, each copy
runs ``non_blocking`` on the device's transfer stream with an event per
plane, a stack buffer is refilled only after its previous scene's events
have completed, and the merge stream waits on every event before it reads
the planes.  The multi-GPU flow (``mesh=``, the JAX package's
``batch_video_to_hdr_distributed``) waits for ROADMAP queue 1 item 4.
"""
from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import native
from ..config import CameraConfig, DEFAULT_CONFIG
from ..measurand import Measurand
from ..ops import hdr as hdr_ops
from ..ops.linearize import icrf_derivative
from ..utils import io
from ..utils.device import canonical_float, resolve_device
from ..utils.general import stage_to_device, transfer_stream
from ..utils.observability import get_logger, stage, timed
from . import video as video_mod
from .exposure_series import ExposureSeries
from .image_set import ImageSet

Tensor = torch.Tensor

__all__ = ["videos_to_stacks", "videos_to_exposure_series", "video_to_hdr",
           "batch_video_to_hdr", "prewarm_batch_video_to_hdr"]


def _exposure_of(path: Path) -> float:
    return io.features_from_file_name(Path(path).with_suffix(".tif"))[
        "exposure"]


def _numpy_float(device) -> np.dtype:
    """The numpy type of the device's canonical float."""
    return np.dtype(str(canonical_float(device)).removeprefix("torch."))


def _table(x, device, dtype) -> Tensor:
    """An ICRF table (tensor or numpy) as a tensor on ``device``."""
    if not isinstance(x, Tensor):
        x = np.asarray(x)
    return torch.as_tensor(x, dtype=dtype, device=device)


def videos_to_stacks(video_paths: Sequence[Path],
                     config: CameraConfig = DEFAULT_CONFIG,
                     batch_size: int = 32, stacks=None, on_video=None,
                     wire: bool = False, decoder: str = "auto",
                     device=None):
    """Reduce per-exposure videos to HOST (N, H, W, C) value/std stacks.

    The per-video statistics finalize DIRECTLY into slices of the
    preassembled stack (``HostMoments.finalize(out=...)``): no intermediate
    per-video frames, no conversion pass.  The stacks are in the canonical
    float of ``device`` (by default the card: float32), or
    ``stacks=(val, std)`` reuses caller-provided host buffers in their own
    type.  ``on_video(i, val_slice, std_slice)`` fires after each video's
    statistics land in its stack slice, letting callers start per-video
    device uploads behind the next video's decode.  ``wire=True`` finalizes
    into the u16-mean + f16-std wire encoding (``native.WIRE_U16F16``)
    instead; consumers dequantize on the device.  ``decoder`` forwards to
    :func:`models.video.welford_algorithm`.  Returns
    ``(val_stack, std_stack, exposures, sorted_paths)``, all NumPy.
    """
    log = get_logger()
    if wire:
        dtype = native.WIRE_U16F16
    elif stacks is not None:
        dtype = stacks[0].dtype
    else:
        dtype = _numpy_float(resolve_device(device))
    paths = sorted(video_paths, key=_exposure_of)
    val_stack, std_stack = (None, None) if stacks is None else stacks
    for i, path in enumerate(paths):
        t0 = time.perf_counter()
        if val_stack is None:
            h, w = video_mod.probe_geometry(path)
            shape = (len(paths), h, w, config.num_of_chs)
            vd, sd = dtype if wire else (dtype, dtype)
            val_stack = np.empty(shape, vd)
            std_stack = np.empty(shape, sd)
        video_mod.welford_algorithm(path, None, use_std=True,
                                    config=config, batch_size=batch_size,
                                    quantize=False, dtype=dtype,
                                    out=(val_stack[i], std_stack[i]),
                                    decoder=decoder)
        if on_video is not None:
            on_video(i, val_stack[i], std_stack[i])
        log.debug("videos_to_stacks %s: %.1fs", path.name,
                  time.perf_counter() - t0)
    exposures = np.asarray([_exposure_of(p) for p in paths])
    return val_stack, std_stack, exposures, paths


def videos_to_exposure_series(video_paths: Sequence[Path],
                              config: CameraConfig = DEFAULT_CONFIG,
                              batch_size: int = 32, decoder: str = "auto",
                              device=None) -> ExposureSeries:
    """Reduce per-exposure videos to an ExposureSeries of mean/std frames
    on ``device`` (by default the card).

    Each video's filename carries its exposure descriptor (the reference's
    grammar, e.g. ``scene 5ms.avi``); the statistics produce the value
    image (mean) and its uncertainty (std of the mean) per exposure.  The
    per-exposure Measurands are slices of one (N, H, W, C) upload.
    """
    dev = resolve_device(device)
    val_stack, std_stack, _, paths = videos_to_stacks(
        video_paths, config, batch_size, decoder=decoder, device=dev)
    dval = torch.as_tensor(val_stack, device=dev)
    dstd = torch.as_tensor(std_stack, device=dev)
    sets = [ImageSet(file_path=path.with_suffix(".tif"),
                     measurand=Measurand(dval[i], dstd[i]), config=config,
                     device=dev)
            for i, path in enumerate(paths)]
    return ExposureSeries(input_image_sets=sets, config=config)


def video_to_hdr(video_paths: Sequence[Path], ICRF,
                 ICRF_diff=None, config: CameraConfig = DEFAULT_CONFIG,
                 batch_size: int = 32, decoder: str = "auto",
                 device=None) -> ImageSet:
    """BASELINE config 5 for one scene: videos -> mean/std stack -> HDR,
    through ``process_HDR_image`` with no darks and no flat (on CUDA, one
    launch of the repair-and-merge kernel K3), on ``device`` (by default
    the card)."""
    dev = resolve_device(device)
    ftype = canonical_float(dev)
    series = videos_to_exposure_series(video_paths, config, batch_size,
                                       decoder=decoder, device=dev)
    get_logger().info("video_to_hdr: %d exposures stacked",
                      len(series.input_image_sets))
    return series.process_HDR_image(
        ICRF=_table(ICRF, dev, ftype),
        ICRF_diff=None if ICRF_diff is None else _table(ICRF_diff, dev,
                                                        ftype),
        list_of_dark_fields=[], apply_flat_field=False)


# Warm scene-stack buffer pairs by geometry and type, exclusive while a
# call holds them (video._BufferCache)
_SCENE_STACKS = video_mod._BufferCache()


def _checkout_scene_stack_pool(shape, dtype, pinned: bool = False):
    """Check out a pool of two prefaulted host scene-stack buffer pairs
    (pinned for uploads to the card).

    Fresh multi-hundred-MB allocations first-touch-fault inside the
    statistics loop; a reused warm pair writes at memory speed.  Two pairs
    suffice: scene k+1 fills one while scene k's uploads drain the other
    (callers wait on scene k-1's upload events before reusing its pair).
    ``dtype`` is one dtype (val and std buffers alike) or a
    ``(val_dtype, std_dtype)`` pair (the wire's u16 val beside f16 std).
    """
    if isinstance(dtype, (tuple, list)):
        vd, sd = (np.dtype(d) for d in dtype)
    else:
        vd = sd = np.dtype(dtype)
    key = (tuple(shape), vd.str, sd.str, pinned)
    pool = _SCENE_STACKS.checkout(key, lambda: [
        (video_mod.host_buffer(shape, vd, pinned),
         video_mod.host_buffer(shape, sd, pinned)) for _ in range(2)])
    return key, pool


def _return_scene_stack_pool(key, pool) -> None:
    _SCENE_STACKS.give_back(key, pool)


def _wire_flags(wire_val: Optional[str], wire_std: Optional[str]):
    """``(u16 val + f16 std, f16 std only)`` from the wire arguments and
    their env defaults ``CL_WIRE_VAL`` / ``CL_WIRE_STD``."""
    ws = wire_std or os.environ.get("CL_WIRE_STD", "f32")
    if ws not in ("f32", "f16"):
        raise ValueError(f"wire_std must be 'f32' or 'f16', got {ws!r}")
    wv = wire_val or os.environ.get("CL_WIRE_VAL", "f32")
    if wv not in ("f32", "u16"):
        raise ValueError(f"wire_val must be 'f32' or 'u16', got {wv!r}")
    return wv == "u16", ws == "f16" and wv != "u16"


def _upload_plane(a: np.ndarray, dst: Tensor, is_std: bool, wire_u16: bool,
                  wire_f16: bool):
    """Start the copy of one host plane towards ``dst``: ``(tensor,
    event)`` of :func:`utils.general.stage_to_device`.  A plane shipped at
    ``dst``'s type lands in ``dst`` itself; a wire plane (u16 val, carried
    as int16 bits; f16 std) lands in a tensor of its own, for
    :func:`_dequantize` once its event has completed."""
    if wire_u16:
        return stage_to_device(a if is_std else a.view(np.int16), dst.device)
    if is_std and wire_f16:
        return stage_to_device(a.astype(np.float16), dst.device)
    return stage_to_device(a, dst.device, out=dst)


def _dequantize(t: Tensor, dst: Tensor) -> None:
    """Write an uploaded wire plane into ``dst`` in its float type: u16
    val as ``val * (1/65535)``, f16 std upcast."""
    if t is dst:
        return
    if t.dtype == torch.int16:
        t = (t.to(torch.int32) & 0xFFFF).to(dst.dtype) * (1.0 / 65535.0)
    dst.copy_(t)


def _wait(uploads) -> None:
    """Block the host until every copy of ``uploads`` has read its source
    (the pool pair it came from may then be refilled)."""
    for _, event in uploads:
        if event is not None:
            event.synchronize()


def prewarm_batch_video_to_hdr(n_scenes: int, n_exposures: int,
                               height: int, width: int, ICRF,
                               ICRF_diff=None,
                               config: CameraConfig = DEFAULT_CONFIG,
                               batch_size: int = 32,
                               calibrate: Optional[dict] = None,
                               wire_val: Optional[str] = None,
                               wire_std: Optional[str] = None,
                               device=None) -> dict:
    """Pay every one-time cost of the batched video->HDR flow up front.

    Benchmarks and latency-sensitive callers invoke this BEFORE their
    clock: it builds/loads the native staging library, prefaults the
    decode pool, moment accumulators and pinned scene-stack buffers for the
    given geometry, warms the host->device copy and dequantization at the
    per-video plane size, builds the merge kernel and runs the batched
    merge once on device-side zeros, and (with ``calibrate``) runs the
    calibration leg once.  ``wire_val`` / ``wire_std`` must match the
    values that will be passed to :func:`batch_video_to_hdr`: the
    scene-stack pool is keyed by buffer type.  Returns ``{"h2d_mbps": ...}``
    — one std plane's copy rate, host clock, after the warm-up.
    """
    log = get_logger()
    dev = resolve_device(device)
    ftype = canonical_float(dev)
    cfg = config
    chs = cfg.num_of_chs
    with timed("prewarm: native build/load", device=dev):
        if not native.available():
            log.warning("native stager unavailable, the NumPy fallback "
                        "runs: %s", native.build_error())
    wire_u16, wire_f16 = _wire_flags(wire_val, wire_std)
    with timed("prewarm: host buffer prefault", device=dev):
        vkey, vbufs = video_mod._checkout_host_buffers(
            min(batch_size, 16), height, width, chs)
        video_mod._return_host_buffers(vkey, vbufs)
        pool_key, pool = _checkout_scene_stack_pool(
            (n_exposures, height, width, chs),
            native.WIRE_U16F16 if wire_u16 else _numpy_float(dev),
            pinned=dev.type == "cuda")
    icrf_t = _table(ICRF, dev, ftype)
    icrf_diff_t = icrf_derivative(icrf_t, cfg.bits) if ICRF_diff is None \
        else _table(ICRF_diff, dev, ftype)
    try:
        with timed("prewarm: h2d transfer", device=dev):
            dst = torch.empty(pool[0][0].shape[1:], dtype=ftype, device=dev)
            if dev.type == "cuda":
                transfer_stream(dev).wait_stream(
                    torch.cuda.current_stream(dev))
            for is_std, plane in ((False, pool[0][0][0]),
                                  (True, pool[0][1][0])):
                up = _upload_plane(plane, dst, is_std, wire_u16, wire_f16)
                _wait([up])
                _dequantize(up[0], dst)
        plane = pool[0][1][0]
        t0 = time.perf_counter()
        _wait([stage_to_device(plane, dev)])
        h2d_mbps = plane.nbytes / 1e6 / (time.perf_counter() - t0)
        log.info("prewarm: h2d steady rate %.0f MB/s", h2d_mbps)
    finally:
        # the run being prewarmed checks out these exact warm buffers
        _return_scene_stack_pool(pool_key, pool)
    with timed("prewarm: merge build+run", device=dev):
        zeros = torch.zeros((n_scenes, n_exposures, height, width, chs),
                            dtype=ftype, device=dev)
        ex = torch.as_tensor(np.geomspace(1.0, 4.0, n_exposures),
                             dtype=ftype, device=dev)
        hdr_ops.merge_batch(zeros, zeros, ex, icrf_t, icrf_diff_t)
        del zeros
    if calibrate is not None:
        # a realistic warm batch (a gamma-ish ramp, not zeros): on all-equal
        # DNs every candidate energy is inf and the solver's later stages
        # would not run
        with timed("prewarm: calibration leg", device=dev):
            px = height * width * chs
            ramp = torch.linspace(0.02, 0.98, px, dtype=ftype, device=dev
                                  ).reshape(1, 1, height, width, chs)
            scale = (ex / ex[-1]).reshape(1, n_exposures, 1, 1, 1)
            _calibrate_from_batch(
                torch.clip(ramp * scale, 0, 1) ** (1 / 2.2), ex, cfg,
                calibrate)
    return {"h2d_mbps": round(h2d_mbps, 1)}


def _validate_scene_batch(scenes: Dict[str, Sequence[Path]],
                          names: Sequence[str],
                          probe_names: Optional[Sequence[str]] = None
                          ) -> list:
    """Shared batch validation: non-empty scenes with matching exposure
    sets (filename-derived) AND matching frame geometry (container-header
    probe), checked BEFORE any decode work so a mismatched batch fails in
    milliseconds, not after minutes of decoding.  The batched merge
    applies ONE exposure vector and ONE (H, W) geometry to every scene; a
    differing scene would merge silently wrong.  ``probe_names``
    restricts the geometry probe to a subset of the scenes."""
    if not names:
        raise ValueError("batch_video_to_hdr: scenes is empty; pass at "
                         "least one scene name -> video paths entry")
    for name in names:
        if not scenes[name]:
            raise ValueError(f"batch_video_to_hdr: scene {name!r} has no "
                             "videos")
    exp0 = sorted(_exposure_of(p) for p in scenes[names[0]])
    probe = names if probe_names is None else probe_names
    geo0 = None
    geo0_name = None
    for name in names:
        exp = sorted(_exposure_of(p) for p in scenes[name])
        if exp != exp0:
            raise ValueError(
                f"batch_video_to_hdr: scene {name!r} has exposures "
                f"{exp} != {names[0]!r}'s {exp0}; merge scenes with "
                "differing exposure sets separately (video_to_hdr)")
        if name not in probe:
            continue
        geo = video_mod.probe_geometry(
            sorted(scenes[name], key=_exposure_of)[0])
        if geo0 is None:
            geo0, geo0_name = geo, name
        elif geo != geo0:
            raise ValueError(
                f"batch_video_to_hdr: scene {name!r} has frame geometry "
                f"{geo} != {geo0_name!r}'s {geo0}; all scenes in a batch "
                "must share frame geometry")
    return exp0


def _calibrate_from_batch(batch_val: Tensor, exposures: Tensor,
                          cfg: CameraConfig, spec: dict):
    """The config-5 calibration leg: solve the ICRF from the freshly
    stacked scene batch so the merge that follows uses the solved curve
    (the reference flow: video_processing.py:161-219 mean/std frames
    feeding ICRF_calibration_exposure.py:288's solve before the merge at
    exposure_series.py:317-397).

    The first scene's mean frames are subsampled on a fixed flat stride
    (``spec['spacing']``, the reference's data_spacing analog), quantized
    to datapoints-resolution DNs on the device, and handed to the port's
    calibration.  ``spec`` must carry ``pca_arrays`` (and usually
    ``mean_icrf_arrays``); remaining keys forward to
    :func:`models.calibration.calibration`.  Returns the solved ``(bits,
    C)`` ICRF and its derivative on the batch's device.
    """
    spec = dict(spec)
    spacing = int(spec.pop("spacing", 64))
    n, h, w, c = batch_val.shape[1:]
    flat = batch_val[0].reshape(n, h * w, c)
    sub = flat[:, ::spacing, :]                       # (N, P, C)
    return _calibrate_from_subsample(sub, exposures, cfg, spec)


def _calibrate_from_subsample(sub: Tensor, exposures: Tensor,
                              cfg: CameraConfig, spec: dict):
    """Solve the calibration leg from an already-subsampled ``(N, P, C)``
    value block (see :func:`_calibrate_from_batch`; ``spec`` here no
    longer carries ``spacing``), on the block's device."""
    from . import calibration as cal
    spec = dict(spec)
    lower = spec.pop("lower", -1.0)
    upper = spec.pop("upper", 1.0)
    pca = np.asarray(spec.pop("pca_arrays"))
    mean_icrf = spec.pop("mean_icrf_arrays", None)
    mean_icrf = None if mean_icrf is None else np.asarray(mean_icrf)
    dn = torch.clip(torch.round(sub * (cfg.datapoints - 1)), 0,
                    cfg.datapoints - 1).long()
    stacks = dn.permute(2, 1, 0)                      # (C, P, N)
    icrf, _, _, _ = cal.calibration(
        lower, upper, channel_stacks=(stacks, None, exposures),
        pca_arrays=pca, mean_icrf_arrays=mean_icrf, config=cfg,
        device=sub.device, **spec)
    icrf_t = torch.as_tensor(icrf, dtype=sub.dtype, device=sub.device)
    return icrf_t, icrf_derivative(icrf_t, cfg.bits)


def batch_video_to_hdr(scenes: Dict[str, Sequence[Path]], ICRF,
                       ICRF_diff=None,
                       config: CameraConfig = DEFAULT_CONFIG,
                       mesh=None, wire_std: Optional[str] = None,
                       wire_val: Optional[str] = None,
                       calibrate: Optional[dict] = None,
                       decoder: str = "auto",
                       device=None) -> Dict[str, ImageSet]:
    """Batch of scenes: stack every scene's series and merge them together
    on ``device`` (by default the card) — on CUDA one launch of the merge
    kernel K1 for the whole (B, N, H, W, C) batch.

    Every video's (val, std) planes start their upload as soon as they
    finalize, overlapping the NEXT video's decode (see the module
    docstring); only the last video's upload is exposed.  Stage busy times
    accumulate in ``utils.observability.stage_times`` (decode_s / stats_s /
    finalize_s / upload_s / assemble_s / calibrate_s / merge_s ...); on
    CUDA, assemble_s and merge_s end in a synchronize, so each holds its
    device work.

    ``wire_std`` (``"f32"`` by default; env ``CL_WIRE_STD``) ``"f16"``
    ships the std plane as float16 and upcasts it on the device (<= 2^-11
    relative).  ``wire_val`` (``"f32"`` by default; env ``CL_WIRE_VAL``)
    ``"u16"`` ships the mean as fixed-point u16 on the 1/65535 grid
    (<= 2^-17 absolute), written directly by the fused native finalize,
    and implies the f16 std.  ``"f32"`` means the device's canonical
    float (float64 on the CPU).

    ``calibrate`` (optional dict) runs the config-5 calibration leg: the
    ICRF is SOLVED from the decoded stacks (see
    :func:`_calibrate_from_batch`) and replaces ``ICRF`` for the merge.
    ``decoder`` selects the host video decoder (see
    :func:`models.video._resolve_decoder`).  ``mesh`` belongs to the
    multi-GPU port and raises NotImplementedError.
    """
    if mesh is not None:
        raise NotImplementedError(
            "batch_video_to_hdr over a mesh is the multi-GPU port (ROADMAP "
            "queue 1, item 4), which has not landed")
    wire_u16, wire_f16 = _wire_flags(wire_val, wire_std)
    log = get_logger()
    cfg = config
    dev = resolve_device(device)
    ftype = canonical_float(dev)
    cuda = dev.type == "cuda"
    icrf_t = _table(ICRF, dev, ftype)
    icrf_diff_t = icrf_derivative(icrf_t, cfg.bits) if ICRF_diff is None \
        else _table(ICRF_diff, dev, ftype)

    names = list(scenes.keys())
    _validate_scene_batch(scenes, names)
    h, w = video_mod.probe_geometry(
        sorted(scenes[names[0]], key=_exposure_of)[0])
    shape = (len(scenes[names[0]]), h, w, cfg.num_of_chs)
    batch_val = torch.empty((len(names),) + shape, dtype=ftype, device=dev)
    batch_std = torch.empty_like(batch_val)
    if cuda:  # the copies into the batch follow its allocation
        transfer_stream(dev).wait_stream(torch.cuda.current_stream(dev))

    pool_key, pool = _checkout_scene_stack_pool(
        shape, native.WIRE_U16F16 if wire_u16 else _numpy_float(dev),
        pinned=cuda)
    uploads: list = []   # per scene: ((tensor, event), dst) per plane
    scene_paths: list = []
    try:
        with stage("stacks_s"):
            for idx, name in enumerate(names):
                # refill a pair only once its previous scene's copies have
                # read it
                if idx >= len(pool):
                    _wait(up for up, _ in uploads[idx - len(pool)])
                ups: list = []
                uploads.append(ups)

                def on_video(i, v, s, idx=idx, ups=ups):
                    with stage("upload_s"):
                        for a, dst, is_std in ((v, batch_val[idx, i], False),
                                               (s, batch_std[idx, i], True)):
                            ups.append((_upload_plane(a, dst, is_std,
                                                      wire_u16, wire_f16),
                                        dst))
                _, _, exposures_np, paths = videos_to_stacks(
                    scenes[name], cfg, stacks=pool[idx % len(pool)],
                    wire=wire_u16, decoder=decoder, on_video=on_video)
                scene_paths.append(paths)

        # filename-derived, so _validate_scene_batch already made every
        # scene's exposures agree
        exposures = torch.as_tensor(exposures_np, dtype=ftype, device=dev)
        with stage("assemble_s"):
            for ups in uploads:
                for (t, event), dst in ups:
                    if event is not None:
                        torch.cuda.current_stream(dev).wait_event(event)
                    _dequantize(t, dst)
            if cuda:  # the unhidden upload tail and the dequantization
                torch.cuda.synchronize(dev)
    finally:
        # quiescent buffers only go back to the cache
        for ups in uploads:
            _wait(up for up, _ in ups)
        _return_scene_stack_pool(pool_key, pool)
    log.info("batch_video_to_hdr: %d scenes staged", len(names))

    if calibrate is not None:
        with stage("calibrate_s"):
            icrf_t, icrf_diff_t = _calibrate_from_batch(
                batch_val, exposures, cfg, calibrate)
        log.info("batch_video_to_hdr: merged with the batch-solved ICRF")

    with stage("merge_s"):
        out_val, out_std = hdr_ops.merge_batch(batch_val, batch_std,
                                               exposures, icrf_t,
                                               icrf_diff_t)
        if cuda:
            torch.cuda.synchronize(dev)

    results = {}
    for i, name in enumerate(names):
        hdr_set = ImageSet(file_path=scene_paths[i][0].with_suffix(".tif"),
                           measurand=Measurand(out_val[i], out_std[i]),
                           config=cfg, device=dev)
        hdr_set.is_hdr = True
        results[name] = hdr_set
    return results
