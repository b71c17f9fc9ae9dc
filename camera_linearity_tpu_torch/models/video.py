"""Video processing: streaming mean/std frames, noise profiles, STD data.

Port of ``camera_linearity_tpu/models/video.py`` (reference:
modules/video_processing.py).  Frames decode on the host into a rotating
pool of preallocated batch buffers on a prefetch thread; the statistics
accumulate either on the host as exact integer moments (``native``) or on
the device as a Welford loop of tensor ops (ops/welford.py).  The
reference's uint8 quantization of outputs is available behind
``quantize=True`` — including its bug of rounding the [0,1]-scaled std
straight to uint8 (video_processing.py:214-215, almost always 0); the
default returns float arrays.

Decoders.  The machine with the card has no OpenCV, so the port reads the
AVI containers it knows itself (``utils/avi.py``): a lossless ``RGBA`` AVI
with NumPy (``"raw"``), an MJPG AVI with the native libjpeg decoder
(``"turbo"``; ``"turbo_fast"`` adds JDCT_IFAST).  Any other codec goes
through ``cv2.VideoCapture`` when cv2 imports, and raises otherwise.
``cv2`` is imported only when a video needs it.  Writing mean/std TIFFs
(``process_video`` / ``process_directory``) waits for the port's image
codec (ROADMAP queue 1 item 5).
"""
from __future__ import annotations

import os
import queue
import threading
from collections import OrderedDict
from pathlib import Path
from time import perf_counter
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import native
from ..config import CameraConfig, DEFAULT_CONFIG
from ..ops import welford as wf
from ..utils import avi, io
from ..utils.device import canonical_float, resolve_device
from ..utils.general import set_thread_priority, stage_to_device
from ..utils.observability import (decoded_frames, get_logger, stage,
                                   stage_times)

Tensor = torch.Tensor

__all__ = ["probe_geometry", "welford_algorithm", "compute_noise_profiles",
           "clean_data_edges", "calculate_std", "process_STD_data",
           "DECODERS"]

# what a caller may ask for; "auto" reads env CL_DECODER (default "native")
DECODERS = ("native", "cv2", "turbo", "turbo_fast")


def _cv2(why: str):
    """cv2, imported on first need; a ValueError saying ``why`` it was
    needed when it is not installed."""
    try:
        import cv2
    except ImportError as exc:
        raise ValueError(
            f"{why} needs cv2, which is not installed; without it the port "
            "reads RGBA AVIs (decoder 'native', NumPy) and MJPG AVIs "
            "('native' / 'turbo' / 'turbo_fast', libjpeg)") from exc
    return cv2


class _BufferCache:
    """Warm host buffers by key (geometry and kind), exclusive while
    checked out.

    A checkout REMOVES a buffer set, so two concurrent runs of one geometry
    never decode or accumulate into each other's buffers; a give-back puts
    it back warm for the next call.  Bounded: at most ``per_key`` idle sets
    per key and ``keys`` keys, the least recently returned dropped first (a
    4K decode pool is ~1.6 GB).
    """

    def __init__(self, keys: int = 2, per_key: int = 2) -> None:
        self._lock = threading.Lock()
        self._idle: "OrderedDict[tuple, list]" = OrderedDict()
        self._keys, self._per_key = keys, per_key

    def checkout(self, key: tuple, make: Callable[[], object]):
        with self._lock:
            idle = self._idle.get(key)
            if idle:
                buffers = idle.pop()
                if not idle:
                    del self._idle[key]
                return buffers
        return make()

    def give_back(self, key: tuple, buffers) -> None:
        with self._lock:
            idle = self._idle.setdefault(key, [])
            if len(idle) < self._per_key:
                idle.append(buffers)
            self._idle.move_to_end(key)
            while len(self._idle) > self._keys:
                self._idle.popitem(last=False)

    def __contains__(self, key) -> bool:
        return key in self._idle


def host_buffer(shape, dtype, pinned: bool = False) -> np.ndarray:
    """A prefaulted host array: page-locked (``pin_memory``) for
    asynchronous copies to the card, else a dedicated anonymous mmap
    (``native.mmap_buffer``)."""
    if not pinned:
        return native.mmap_buffer(shape, dtype)
    dt = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dt.itemsize
    pinned_bytes = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                               pin_memory=True)
    # the array keeps the pinned tensor alive (its base)
    return pinned_bytes.numpy()[:nbytes].view(dt).reshape(shape)


# decode pools (and the host backend's moment accumulators)
_HOST_BUFFERS = _BufferCache()
_POOL_SIZE = 4  # > prefetch depth 2 + 1: queued, consumer's, being filled


def _checkout_host_buffers(batch_size: int, height: int, width: int,
                           chs: int, pinned: bool = False):
    """Check out an EXCLUSIVE ``(pool, accumulators)`` set: a decode pool
    of ``_POOL_SIZE`` batch buffers and, for the host backend, a pair of
    moment accumulators (the device backend's pool is ``pinned`` and has
    none).  Callers return the set with ``_return_host_buffers`` once the
    run is done with it."""
    key = (batch_size, height, width, chs, pinned)

    def make():
        pool = [host_buffer((batch_size, height, width, chs), np.uint8,
                            pinned) for _ in range(_POOL_SIZE)]
        if pinned:
            return pool, None
        return pool, (native.mmap_buffer((height, width, chs), np.uint64),
                      native.mmap_buffer((height, width, chs), np.uint64))
    return key, _HOST_BUFFERS.checkout(key, make)


def _return_host_buffers(key, buffers) -> None:
    _HOST_BUFFERS.give_back(key, buffers)


def _frame_fillers(path: Path, decoder: str
                   ) -> Iterator[Callable[[np.ndarray], bool]]:
    """One callable per frame of ``path`` that decodes the frame into the
    (H, W, C) uint8 array it is given and returns True (False: the stream
    ended).  The raw reader reads each frame when the iterator advances;
    the others decode inside the call."""
    if decoder == "raw":
        for frame in avi.raw_frames(path):
            yield lambda dst, frame=frame: np.copyto(dst, frame) or True
    elif decoder in ("turbo", "turbo_fast"):
        fast = decoder == "turbo_fast"
        for payload in avi.mjpg_chunks(path):
            yield lambda dst, payload=payload: native.jpeg_decode_bgr(
                payload, dst, fast=fast) or True
    else:
        cv = _cv2(f"decoding {path}")
        video = cv.VideoCapture(str(path))
        if not video.isOpened():
            video.release()
            raise ValueError(f"Unable to open video file at {path}")

        def fill(dst: np.ndarray) -> bool:
            ret, frame = video.retrieve(dst)
            if ret and frame is not dst:
                np.copyto(dst, frame)  # codec returned its own buffer
            return bool(ret)
        try:
            while video.grab():
                yield fill
        finally:
            video.release()


def _frame_batches_into(file_paths: List[Path], batch_size: int,
                        pool: List[np.ndarray], prefetch_depth: int,
                        decoders: List[str]) -> Iterator[np.ndarray]:
    """Decode frames directly into a rotating pool of preallocated batch
    buffers and yield views of them: full batches, then one final shorter
    batch if frames remain.

    Fresh 25 MB frame allocations cost more than the decode itself on some
    hosts (first-touch page faults); reusing warm buffers keeps the loop at
    the decoder's own rate.  Safe together with ``_prefetch`` only while
    ``len(pool) > depth + 1`` (depth buffers queued, one in the consumer's
    hands, one being filled): callers declare the prefetch depth they will
    wrap this iterator with.  The consumer must be done with a yielded view
    — an asynchronous copy of it included — by the time it requests the
    next batch.  ``decoders`` names each file's decoder
    (:func:`_resolve_decoder`); each decoder's frames are counted in
    ``utils.observability.decoded_frames``.
    """
    if len(pool) <= prefetch_depth + 1:
        raise ValueError(
            f"decode pool of {len(pool)} buffers cannot back a prefetch "
            f"depth of {prefetch_depth}: need len(pool) > depth + 1 "
            "(queued buffers + consumer's view + the one being filled) or "
            "yielded views are overwritten while still in use")
    slot = 0
    filled = 0
    buf = pool[slot]
    for file_path, decoder in zip(file_paths, decoders):
        t0 = perf_counter()
        count = 0
        for fill in _frame_fillers(file_path, decoder):
            if not fill(buf[filled]):
                break
            filled += 1
            count += 1
            if filled == batch_size:
                # decode busy-time only: the clock pauses across the yield
                stage_times.add("decode_s", perf_counter() - t0)
                decoded_frames.add(decoder, count)
                count = 0
                yield buf
                t0 = perf_counter()
                slot = (slot + 1) % len(pool)
                buf = pool[slot]
                filled = 0
        stage_times.add("decode_s", perf_counter() - t0)
        decoded_frames.add(decoder, count)
    if filled:
        yield buf[:filled]


def _container_decoder(path: Path, info: Optional[avi.AviInfo],
                       height: int, width: int, chs: int,
                       fast: bool) -> str:
    """The decoder a file's container asks for, checked against the
    expected geometry and channel count before any decode."""
    if info is not None and info.codec in ("RGBA", "MJPG"):
        comps = 3 if info.codec == "RGBA" else info.components
        geometry = (info.height, info.width)
        if geometry != (height, width):
            raise ValueError(f"{path} has frame geometry {geometry}, "
                             f"expected {(height, width)}")
        if comps != chs:
            raise ValueError(
                f"{path} is a {info.codec} AVI of {info.components} "
                f"components, which decode to {comps} channels; the config "
                f"has num_of_chs={chs}")
        if info.codec == "RGBA":
            return "raw"
        if native.mjpeg_available():
            return "turbo_fast" if fast else "turbo"
        get_logger().warning(
            "%s is MJPG but the native MJPEG decoder is unavailable (%s); "
            "decoding with cv2", path, native.build_error("_mjpeg"))
    codec = "not an AVI" if info is None else f"codec {info.codec!r}"
    _cv2(f"{path} ({codec})")
    return "cv2"


def _resolve_decoder(decoder: str, file_paths: List[Path], height: int,
                     width: int, chs: int) -> List[str]:
    """Each file's decoder: ``"raw"``, ``"turbo"``, ``"turbo_fast"`` or
    ``"cv2"``.

    ``"auto"`` reads env ``CL_DECODER`` (default ``"native"``).
    ``"native"``: the container decides — an RGBA AVI reads raw, an MJPG
    AVI through libjpeg, anything else through cv2 when it imports (else a
    ValueError naming the codec).  ``"turbo"``/``"turbo_fast"``: libjpeg
    on MJPG files; another container logs a warning and takes its own
    decoder.  ``"cv2"``: cv2 for every file.  RGBA and MJPG files are
    checked against the expected geometry and ``chs`` before any decode: a
    grayscale MJPG raises here, not mid-run.
    """
    if decoder == "auto":
        decoder = os.environ.get("CL_DECODER", "native")
    if decoder not in DECODERS:
        raise ValueError(f"unknown decoder {decoder!r}; expected 'auto' or "
                         f"one of {DECODERS}")
    if decoder == "cv2":
        _cv2("decoder='cv2'")
        return ["cv2"] * len(file_paths)
    out = []
    for p in file_paths:
        info = avi.probe_avi(p)
        if decoder != "native" and (info is None or info.codec != "MJPG"):
            get_logger().warning(
                "decoder=%s requested but %s is not an MJPG AVI; using its "
                "container's decoder", decoder, p)
        out.append(_container_decoder(p, info, height, width, chs,
                                      fast=decoder == "turbo_fast"))
    return out


_PREFETCH_DONE = object()


def _prefetch(iterator: Iterator[np.ndarray], depth: int = 2
              ) -> Iterator[np.ndarray]:
    """Run ``iterator`` on a background thread, handing items over through a
    bounded queue — double-buffers host video decode against downstream
    statistics and transfer.  NumPy copies, libjpeg and OpenCV release the
    GIL, so on multi-core hosts the next batch decodes while the consumer
    works on the current one; exceptions raised by the producer re-raise at
    the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)

    def worker():
        # decode is the pipeline's critical path: boost it above transfer
        set_thread_priority(-5)
        try:
            for item in iterator:
                q.put(item)
            q.put(_PREFETCH_DONE)
        except BaseException as exc:  # noqa: BLE001 — re-raised downstream
            q.put(exc)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _PREFETCH_DONE:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _staged_batches(file_paths: List[Path], batch_size: int,
                    device: torch.device, decoders: List[str],
                    shape: Tuple[int, int, int]) -> Iterator[Tensor]:
    """Decoded uint8 frame batches as tensors on ``device``, the current
    stream ordered after each batch's copy.  On CUDA the decode pool is
    pinned and each copy asynchronous; a pool buffer goes back to the
    decoder once its copy has completed (checked before the next batch is
    taken, which is what ``_frame_batches_into`` asks of a consumer)."""
    key, buffers = _checkout_host_buffers(batch_size, *shape,
                                          pinned=device.type == "cuda")
    pool = buffers[0]
    batches = _frame_batches_into(file_paths, batch_size, pool,
                                  prefetch_depth=2, decoders=decoders)
    for batch in _prefetch(batches, depth=2):
        staged, event = stage_to_device(batch, device)
        if event is not None:
            torch.cuda.current_stream(device).wait_event(event)
        yield staged
        if event is not None:
            event.synchronize()
    # only on clean completion: an abandoned producer thread may still be
    # decoding into the pool
    _return_host_buffers(key, buffers)


def probe_geometry(video_path: Path) -> Tuple[int, int]:
    """(height, width) of a video file's frames: from the AVI headers for
    the containers the port reads itself, else from cv2."""
    info = avi.probe_avi(video_path)
    if info is not None:
        return info.height, info.width
    cv = _cv2(f"probing {video_path} (not an AVI the port reads)")
    video = cv.VideoCapture(str(video_path))
    if not video.isOpened():
        video.release()
        raise ValueError(f"Unable to open video file at {video_path}")
    width = int(video.get(cv.CAP_PROP_FRAME_WIDTH))
    height = int(video.get(cv.CAP_PROP_FRAME_HEIGHT))
    video.release()
    return height, width


def welford_algorithm(file_paths: Union[Path, List[Path]],
                      ICRF=None,
                      use_std: bool = False,
                      config: CameraConfig = DEFAULT_CONFIG,
                      batch_size: int = 32,
                      quantize: bool = False,
                      backend: str = "auto",
                      dtype=np.float64,
                      out=None,
                      decoder: str = "auto",
                      device=None) -> Dict[str, np.ndarray]:
    """Mean (and std-of-mean) frame over all frames of the given videos
    (video_processing.py:161-219), as numpy arrays.

    Frames linearize through the ICRF LUT on the device when one is given
    (fixing the reference's ``if ICRF:`` array-truthiness bug,
    video_processing.py:200).  ``quantize=True`` opts into the reference's
    uint8 outputs, including its bug of rounding the [0,1]-scale std
    straight to uint8.  ``dtype`` selects the output float type (float32
    narrows on the final store); the pair ``native.WIRE_U16F16`` writes the
    u16-mean + f16-std host->device wire encoding instead.
    ``out=(mean, std)`` writes results into caller-provided ``dtype``
    arrays (e.g. slices of an exposure stack); with fewer than two frames
    no std exists, and ``out``'s std is zero-filled.

    ``backend`` selects where the statistics accumulate:

    * ``"device"`` — the Welford loop of ops/welford.py on ``device`` (by
      default the card; without one it raises), in the device's canonical
      float, over staged uint8 batches of ``batch_size`` frames.
    * ``"host"`` — exact integer moment accumulation (``native.HostMoments``)
      directly on the raw uint8 frames; no device is used.  Only valid
      without an ICRF (linearized frames are no longer integer DN).
    * ``"auto"`` — ``"host"`` without an ICRF, else ``"device"``.

    ``decoder`` (see :func:`_resolve_decoder`) applies to both backends;
    frames decode on a prefetch thread into a reused buffer pool, and the
    frames each decoder produced are counted in
    ``utils.observability.decoded_frames``.
    """
    if not isinstance(file_paths, list):
        file_paths = [file_paths]
    if backend not in ("auto", "device", "host"):
        raise ValueError(f"unknown backend {backend!r}")
    wire = isinstance(dtype, (tuple, list))
    if quantize and wire:
        raise ValueError("quantize=True is incompatible with a wire dtype "
                         "pair (outputs are already integer-encoded)")
    if wire and tuple(np.dtype(d) for d in dtype) != native.WIRE_U16F16:
        raise ValueError("welford_algorithm: the only supported dtype pair "
                         "is native.WIRE_U16F16")
    if backend == "host" and ICRF is not None:
        raise ValueError("backend='host' accumulates raw integer DN and "
                         "cannot apply an ICRF; use backend='device'")
    if backend == "auto":
        backend = "host" if ICRF is None else "device"
    if backend == "device":
        dev = resolve_device(device)

    height, width = probe_geometry(file_paths[0])
    max_dn = config.max_dn
    chs = config.num_of_chs
    decoders = _resolve_decoder(decoder, file_paths, height, width, chs)

    if backend == "host":
        with stage("buffers_s"):
            buf_key, (pool, bufs) = _checkout_host_buffers(
                min(batch_size, 16), height, width, chs)
        acc = native.HostMoments((height, width, chs), 1.0 / max_dn,
                                 _buffers=bufs)
        batches = _frame_batches_into(file_paths, pool[0].shape[0], pool,
                                      prefetch_depth=2, decoders=decoders)
        for batch in _prefetch(batches, depth=2):
            with stage("stats_s"):
                acc.update(batch)
        with stage("finalize_s"):
            mean_np, std_np = acc.finalize(use_std=use_std, dtype=dtype,
                                           out=out)
        # return only on CLEAN completion: finalize has read the
        # accumulators and the prefetch producer is exhausted
        _return_host_buffers(buf_key, (pool, bufs))
        if use_std and std_np is None and out is not None:
            out[1][...] = 0  # <2 frames: zeros, not np.empty garbage
    else:
        ftype = canonical_float(dev)
        icrf_dev = None if ICRF is None else torch.as_tensor(ICRF,
                                                             device=dev)
        state = wf.welford_init((height, width, chs), ftype, dev)
        n_frames = 0
        # one loop for full and short batches: nothing compiles per shape
        for staged in _staged_batches(file_paths, batch_size, dev, decoders,
                                      (height, width, chs)):
            n_frames += staged.shape[0]
            if icrf_dev is not None:
                state = wf.welford_update_batch_lut(state, staged, icrf_dev,
                                                    max_dn)
            else:
                state = wf.welford_update_batch(
                    state, staged.to(ftype) / max_dn)

        want_std = use_std and n_frames >= 2
        mean, std = wf.welford_finalize(state, use_std=want_std)
        mean_np = mean.cpu().numpy()
        std_np = std.cpu().numpy() if want_std else None
        if wire:
            # quantize with the shared NumPy reference, so device- and
            # host-backend runs produce the same encoding
            mean_np, std_np = native.wire_quantize_u16f16(mean_np, std_np,
                                                          out=out)
            if out is not None and use_std and not want_std:
                out[1][...] = 0
            return {"mean": mean_np, "std": std_np}
        mean_np = mean_np.astype(dtype, copy=False)
        std_np = None if std_np is None else std_np.astype(dtype,
                                                           copy=False)
        if out is not None:
            out[0][...] = mean_np
            mean_np = out[0]
            if std_np is not None:
                out[1][...] = std_np
                std_np = out[1]
            elif use_std:  # <2 frames: zero the slice, not garbage
                out[1][...] = 0

    if quantize:
        mean_np = np.around(mean_np * max_dn).astype(np.uint8)
        if std_np is not None:
            # reference rounds the [0,1]-scale std directly (bug kept
            # behind the quantize flag; video_processing.py:214-215)
            std_np = np.around(std_np).astype(np.uint8)
    return {"mean": mean_np, "std": std_np}


def compute_noise_profiles(video_files: List[Path],
                           config: CameraConfig = DEFAULT_CONFIG,
                           batch_size: int = 16, decoder: str = "auto",
                           device=None):
    """Per-channel 2-D histograms of (mean DN, observed DN) occupancy
    (video_processing.py:77-106): ``(profiles (bits, bits, C) int64, mean
    frame (H, W, C) uint8)``, numpy.

    The mean frame comes from the host statistics; the counting runs on
    ``device`` (by default the card): one ``torch.bincount`` per channel
    and batch over the combined key ``mean * bits + frame``, where the
    reference scatters with ``np.add.at``.  Keys beyond ``bits * bits`` are
    dropped, as the JAX package's ``segment_sum`` drops them.
    """
    dev = resolve_device(device)
    bits = config.bits
    chs = config.num_of_chs
    mean_frame = welford_algorithm(video_files, None, False, config=config,
                                   quantize=True, decoder=decoder)["mean"]
    shape = mean_frame.shape
    base = torch.as_tensor(mean_frame.astype(np.int64), device=dev) * bits
    profiles = torch.zeros((chs, bits * bits), dtype=torch.int64,
                           device=dev)
    for video_file in video_files:
        decs = _resolve_decoder(decoder, [video_file], shape[0], shape[1],
                                chs)
        for staged in _staged_batches([video_file], batch_size, dev, decs,
                                      shape):
            keys = (base + staged.long()).reshape(-1, chs)
            for c in range(chs):
                profiles[c] += torch.bincount(
                    keys[:, c], minlength=bits * bits)[:bits * bits]
    return (profiles.T.reshape(bits, bits, chs).cpu().numpy(),
            mean_frame)


def clean_data_edges(base_data_arr: np.ndarray,
                     config: CameraConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Smooth noise-distribution edges and enforce monotonicity toward each
    distribution's center (video_processing.py:12-74).

    Inherently sequential per-row smoothing over a (bits, bits) table —
    small host-side data, kept in NumPy (copied from the JAX package).
    """
    arr = base_data_arr.copy()
    min_dn, max_dn = config.min_dn, config.max_dn
    for i in range(config.bits):
        dist = arr[i, :]
        center = i

        m = center - 1
        while m > min_dn:
            if dist[m] == 0 and dist[m - 1] == 0:
                dist[:m] = 0
                break
            if dist[m - 1] >= dist[m] or dist[m + 1] <= dist[m]:
                dist[m] = (dist[m - 1] + dist[m + 1]) // 2
            m -= 1

        m = center + 1
        while m < max_dn:
            if dist[m] == 0 and dist[m + 1] == 0:
                dist[m:] = 0
                break
            if dist[m + 1] >= dist[m] or dist[m - 1] <= dist[m]:
                dist[m] = (dist[m - 1] + dist[m + 1]) // 2
            m += 1

        m = min_dn + 1
        while m < center:
            if dist[m] == 0 and dist[m - 1] != 0 and dist[m + 1] != 0:
                dist[m] = dist[m - 1]
            elif dist[m] == dist[m + 1] and dist[m] != 0:
                dist[m + 1] += 1
                m -= 1
            m += 1

        m = max_dn - 1
        while m > center:
            if dist[m] == 0 and dist[m - 1] != 0 and dist[m + 1] != 0:
                dist[m] = dist[m + 1]
            elif dist[m] == dist[m - 1] and dist[m] != 0:
                dist[m - 1] += 1
                m += 1
            m -= 1

        arr[i, :] = dist
    return arr


def calculate_std(mean_data_array, config: CameraConfig = DEFAULT_CONFIG,
                  device=None) -> Tensor:
    """Expected std per signal level from the noise histograms
    (video_processing.py:109-133), vectorized over all DN rows at once
    (the reference loops rows and has an unimported ``math.sqrt``).  Rows
    with zero counts yield 0.  Runs on the tensor's device, or on
    ``device`` (by default the card) for numpy input, in the device's
    canonical float."""
    if isinstance(mean_data_array, Tensor):
        data = mean_data_array
        dev = data.device
    else:
        data = np.asarray(mean_data_array)
        dev = resolve_device(device)
    data = torch.as_tensor(data, dtype=canonical_float(dev), device=dev)
    datapoints = data.shape[1]
    edges = torch.linspace(0.0, 1.0, datapoints, dtype=data.dtype,
                           device=dev)
    counts = torch.sum(data, dim=1)
    safe = torch.where(counts == 0, torch.ones_like(counts), counts)
    mean = torch.sum(data * edges, dim=1) / safe
    var = torch.sum((edges - mean[:, None]) ** 2 * data, dim=1) / safe
    return torch.where(counts == 0, torch.zeros_like(var), torch.sqrt(var))


def process_STD_data(config: CameraConfig = DEFAULT_CONFIG,
                     pass_result: bool = True,
                     device=None) -> Optional[np.ndarray]:
    """Condense per-channel mean-data tables to the per-DN STD LUT and
    save it (video_processing.py:136-158); :func:`calculate_std` runs on
    ``device`` (by default the card)."""
    cfg = config
    std_data = np.zeros((cfg.max_dn + 1, cfg.num_of_chs))
    for i, mean_file in enumerate(cfg.mean_data_files):
        table = io.read_txt_to_array(mean_file, cfg.data_path)
        std_data[:, i] = calculate_std(table, cfg, device=device
                                       ).cpu().numpy()
    io.save_txt(Path(cfg.data_path).joinpath(cfg.std_file_name), std_data)
    return std_data if pass_result else None
