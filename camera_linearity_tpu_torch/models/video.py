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

Decoders.  The machine with the card has no OpenCV and no libjpeg, so the
port reads the AVI containers it knows itself (``utils/avi.py``): a
lossless ``RGBA`` AVI with NumPy (``"raw"``); the uncompressed layouts
FFmpeg's rawvideo decoder reads (BI_RGB at 8 bits with its palette, 16,
24 and 32 bits, either row order; ``Y800``/``GREY``/``Y8``; ``I420``/
``IYUV``/``YV12``; ``Y42B``; ``NV12``; ``YUY2``/``UYVY``) with the port's
own reader (``"rawvideo"``, ``native.raw_decode_bgr_batch`` in
``native/jpeg.cpp``),
which gives cv2's bytes for each (the YUV layouts through swscale's
limited-range BT.601 conversion), while 1/2/4-bit BI_RGB, BI_BITFIELDS,
palette changes and chunks longer than the frame (other than its padded
size) raise before any decode, and a chunk shorter than the frame ends
the video, as cv2's read loop ends there; the lossless compressed AVIs
ImageJ/Fiji and ``cv2.VideoWriter`` write with the port's own decoders,
giving cv2's bytes: PNG (``MPNG``, ``PNG1``, ``png ``; ``"png"``,
``native.png_decode_bgr_batch``: every colour type at 8 and 16 bits,
gray at 1-4 bits, palettes, Adam7; a later frame that is no PNG or whose
``IHDR`` differs from the first one's raises, naming it)
and HuffYUV (``HFYU``, ``FFVH``; ``"huffyuv"``,
``native.huffyuv_decode_bgr_batch``: RGB24, RGB32, YUY2 and yuv420p with
the left, gradient and median predictors, v1 and v2 headers; per-frame
tables and ffvhuff's v3 formats raise); the lossless video of
moving-image archives and ``cv2.VideoWriter(fourcc "FFV1")``, FFV1
(``"ffv1"``, ``native.ffv1_decode_bgr_batch``, a decoder object a video
keeping each slice's states from frame to frame: versions 0-3, both
coders, custom state tables, context models 0 and 1, any slice grid and
GOP, RGB with or without alpha, gray8, gray16, yuv420p, yuv422p and
yuv444p; version 4, more than 8 bits for RGB or YUV, alpha beside gray or
YUV, yuv440p/411p/410p and Bayer raise before any decode, and a slice
whose CRC fails, whose size runs past its chunk, or a first frame that
is no keyframe raises naming the frame and the slice); the lossless video
of capture tools and ``cv2.VideoWriter(fourcc "ULY0")``, Ut Video
(``ULRG``, ``ULRA``, ``ULY0``, ``ULY2``, ``ULY4``, ``ULH0``, ``ULH2``,
``ULH4``; ``"utvideo"``, ``native.utvideo_decode_bgr_batch``: every
predictor, slice count and the interlaced flag, BT.709 for the ``ULH``
fourccs; the 10-bit Pro and the pack-mode fourccs raise before any
decode, and a damaged frame raises naming the frame, plane and slice);
the lossless video of VirtualDub-era capture setups, Lagarith (``LAGS``;
``"lagarith"``, ``native.lagarith_decode_bgr_batch``: RGB24, RGBA, YUY2,
YV12 and solid frames, every escape form, mixed in one stream, null
frames skipped as cv2 skips them; the uncompressed, old arithmetic RGB
and reduced-resolution frame types raise, the first frame's before any
decode and a later one's naming it, and so does a damaged frame, naming
the frame and plane);
an MJPG AVI with the port's
own JPEG decoder (``native/jpeg.cpp``) in one of three modes.  ``"ffmpeg"``,
the default, gives the bytes ``cv2.VideoCapture`` gives (FFmpeg's MJPEG
decoder and swscale), which is what the JAX package decodes at its default
(``CL_DECODER=cv2``), for every frame FFmpeg decodes as gray or
yuvj444p/422p/420p/411p/440p, sequential or progressive, at any size
(grayscale comes out as three equal channels, as cv2 gives it); it ends a
file at a frame where cv2's stream ends (data that stops before the first
scan), and raises, naming the frame, where FFmpeg would conceal an error.
``"turbo"`` and ``"turbo_fast"`` give
libjpeg-turbo's bytes, as the JAX package's modes of those names do: its
JDCT_ISLOW IDCT and fancy upsampling, or its JDCT_IFAST IDCT and merged
upsampling.  An MJPG AVI always takes that decoder: a frame mode it does
not read, or a failed build, raises before any frame is decoded.  Any
other codec goes through ``cv2.VideoCapture`` when cv2 imports, and raises
otherwise.
``cv2`` is imported only when a video needs it.  ``process_video`` and
``process_directory`` write the mean/std frames as TIFFs through the
port's own codec (``utils/tiff.py``).
"""
from __future__ import annotations

import itertools
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
from ..utils import avi, containers, io
from ..utils.device import canonical_float, resolve_device
from ..utils.general import (set_thread_priority,
                             stage_to_device_async)
from ..utils.observability import (decoded_frames, get_logger, stage,
                                   stage_times)

Tensor = torch.Tensor

__all__ = ["probe_geometry", "video_frame_generator", "welford_algorithm",
           "compute_noise_profiles", "clean_data_edges", "calculate_std",
           "process_STD_data", "process_video", "process_directory",
           "DECODERS"]

# what a caller may ask for; "auto" reads env CL_DECODER (default "native":
# an MJPG AVI then decodes in the JPEG decoder's "ffmpeg" mode, as cv2 does)
DECODERS = ("native", "cv2", "turbo", "turbo_fast", "ffmpeg")


def _cv2(why: str):
    """cv2, imported on first need; a ValueError saying ``why`` it was
    needed when it is not installed."""
    try:
        import cv2
    except ImportError as exc:
        raise ValueError(
            f"{why} needs cv2, which is not installed; without it the port "
            "reads AVI, QuickTime MOV, MP4 and Matroska (MKV, WebM) files "
            "of these codecs: RGBA (decoder 'native', NumPy), uncompressed "
            "(BI_RGB 8/16/24/32-bit, "
            + ", ".join(f.strip() for f in avi.FOURCC_LAYOUTS)
            + ": 'native', its own reader), PNG ("
            + ", ".join(repr(f.ljust(4)) if len(f) < 4 else f
                        for f in avi.PNG_CODECS)
            + "), HuffYUV (" + ", ".join(avi.HUFFYUV_CODECS)
            + "), FFV1 (" + ", ".join(avi.FFV1_CODECS)
            + "), UtVideo (" + ", ".join(avi.UTVIDEO_READ)
            + "), Lagarith (" + ", ".join(avi.LAGARITH_CODECS)
            + "), MPEG-4 Part 2 (" + ", ".join(avi.MPEG4_CODECS)
            + "; V_MPEG4/ISO/*: the Simple Profile and Xvid and DivX 5 "
            "Advanced Simple streams, B-VOPs, packed bitstreams and MPEG "
            "quantisation among them; not quarter-pel or GMC) and H.264 ("
            + ", ".join(avi.H264_CODECS)
            + "; V_MPEG4/ISO/AVC: the Constrained Baseline tools, CAVLC, I "
            "and P slices; not CABAC or B slices) ('native', "
            "its own decoders) and MJPG (jpeg, V_MJPEG; 'native' / "
            "'ffmpeg' / 'turbo' / 'turbo_fast', its own JPEG decoder)"
        ) from exc
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


# the batch buffers an edit list's hidden frames and a turned video's
# frames are decoded into before they are dropped or turned (a cache of
# their own: in _HOST_BUFFERS they would push the decode pools out)
_SCRATCH_BUFFERS = _BufferCache()


def _frame_fillers(path: Path, decoder: str, batch_size: int = 1
                   ) -> Iterator[Callable[[np.ndarray], int]]:
    """Callables that decode the next frames of ``path`` into the (k, H, W,
    C) uint8 array they are given and return how many they decoded (0:
    the stream ended): :func:`_decoded_fillers`' frames as cv2 shows them.
    Where the container's edit list hides frames the decoder gives
    (``SampleTable.skip`` first, those after ``shown``), they are decoded
    and dropped; where its
    display matrix turns the picture (``AviInfo.rotation``), each frame is
    decoded into a buffer of the stored geometry and turned into the
    caller's (H and W swapped for a quarter turn), a band of rows a thread
    on every core."""
    info = None if decoder == "cv2" else containers.probe_video(path)
    fillers = _decoded_fillers(path, decoder, batch_size, info)
    table = None if info is None else info.samples
    skip = 0 if table is None else table.skip
    left = None if table is None else table.shown   # frames still shown
    turn = 0 if info is None else info.rotation
    if not skip and left is None and not turn:
        yield from fillers
        return
    # the hidden frames and the unturned ones are decoded into a batch
    # buffer of the stored geometry, kept warm from video to video
    key, scratch = None, None

    def batch(chs: int) -> np.ndarray:
        # checked out on first need: an edit list that only ends early
        # decodes straight into the caller's array
        nonlocal key, scratch
        if scratch is None:
            key = (max(batch_size, 1), info.height, info.width, chs)
            scratch = _SCRATCH_BUFFERS.checkout(
                key, lambda: host_buffer(key, np.uint8))
        return scratch

    def shown(dst: np.ndarray, fill) -> int:
        nonlocal skip, left
        while skip:
            hidden = batch(dst.shape[-1])
            got = fill(hidden[:min(skip, len(hidden))])
            if not got:
                return 0
            skip -= got
        k = len(dst) if left is None else min(len(dst), left)
        if not k:
            return 0
        if not turn:
            got = fill(dst[:k])
        else:
            stored = batch(dst.shape[-1])
            got = fill(stored[:min(k, len(stored))])
            turn_frames(stored[:got], dst[:got], turn)
        if left is not None:
            left -= got
        return got
    try:
        for fill in fillers:
            yield lambda dst, fill=fill: shown(dst, fill)
    finally:
        if scratch is not None:
            _SCRATCH_BUFFERS.give_back(key, scratch)


def turn_frames(src: np.ndarray, dst: np.ndarray, turn: int) -> None:
    """Copy (k, H, W, C) frames turned ``turn`` degrees clockwise (90, 180
    or 270, as cv2 turns a video by its display matrix) into ``dst``, a
    band of output rows a task on the native thread pool."""
    if not len(src):
        return
    # a pixel's channels move as one element (a C-byte void): numpy then
    # copies pixels, not bytes, and runs about twice as fast
    pixel = np.dtype((np.void, src.shape[-1]))
    src, dst = src.view(pixel)[..., 0], dst.view(pixel)[..., 0]
    turned = np.rot90(src, -(turn // 90), axes=(1, 2))
    rows = dst.shape[1]
    bands = min(rows, max(1, os.cpu_count() or 1) * 2)
    if src[0].size < (1 << 18) or bands == 1:
        np.copyto(dst, turned)
        return
    edges = np.linspace(0, rows, bands + 1).astype(int)
    list(native._thread_pool().map(
        lambda i: np.copyto(dst[:, edges[i]:edges[i + 1]],
                            turned[:, edges[i]:edges[i + 1]]),
        range(bands)))


def _decoded_fillers(path: Path, decoder: str, batch_size: int,
                     info: Optional[avi.AviInfo]
                     ) -> Iterator[Callable[[np.ndarray], int]]:
    """Callables that decode the next frames of ``path`` (``info``: its
    ``containers.probe_video``, None for cv2) into the (k, H, W, C) uint8
    array they are given, at the stored geometry, and return how many
    they decoded (0: the stream ended).  The MJPEG decoder and the raw
    RGBA reader take up to k frames a call, and
    the rawvideo reader and the PNG, HuffYUV, FFV1, UtVideo, Lagarith and
    MPEG-4 Part 2 decoders up to ``batch_size``, on all cores (FFV1 a
    slice a thread, Lagarith a plane a thread, MPEG-4 a macroblock row a
    thread; FFV1 and MPEG-4 with one decoder object for the video, which
    carries the slices' states, or the predictors and the reference
    picture, from call to call); cv2 takes one.  Every decoder but cv2
    yields one callable again and again, which may be called any number
    of times; cv2 yields one for each frame it grabbed, to be called
    once (it is never given an edit list or a turn to apply)."""
    if decoder == "raw":
        frames = containers.rgba_frames(path, info)

        def fill_raw(dst: np.ndarray) -> int:
            for got in range(len(dst)):
                frame = next(frames, None)
                if frame is None:
                    return got
                np.copyto(dst[got], frame)
            return len(dst)
        while True:
            yield fill_raw
    elif decoder == "mpeg4":
        chunks = containers.frame_chunks(path, info, ring=batch_size)
        mpeg4 = native.Mpeg4Decoder(*avi.mpeg4_params(info), info.height,
                                    info.width)
        mpeg4.matrix = _container_matrix(info)
        # the yuv420p planes, reused from call to call
        planes = np.empty(batch_size * native.frame_bytes(
            "i420_left", info.height, info.width), np.uint8)
        ended = False

        def fill_mpeg4(dst: np.ndarray) -> int:
            # an N-VOP gives no frame: read on until one does or the
            # stream ends, where an N-VOP last gives the last frame again
            nonlocal ended
            while not ended:
                payloads = list(itertools.islice(chunks, min(len(dst),
                                                             batch_size)))
                if not payloads:
                    ended = True
                    return native.mpeg4_flush(mpeg4, dst)
                try:
                    got = native.mpeg4_decode_bgr_batch(
                        payloads, dst[:len(payloads)], mpeg4, planes=planes)
                except ValueError as exc:
                    raise ValueError(f"{path}: {exc}") from exc
                if got:
                    return got
            return 0
        while True:
            yield fill_mpeg4
    elif decoder == "h264":
        chunks = containers.frame_chunks(path, info, ring=batch_size)
        h264 = native.H264Decoder(avi.h264_params(info))
        h264.matrix = _container_matrix(info)
        # the yuv420p planes, reused from call to call
        planes = np.empty(batch_size * native.frame_bytes(
            "i420_left", info.height, info.width), np.uint8)

        def fill_h264(dst: np.ndarray) -> int:
            # a sample of parameter sets gives no frame: read on until one
            # does or the stream ends
            while True:
                payloads = list(itertools.islice(chunks, min(len(dst),
                                                             batch_size)))
                if not payloads:
                    return 0
                try:
                    got = native.h264_decode_bgr_batch(
                        payloads, dst[:len(payloads)], h264, planes=planes)
                except ValueError as exc:
                    raise ValueError(f"{path}: {exc}") from exc
                if got:
                    return got
        while True:
            yield fill_h264
    elif decoder in ("rawvideo", "png", "huffyuv", "ffv1", "utvideo",
                     "lagarith"):
        # every chunk of a call is read into a buffer of its own
        if decoder == "rawvideo":
            chunks = containers.raw_chunks(path, info, ring=batch_size)
            matrix = _container_matrix(info) or "bt601"
            decode = lambda payloads, dst, first: native.raw_decode_bgr_batch(
                payloads, dst, info.layout, bottom_up=info.raw.bottom_up,
                palette=info.raw.palette, first_frame=first, matrix=matrix)
        elif decoder == "png":
            chunks = containers.frame_chunks(path, info, ring=batch_size)
            decode = lambda payloads, dst, first: native.png_decode_bgr_batch(
                payloads, dst, info.png, first_frame=first)
        elif decoder == "ffv1":
            chunks = containers.frame_chunks(path, info, ring=batch_size)
            ffv1 = native.Ffv1Decoder(avi.ffv1_params(info), info.height,
                                      info.width)
            ffv1.matrix = _container_matrix(info) or "bt601"
            # the YUV layouts' planes, reused from call to call
            planes = None if ffv1.layout is None else np.empty(
                batch_size * native.frame_bytes(ffv1.layout, info.height,
                                                info.width), np.uint8)
            decode = lambda payloads, dst, first: \
                native.ffv1_decode_bgr_batch(payloads, dst, ffv1,
                                             planes=planes)
        elif decoder == "utvideo":
            chunks = containers.frame_chunks(path, info, ring=batch_size)
            params = avi.utvideo_params(info)
            layout = native.utvideo_plain.yuv_layout(params)
            # the YUV layouts' planes, reused from call to call
            planes = None if layout is None else np.empty(
                batch_size * native.frame_bytes(layout, info.height,
                                                info.width), np.uint8)
            decode = lambda payloads, dst, first: \
                native.utvideo_decode_bgr_batch(
                    payloads, dst, params, planes=planes, first_frame=first)
        elif decoder == "lagarith":
            chunks = containers.frame_chunks(path, info, ring=batch_size)
            # the YUY2 and YV12 frames' planes, reused from call to call
            planes = np.empty(batch_size * native.frame_bytes(
                "yuv422p", info.height, info.width), np.uint8)
            decode = lambda payloads, dst, first: \
                native.lagarith_decode_bgr_batch(
                    payloads, dst, planes=planes, first_frame=first)
        else:
            chunks = containers.frame_chunks(path, info, ring=batch_size)
            params = avi.huffyuv_params(info)
            layout = native.huffyuv_plain.yuv_layout(params)
            # the YUV layouts' planes, reused from call to call
            planes = None if layout is None else np.empty(
                batch_size * native.frame_bytes(layout, info.height,
                                                info.width), np.uint8)
            decode = lambda payloads, dst, first: \
                native.huffyuv_decode_bgr_batch(
                    payloads, dst, params, first_frame=first, planes=planes)
        done = 0      # frames decoded so far

        def fill_chunks(dst: np.ndarray) -> int:
            nonlocal done
            payloads = list(itertools.islice(chunks, min(len(dst),
                                                         batch_size)))
            if not payloads:
                return 0
            try:
                decode(payloads, dst[:len(payloads)], done)
            except ValueError as exc:
                raise ValueError(f"{path}: {exc}") from exc
            done += len(payloads)
            return len(payloads)
        while True:
            yield fill_chunks
    elif decoder in native.JPEG_MODES:
        chunks = containers.mjpg_chunks(path, info)
        if decoder == "ffmpeg":  # FFmpeg's AVI reader drops empty chunks
            chunks = (c for c in chunks if len(c))
        done = 0      # frames decoded so far
        ended = False

        def fill_mjpg(dst: np.ndarray) -> int:
            nonlocal done, ended
            payloads = [] if ended else list(
                itertools.islice(chunks, len(dst)))
            if not payloads:
                return 0
            try:
                got = native.jpeg_decode_bgr_batch(
                    payloads, dst[:len(payloads)], mode=decoder,
                    first_frame=done)
            except ValueError as exc:
                raise ValueError(f"{path}: {exc}") from exc
            # a frame cv2 gives no frame for ends the stream there
            ended = got < len(payloads)
            done += got
            return got
        while True:
            yield fill_mjpg
    else:
        cv = _cv2(f"decoding {path}")
        video = cv.VideoCapture(str(path))
        if not video.isOpened():
            video.release()
            raise ValueError(f"Unable to open video file at {path}")

        def fill(dst: np.ndarray) -> int:
            ret, frame = video.retrieve(dst[0])
            if ret and frame is not dst[0]:
                np.copyto(dst[0], frame)  # codec returned its own buffer
            return int(ret)
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
        for fill in _frame_fillers(file_path, decoder, batch_size):
            got = fill(buf[filled:])
            if not got:
                break
            filled += got
            count += got
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
                       mode: str) -> str:
    """The decoder a file's container asks for, checked against the
    expected geometry (the shown one: turned by the display matrix) and
    channel count before any decode.  An MJPG
    decodes to three channels in the ``"ffmpeg"`` mode whatever its
    component count (cv2 gives BGR for grayscale too), to its component
    count in the ``"turbo"`` modes; RGBA, the rawvideo layouts, PNG,
    HuffYUV, FFV1, UtVideo and Lagarith to three.  An uncompressed, PNG,
    HuffYUV, FFV1, UtVideo or Lagarith stream the port's decoders do not
    read raises here, naming what (``containers.raw_unsupported``,
    ``avi.png_unsupported``, ``avi.huffyuv_unsupported``,
    ``avi.ffv1_unsupported``, ``avi.utvideo_unsupported``,
    ``avi.lagarith_unsupported``), and so do colour tags of the container
    that the conversion does not follow (:func:`_colour_unsupported`); so
    does one whose decoder did not build (RuntimeError)."""
    own = info is not None and (
        info.codec in ("RGBA", "MJPG") + avi.PNG_CODECS + avi.HUFFYUV_CODECS
        + avi.FFV1_CODECS + avi.UTVIDEO_CODECS + avi.LAGARITH_CODECS
        + avi.MPEG4_CODECS + avi.H264_CODECS or info.layout is not None)
    kind = "AVI" if info is None else info.container_name
    if info is not None and not own:
        unsupported = containers.raw_unsupported(path, info)
        if unsupported:
            raise ValueError(f"{path} is an uncompressed {kind} "
                             f"({info.codec_name}) whose frames the port's "
                             f"rawvideo reader does not read: {unsupported}")
    if not own:
        codec = "not an AVI, MOV, MP4 or Matroska file" if info is None \
            else f"codec {info.codec!r}" if info.container == "avi" \
            else f"{kind} codec {info.codec_name!r}"
        _cv2(f"{path} ({codec})")
        return "cv2"
    comps = info.components if info.codec == "MJPG" and mode != "ffmpeg" \
        else 3
    geometry = _shown_geometry(info)
    if geometry != (height, width):
        raise ValueError(f"{path} has frame geometry {geometry}, "
                         f"expected {(height, width)}")
    if comps != chs:
        raise ValueError(
            f"{path} is a {info.codec_name} {kind} of {info.components} "
            f"components, which decode to {comps} channels; the config "
            f"has num_of_chs={chs}")
    yuv = False
    if info.codec == "RGBA":
        decoder, why, libs = "raw", None, ()
    elif info.codec in avi.PNG_CODECS:
        decoder, why, libs = "png", avi.png_unsupported(info), ("png",)
    elif info.codec in avi.HUFFYUV_CODECS:
        decoder, why = "huffyuv", avi.huffyuv_unsupported(info)
        # the YUV layouts (12 and 16 bits a pixel) convert through
        # jpeg.cpp's rawvideo reader
        yuv = not why and avi.huffyuv_params(info).bpp < 24
        libs = ("huffyuv", "mjpeg") if yuv else ("huffyuv",)
    elif info.codec in avi.FFV1_CODECS:
        decoder, why = "ffv1", avi.ffv1_unsupported(info)
        # the YUV layouts convert through jpeg.cpp's rawvideo reader
        yuv = not why and native.ffv1_plain.yuv_layout(info.ffv1)
        libs = ("ffv1", "mjpeg") if yuv else ("ffv1",)
    elif info.codec in avi.UTVIDEO_CODECS:
        decoder, why = "utvideo", avi.utvideo_unsupported(info)
        # the YUV layouts convert through jpeg.cpp's rawvideo reader
        yuv = not why and native.utvideo_plain.yuv_layout(
            avi.utvideo_params(info))
        libs = ("utvideo", "mjpeg") if yuv else ("utvideo",)
    elif info.codec in avi.LAGARITH_CODECS:
        decoder, why = "lagarith", avi.lagarith_unsupported(path, info)
        # any frame may be YUY2 or YV12, whose planes convert through
        # jpeg.cpp's rawvideo reader
        yuv, libs = True, ("lagarith", "mjpeg")
    elif info.codec in avi.MPEG4_CODECS:
        decoder, why = "mpeg4", avi.mpeg4_unsupported(path, info)
        # its yuv420p planes convert through jpeg.cpp's rawvideo reader
        yuv, libs = True, ("mpeg4", "mjpeg")
    elif info.codec in avi.H264_CODECS:
        decoder, why = "h264", avi.h264_unsupported(path, info)
        # its yuv420p planes convert through jpeg.cpp's rawvideo reader
        yuv, libs = True, ("h264", "mjpeg")
    elif info.layout:
        decoder, libs = "rawvideo", ("mjpeg",)
        why = containers.raw_unsupported(path, info)
        yuv = info.layout not in ("pal8", "rgb555", "bgr24", "bgr0")
    else:
        decoder, libs = mode, ("mjpeg",)
        why = "no start-of-frame segment in its first frame" \
            if info.jpeg is None else avi.jpeg_unsupported(info.jpeg,
                                                           mode=mode)
        why = why and f"{why} (in its {mode!r} mode)"
    why = why or _colour_unsupported(info, decoder, bool(yuv))
    if why:
        raise ValueError(f"{path} is a {info.codec_name} {kind} whose "
                         f"frames the port's "
                         f"{_DECODER_NAMES.get(decoder, 'JPEG')} decoder "
                         f"does not read: {why}")
    for lib in libs:
        if not getattr(native, f"{lib}_available")():
            raise RuntimeError(
                f"{path} is a {info.codec_name} {kind} but "
                f"native/{_SOURCES[lib]}, which decodes it, did not build: "
                f"{native.build_error('_' + lib)}")
    return decoder


def _shown_geometry(info: avi.AviInfo) -> Tuple[int, int]:
    """(H, W) of a stream's frames as cv2 shows them: swapped where the
    display matrix turns them a quarter."""
    if info.rotation in (90, 270):
        return info.width, info.height
    return info.height, info.width


def _container_matrix(info: avi.AviInfo) -> Optional[str]:
    """The rawvideo converter's matrix the container's colour tags name
    (``"bt709"`` for matrix_coefficients 1, ``"bt601"`` for 5 and 6), None
    where they name none."""
    matrix = None if info.colour is None else info.colour[0]
    return {1: "bt709", 5: "bt601", 6: "bt601"}.get(matrix)


def _colour_unsupported(info: avi.AviInfo, decoder: str, yuv: bool
                        ) -> Optional[str]:
    """What of the container's colour tags (MP4 ``colr``, Matroska
    ``Colour``; FFmpeg hands them to the decoder, and cv2's conversion
    follows the frame's) the port does not convert by, or None: on YUV
    frames a matrix other than BT.601, BT.709 or none, or a full-range
    signal; BT.709 on the YUV frames of a decoder the tag does not reach
    (HuffYUV, UtVideo, Lagarith), or on MJPEG (whose frames FFmpeg gives
    as full-range BT.601).  RGB frames take no matrix, so their tags are
    not asked about."""
    jpeg = decoder in native.JPEG_MODES
    if info.colour is None or not (yuv or jpeg):
        return None
    matrix, full = info.colour
    tags = (f"the {info.container_name}'s colour tags (matrix_coefficients "
            f"{matrix}{', full range' if full else ''})")
    if matrix not in (1, 2, 5, 6):
        return f"{tags}: the port converts by BT.601 and BT.709 only"
    if jpeg:
        return f"{tags}: BT.709 on MJPEG" if matrix == 1 else None
    if full:
        return f"{tags}: a full-range YUV signal"
    if matrix == 1 and decoder not in ("rawvideo", "mpeg4", "ffv1", "h264"):
        return f"{tags}: BT.709 on {_DECODER_NAMES[decoder]} YUV frames"
    return None


# the port's own decoders by name, and the native sources they build from
_DECODER_NAMES = {"png": "PNG", "huffyuv": "HuffYUV", "rawvideo": "rawvideo",
                  "ffv1": "FFV1", "utvideo": "UtVideo",
                  "lagarith": "Lagarith", "mpeg4": "MPEG-4 Part 2",
                  "h264": "H.264"}
_SOURCES = {"png": "png.cpp", "huffyuv": "huffyuv.cpp", "mjpeg": "jpeg.cpp",
            "ffv1": "ffv1.cpp", "utvideo": "utvideo.cpp",
            "lagarith": "lagarith.cpp", "mpeg4": "mpeg4.cpp",
            "h264": "h264.cpp"}


def _resolve_decoder(decoder: str, file_paths: List[Path], height: int,
                     width: int, chs: int) -> List[str]:
    """Each file's decoder: ``"raw"``, ``"rawvideo"``, ``"png"``,
    ``"huffyuv"``, ``"ffv1"``, ``"utvideo"``, ``"lagarith"``, ``"mpeg4"``,
    ``"h264"``, ``"ffmpeg"``, ``"turbo"``, ``"turbo_fast"`` or ``"cv2"``.

    ``"auto"`` reads env ``CL_DECODER`` (default ``"native"``).
    ``"native"``: the container decides — an RGBA AVI reads raw, the other
    uncompressed layouts through the port's rawvideo reader (cv2's bytes:
    BI_RGB 8/16/24/32-bit, Y800/GREY/Y8, I420/IYUV/YV12, Y42B, NV12,
    YUY2/UYVY), PNG, HuffYUV, FFV1, UtVideo, Lagarith and MPEG-4 Part 2
    AVIs (the Simple Profile, and the Advanced Simple streams Xvid and
    DivX 5 write: B-VOPs, packed bitstreams, MPEG quantisation, the Xvid
    IDCT) and H.264 files (AVI, MP4/MOV ``avc1``/``avc3``, Matroska
    ``V_MPEG4/ISO/AVC``: the Constrained Baseline tools) through the
    port's PNG, HuffYUV, FFV1, UtVideo, Lagarith, MPEG-4 and H.264
    decoders (cv2's bytes), an MJPG AVI through the port's JPEG decoder in
    its ``"ffmpeg"`` mode (cv2's bytes, as the JAX package's default gives
    them), anything else (MS-MPEG4, HEVC, ...) through cv2 when it imports
    (else a ValueError naming the codec).
    ``"ffmpeg"``/``"turbo"``/``"turbo_fast"``: that decoder's modes on MJPG
    files; another container logs a warning and takes its own decoder.
    ``"cv2"``: cv2 for every file.  RGBA, rawvideo, PNG, HuffYUV, FFV1,
    UtVideo, Lagarith, MPEG-4, H.264 and MJPG files are checked against the
    expected geometry and ``chs`` before any decode; a PNG, HuffYUV, FFV1,
    UtVideo, Lagarith, MPEG-4 or H.264 stream the decoders do not read
    raises then, naming it (``avi.png_unsupported``, ``avi.huffyuv_unsupported``,
    ``avi.ffv1_unsupported``, ``avi.utvideo_unsupported``,
    ``avi.lagarith_unsupported``: the first frame's type,
    ``avi.mpeg4_unsupported``: the VOL and the first VOP, which refuse
    quarter-pel, GMC/S-VOPs, interlaced VOLs and the rest by name;
    ``avi.h264_unsupported``: the parameter sets and the first slice
    header, which refuse CABAC, B slices, interlaced coding and the rest
    by name);
    1/2/4-bit BI_RGB, BI_BITFIELDS, palette-change chunks and a frame
    chunk longer than the frame (not its padded size) raise then, naming
    what; and an MJPG's
    first frame for a JPEG mode the decoder does not read (it names it):
    in the ``"turbo"`` modes a grayscale, progressive or 4:1:1 MJPG raises
    here, not mid-run, and in every mode a lossless, arithmetic-coded or
    12-bit one; so does an MJPG AVI where the decoder did not build
    (RuntimeError).
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
        info = containers.probe_video(p)
        if decoder != "native" and (info is None or info.codec != "MJPG"):
            get_logger().warning(
                "decoder=%s requested but %s is not an MJPG AVI (nor MJPEG "
                "in MOV, MP4 or Matroska); using its container's decoder",
                decoder, p)
        mode = "ffmpeg" if decoder == "native" else decoder
        out.append(_container_decoder(p, info, height, width, chs, mode))
    return out


_PREFETCH_DONE = object()


def _prefetch(iterator: Iterator[np.ndarray], depth: int = 2
              ) -> Iterator[np.ndarray]:
    """Run ``iterator`` on a background thread, handing items over through a
    bounded queue — double-buffers host video decode against downstream
    statistics and transfer.  NumPy copies, the native decoders and OpenCV
    release the GIL, so on multi-core hosts the next batch decodes while
    the consumer works on the current one; exceptions raised by the
    producer re-raise at the consumer."""
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
        staged, event = stage_to_device_async(batch, device)
        if event is not None:
            torch.cuda.current_stream(device).wait_event(event)
        yield staged
        if event is not None:
            event.synchronize()
    # only on clean completion: an abandoned producer thread may still be
    # decoding into the pool
    _return_host_buffers(key, buffers)


def probe_geometry(video_path: Path) -> Tuple[int, int]:
    """(height, width) of a video file's frames as cv2 gives them: from the
    headers of the containers the port reads itself (AVI, MOV/MP4,
    Matroska; turned by the display matrix, as cv2 turns the frames), else
    from cv2."""
    info = containers.probe_video(video_path)
    if info is not None:
        return _shown_geometry(info)
    cv = _cv2(f"probing {video_path} (not an AVI, MOV, MP4 or Matroska "
              "file the port reads)")
    video = cv.VideoCapture(str(video_path))
    if not video.isOpened():
        video.release()
        raise ValueError(f"Unable to open video file at {video_path}")
    width = int(video.get(cv.CAP_PROP_FRAME_WIDTH))
    height = int(video.get(cv.CAP_PROP_FRAME_HEIGHT))
    video.release()
    return height, width


def video_frame_generator(video_path: Path, decoder: str = "auto"
                          ) -> Iterator[Optional[np.ndarray]]:
    """Yield the (H, W, 3) BGR uint8 frames of a video, then None
    (general_functions.py:226-251), decoded by ``decoder`` (see
    :func:`_resolve_decoder`)."""
    height, width = probe_geometry(video_path)
    dec = _resolve_decoder(decoder, [video_path], height, width, 3)[0]
    for fill in _frame_fillers(video_path, dec):
        frame = np.empty((1, height, width, 3), np.uint8)
        if not fill(frame):
            break
        yield frame[0]
    yield None


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


def _save_frame(save_path: Path, arr: np.ndarray) -> None:
    """uint8 frames as they are; float frames as 64-bit tifs."""
    if arr.dtype == np.uint8:
        save_path.parent.mkdir(parents=True, exist_ok=True)
        io._imwrite(str(save_path), arr)
    else:
        io.save_image(save_path, arr)


def process_video(video_path: Path, ICRF=None, use_std: bool = True,
                  config: CameraConfig = DEFAULT_CONFIG,
                  quantize: bool = False, decoder: str = "auto",
                  device=None) -> None:
    """Mean/std frames of one video, saved as tifs beside it
    (video_processing.py:222-236).  Float (64-bit tif) outputs by
    default; ``quantize=True`` writes the reference's uint8 frames.
    ``device`` is the device backend's (with an ICRF)."""
    ret = welford_algorithm(video_path, ICRF, use_std, config=config,
                            quantize=quantize, decoder=decoder,
                            device=device)
    for key, arr in ret.items():
        if arr is not None:
            with stage("write_s"):
                _save_frame(video_path.parent.joinpath(
                    _output_name(video_path, key)), arr)


def _output_name(video_path: Path, key: str) -> str:
    """``process_video``'s file name for a statistic: the JAX package's
    (``.avi`` replaced by ``.<key>.tif``) for an AVI, ``<stem>.<key>.tif``
    for any other name, which the JAX package's replace left unchanged, so
    that it wrote the TIFFs over the video itself."""
    name = video_path.name
    if name.endswith(".avi"):
        return name.replace(".avi", f".{key}.tif")
    return f"{video_path.stem}.{key}.tif"


def process_directory(dir_path: Path, ICRF=None, separately: bool = True,
                      config: CameraConfig = DEFAULT_CONFIG,
                      quantize: bool = False, decoder: str = "auto",
                      device=None) -> None:
    """Process every .avi in a directory (video_processing.py:239-274):
    separately, into ``mean/<name>.tif`` and ``std/<name> STD.tif``, or
    pooled into ``total_mean.tif`` and ``total_std.tif``.  Float outputs
    by default, like :func:`process_video`.  The writes' time accumulates
    under ``write_s`` in ``utils.observability.stage_times``."""
    video_files = sorted(dir_path.glob("*.avi"))
    if not separately:
        ret = welford_algorithm(list(video_files), ICRF, use_std=True,
                                config=config, quantize=quantize,
                                decoder=decoder, device=device)
        for key, arr in ret.items():
            if arr is not None:
                with stage("write_s"):
                    _save_frame(dir_path.joinpath(f"total_{key}.tif"), arr)
        return
    for path in video_files:
        ret = welford_algorithm(path, ICRF, use_std=True, config=config,
                                quantize=quantize, decoder=decoder,
                                device=device)
        for key, arr in ret.items():
            if arr is None:
                continue
            name = path.name.replace(".avi", " STD.tif" if key == "std"
                                     else ".tif")
            with stage("write_s"):
                _save_frame(path.parent.joinpath(key, name), arr)
