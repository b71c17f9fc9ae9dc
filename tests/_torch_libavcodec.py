"""cv2's bundled libavcodec, loaded through ``ctypes``: a video's decoded
planes as FFmpeg gives them, before swscale's conversion to BGR.

``cv2.VideoCapture`` hides some differences in its BGR frames (luma under
16 clips to 0, swscale averages chroma) and gives unwritten memory for
some frames (interlaced UtVideo); the port's tests hold its decoders to
the planes this returns there.  It loads the ``libavformat`` and
``libavcodec`` of ``opencv_python.libs/`` (FFmpeg 8: the struct offsets
below are that version's) and decodes on one thread (the context's
default).  :func:`available` is False where the libraries are not found;
tests that use it skip then.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["available", "decode_planes", "pixel_format"]

# FFmpeg 8's struct offsets (x86-64)
_STREAMS = 48          # AVFormatContext.streams
_CODECPAR = 16         # AVStream.codecpar
_STREAM_INDEX = 36     # AVPacket.stream_index
_DATA, _LINESIZE = 0, 64                 # AVFrame.data[8], linesize[8]
_WIDTH, _HEIGHT, _FORMAT = 104, 108, 116  # AVFrame.width, height, format

_libs: Optional[Tuple[ctypes.CDLL, ctypes.CDLL, ctypes.CDLL]] = None
_tried = False


def _find(stem: str) -> Optional[Path]:
    try:
        import cv2
    except ImportError:
        return None
    root = Path(cv2.__file__).resolve().parent.parent / "opencv_python.libs"
    found = sorted(root.glob(f"{stem}-*.so*"))
    return found[0] if found else None


def _load():
    global _libs, _tried
    if _tried:
        return _libs
    _tried = True
    paths = [_find(s) for s in ("libavutil", "libavcodec", "libavformat")]
    if not all(paths):
        return None
    try:
        util, codec, fmt = (ctypes.CDLL(str(p), mode=ctypes.RTLD_GLOBAL)
                            for p in paths)
    except OSError:
        return None
    vp, i = ctypes.c_void_p, ctypes.c_int
    fmt.avformat_open_input.argtypes = [ctypes.POINTER(vp), ctypes.c_char_p,
                                        vp, vp]
    fmt.avformat_find_stream_info.argtypes = [vp, vp]
    fmt.av_find_best_stream.argtypes = [vp, i, i, i, ctypes.POINTER(vp), i]
    fmt.av_read_frame.argtypes = [vp, vp]
    fmt.avformat_close_input.argtypes = [ctypes.POINTER(vp)]
    codec.avcodec_alloc_context3.argtypes = [vp]
    codec.avcodec_alloc_context3.restype = vp
    codec.avcodec_parameters_to_context.argtypes = [vp, vp]
    codec.avcodec_open2.argtypes = [vp, vp, vp]
    codec.avcodec_send_packet.argtypes = [vp, vp]
    codec.avcodec_receive_frame.argtypes = [vp, vp]
    codec.avcodec_free_context.argtypes = [ctypes.POINTER(vp)]
    codec.av_packet_alloc.restype = vp
    codec.av_packet_unref.argtypes = [vp]
    codec.av_packet_free.argtypes = [ctypes.POINTER(vp)]
    util.av_frame_alloc.restype = vp
    util.av_frame_unref.argtypes = [vp]
    util.av_frame_free.argtypes = [ctypes.POINTER(vp)]
    util.av_get_pix_fmt_name.argtypes = [i]
    util.av_get_pix_fmt_name.restype = ctypes.c_char_p
    _libs = (util, codec, fmt)
    return _libs


def available() -> bool:
    """True where cv2's libavcodec and libavformat load."""
    return _load() is not None


def _at(ptr: int, offset: int, kind=ctypes.c_void_p):
    return kind.from_address(ptr + offset).value


def pixel_format(code: int) -> str:
    util, _, _ = _load()
    return util.av_get_pix_fmt_name(code).decode()


def decode_planes(path) -> List[Tuple[str, List[np.ndarray]]]:
    """Every frame FFmpeg outputs for the first video stream of ``path``,
    flush included: (pixel format name, [plane, ...]) with each plane a
    (rows, bytes) uint8 copy of the frame's visible part (chroma planes of
    a 4:2:0 or 4:2:2 format at their subsampled size)."""
    util, codec, fmt = _load()
    vp = ctypes.c_void_p
    ctx_fmt = vp()
    if fmt.avformat_open_input(ctypes.byref(ctx_fmt), str(path).encode(),
                               None, None) < 0:
        raise OSError(f"libavformat cannot open {path}")
    dec = vp()
    pkt, frame, ctx = None, None, None
    out: List[Tuple[str, List[np.ndarray]]] = []
    try:
        fmt.avformat_find_stream_info(ctx_fmt, None)
        index = fmt.av_find_best_stream(ctx_fmt, 0, -1, -1,
                                        ctypes.byref(dec), 0)
        if index < 0:
            raise OSError(f"no video stream in {path}")
        streams = _at(ctx_fmt.value, _STREAMS)
        stream = _at(streams, 8 * index)
        ctx = vp(codec.avcodec_alloc_context3(dec))
        codec.avcodec_parameters_to_context(ctx, _at(stream, _CODECPAR))
        if codec.avcodec_open2(ctx, dec, None) < 0:
            raise OSError(f"libavcodec cannot open the decoder of {path}")
        pkt = vp(codec.av_packet_alloc())
        frame = vp(util.av_frame_alloc())

        def drain():
            while codec.avcodec_receive_frame(ctx, frame) == 0:
                out.append(_planes(frame.value))
                util.av_frame_unref(frame)
        while fmt.av_read_frame(ctx_fmt, pkt) >= 0:
            if _at(pkt.value, _STREAM_INDEX, ctypes.c_int) == index:
                codec.avcodec_send_packet(ctx, pkt)
                drain()
            codec.av_packet_unref(pkt)
        codec.avcodec_send_packet(ctx, None)
        drain()
    finally:
        if frame is not None:
            util.av_frame_free(ctypes.byref(frame))
        if pkt is not None:
            codec.av_packet_free(ctypes.byref(pkt))
        if ctx is not None:
            codec.avcodec_free_context(ctypes.byref(ctx))
        fmt.avformat_close_input(ctypes.byref(ctx_fmt))
    return out


# (width shift, height shift) of the chroma planes a format has
_CHROMA = {"yuv420p": (1, 1), "yuvj420p": (1, 1), "yuv422p": (1, 0),
           "yuvj422p": (1, 0), "yuv444p": (0, 0), "yuvj444p": (0, 0),
           "gbrp": (0, 0), "gbrap": (0, 0), "yuva420p": (1, 1),
           "yuva422p": (1, 0), "yuva444p": (0, 0)}


def _planes(frame: int) -> Tuple[str, List[np.ndarray]]:
    w = _at(frame, _WIDTH, ctypes.c_int)
    h = _at(frame, _HEIGHT, ctypes.c_int)
    name = pixel_format(_at(frame, _FORMAT, ctypes.c_int))
    if name not in _CHROMA:
        raise ValueError(f"pixel format {name} is not read here")
    sx, sy = _CHROMA[name]
    planes = []
    for k in range(4 if name.startswith(("yuva", "gbra")) else 3):
        data = _at(frame, _DATA + 8 * k)
        stride = _at(frame, _LINESIZE + 4 * k, ctypes.c_int)
        pw, ph = (w, h) if k in (0, 3) else (-(-w >> sx), -(-h >> sy))
        rows = (ctypes.c_uint8 * (stride * (ph - 1) + pw)).from_address(
            data)
        arr = np.frombuffer(rows, np.uint8, count=stride * (ph - 1) + pw)
        planes.append(np.lib.stride_tricks.as_strided(
            arr, (ph, pw), (stride, 1)).copy())
    return name, planes
