"""Plain NumPy version of the port's uncompressed-AVI reader (``rawvideo``
in ``jpeg.cpp``): the bytes of one frame chunk into the (H, W, 3) BGR
uint8 frame ``cv2.VideoCapture`` gives for it.

cv2 reads such an AVI through FFmpeg 8: the AVI demuxer, the rawvideo
decoder (rawdec.c) and swscale to BGR24 with SWS_BICUBIC.  Each layout,
by the AVI ``strf`` header (``LAYOUTS`` numbers them as ``jpeg.cpp``
does):

* ``BI_RGB`` (compression 0): 8 bits with a palette (pal8, looked up),
  16 bits (RGB555: each 5-bit field as ``v << 3 | v >> 2``), 24 bits
  (B, G, R) and 32 bits (B, G, R, X: the first three bytes).  A positive
  height is bottom-up, a negative one top-down.  A row is its packed
  bytes, or padded to 4 bytes where the chunk holds the padded frame
  (rawdec pads pal8, RGB555, BGR24 and gray8 rows only then);
* ``Y800``/``GREY``/``Y8  `` (gray8): Y in all three channels, rows as
  pal8's, top-down whatever the sign of the height;
* ``I420``/``IYUV`` and ``YV12`` (V plane first): yuv420p, limited
  range, converted as the MJPEG decoder's yuvj420p is
  (``jpeg_plain._ffmpeg_bgr`` and ``_swscale_bgr`` with
  ``SWS_LIMITED``): swscale's unscaled SSSE3 path at an even height, its
  scaled path at an odd one;
* ``Y42B`` (yuv422p, planar): as yuv420p, each chroma row serving one
  row: the unscaled path at an even height, the scaled one at an odd
  one (the port's HuffYUV decoder converts its YUY2 frames so too);
* ``NV12`` (interleaved chroma), ``YUY2`` and ``UYVY`` (packed 4:2:2):
  swscale's scaled path at every size, limited range;
* ``yuv444p`` (``I444``; the planes of a Ut Video ``ULY4``/``ULH4`` frame
  or a yuv444p FFV1 frame) and ``yv24`` (``YV24``: the V plane first, as
  rawdec swaps it): the scaler's full-chroma output at every size, its
  32-bit sums wrapping (a saturated blue comes out 0, as cv2 gives it);
  of rawdec's other yuv444p fourccs cv2 reads neither ``444P`` nor
  ``Y444``;
* ``i420_left`` (no fourcc: the planes of an MPEG-4 Part 2 frame, whose
  chroma FFmpeg's decoder sites left, AVCHROMA_LOC_LEFT): as ``i420``,
  but the scaled path (an odd height) filters the chroma from a sample
  64/256 of a pixel in, not 128/256, as cv2's swscale takes the siting
  from the frame.

The YUV layouts take the BT.601 matrix, or BT.709 (``matrix``) for the
planes of a stream FFmpeg tags so (Ut Video's ``ULH*``), which cv2's
swscale follows.

A chunk shorter than its layout's frame raises here (FFmpeg decodes no
frame from it, and cv2's read loop ends there: ``utils/avi.py`` ends the
stream at it); a longer one is read from its start, as rawdec reads it
(``utils/avi.py`` refuses a file with a chunk of another size than
:func:`chunk_sizes` gives, before any decode).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .jpeg_plain import (SWS_FULL, SWS_LIMITED, SWS_LIMITED_709, _ffmpeg_bgr,
                         _swscale_bgr)

__all__ = ["LAYOUTS", "MATRICES", "FOURCC_LAYOUTS", "DIB_LAYOUTS",
           "frame_bytes", "chunk_sizes", "row_bytes", "decode_bgr"]

# each layout's number in jpeg.cpp's clt_raw_decode_bgr_batch
LAYOUTS = ("pal8", "rgb555", "bgr24", "bgr0", "gray8", "i420", "yv12",
           "nv12", "yuyv422", "uyvy422", "yuv422p", "yuv444p", "i420_left",
           "yv24")

# the YUV layouts' matrices, by their number in jpeg.cpp
MATRICES = ("bt601", "bt709", "bt601_full")

# the fourccs rawdec maps to these layouts; BI_RGB goes by bit count
FOURCC_LAYOUTS = {"I420": "i420", "IYUV": "i420", "YV12": "yv12",
                  "NV12": "nv12", "YUY2": "yuyv422", "UYVY": "uyvy422",
                  "Y800": "gray8", "GREY": "gray8", "Y8": "gray8",
                  "Y42B": "yuv422p", "I444": "yuv444p", "YV24": "yv24"}
DIB_LAYOUTS = {8: "pal8", 16: "rgb555", 24: "bgr24", 32: "bgr0"}

# bytes per pixel of the single-plane layouts; rawdec pads the rows of
# the first four to 4 bytes where the chunk has room
_PIXEL_BYTES = {"pal8": 1, "gray8": 1, "rgb555": 2, "bgr24": 3, "bgr0": 4}
_PADDED = ("pal8", "gray8", "rgb555", "bgr24")


def _half(n: int) -> int:
    return (n + 1) // 2


def frame_bytes(layout: str, height: int, width: int) -> int:
    """The packed size of one frame (av_image_get_buffer_size, align 1)."""
    if layout in _PIXEL_BYTES:
        return height * width * _PIXEL_BYTES[layout]
    if layout in ("yuyv422", "uyvy422"):
        return height * _half(width) * 4
    if layout == "yuv422p":
        return height * width + 2 * height * _half(width)
    if layout in ("yuv444p", "yv24"):
        return 3 * height * width
    return height * width + 2 * _half(height) * _half(width)


def chunk_sizes(layout: str, height: int, width: int) -> tuple:
    """The sizes a frame chunk of ``layout`` is written at: the packed
    frame and, where rawdec reads padded rows, the frame of rows padded
    to 4 bytes."""
    packed = frame_bytes(layout, height, width)
    if layout not in _PADDED:
        return (packed,)
    padded = -(-width * _PIXEL_BYTES[layout] // 4) * 4 * height
    return tuple(sorted({packed, padded}))


def row_bytes(layout: str, width: int, height: int, size: int) -> int:
    """The row stride of a single-plane frame in a chunk of ``size``
    bytes: the packed row, or padded to 4 bytes where the chunk holds
    ``height`` padded rows (rawdec.c)."""
    row = width * _PIXEL_BYTES[layout]
    padded = -(-row // 4) * 4
    return padded if layout in _PADDED and padded * height <= size else row


def decode_bgr(payload, layout: str, height: int, width: int,
               bottom_up: bool = False,
               palette: Optional[np.ndarray] = None,
               matrix: str = "bt601") -> np.ndarray:
    """One chunk's (H, W, 3) BGR uint8 frame.  ``bottom_up``: the rows of
    a BI_RGB frame are stored last first; ``palette``: pal8's (256, 4)
    B, G, R, X entries; ``matrix``: the YUV layouts' (``MATRICES``: the
    rawvideo decoder's BT.601, or BT.709 for the planes of a stream
    tagged so).  Raises ValueError for a chunk shorter than the frame."""
    rng = {"bt601": SWS_LIMITED, "bt709": SWS_LIMITED_709,
           "bt601_full": SWS_FULL}[matrix]
    data = np.frombuffer(payload, np.uint8)
    need = frame_bytes(layout, height, width)
    if data.size < need:
        raise ValueError(f"{layout} frame chunk of {data.size} bytes, "
                         f"expected {need} for {height} x {width}")
    if layout in _PIXEL_BYTES:
        stride = row_bytes(layout, width, height, data.size)
        rows = data[:stride * height].reshape(height, stride)
        rows = rows[::-1] if bottom_up else rows
        px = rows[:, :width * _PIXEL_BYTES[layout]]
        if layout == "pal8":
            return np.ascontiguousarray(palette[px][..., :3])
        if layout == "gray8":
            return np.repeat(px[..., None], 3, -1)
        if layout == "rgb555":
            v = px.reshape(height, width, 2).view("<u2")[..., 0].astype(
                np.int32)
            five = [(v >> s) & 31 for s in (0, 5, 10)]
            return np.stack([(f << 3) | (f >> 2) for f in five],
                            -1).astype(np.uint8)
        return np.ascontiguousarray(
            px.reshape(height, width, -1)[..., :3])
    h2, w2 = _half(height), _half(width)
    if layout in ("yuyv422", "uyvy422"):
        px = data[:need].reshape(height, w2, 4)
        lum, chroma = ((0, 2), (1, 3)) if layout == "yuyv422" else \
            ((1, 3), (0, 2))
        y = np.stack([px[..., lum[0]], px[..., lum[1]]], -1).reshape(
            height, 2 * w2)[:, :width]
        return _swscale_bgr(y, px[..., chroma[0]], px[..., chroma[1]], 1, 0,
                            rng)
    y = data[:height * width].reshape(height, width)
    rest = data[height * width:need]
    if layout in ("yuv444p", "yv24"):
        u, v = rest.reshape(2, height, width)
        if layout == "yv24":
            u, v = v, u
        return _ffmpeg_bgr(y, u, v, subsampled=False, rng=rng)
    if layout == "yuv422p":
        u, v = rest.reshape(2, height, w2)
        if height % 2:
            return _swscale_bgr(y, u, v, 1, 0, rng)
        full = [np.repeat(c, 2, 1)[:, :width] for c in (u, v)]
        return _ffmpeg_bgr(y, *full, subsampled=True, rng=rng)
    if layout == "nv12":
        uv = rest.reshape(h2, w2, 2)
        return _swscale_bgr(y, uv[..., 0], uv[..., 1], 1, 1, rng)
    u, v = rest[:h2 * w2].reshape(h2, w2), rest[h2 * w2:].reshape(h2, w2)
    if layout == "yv12":
        u, v = v, u
    if height % 2:  # swscale's unscaled path takes even heights only
        return _swscale_bgr(y, u, v, 1, 1, rng,
                            h_pos=64 if layout == "i420_left" else 128)
    full = [np.repeat(np.repeat(c, 2, 0), 2, 1)[:height, :width]
            for c in (u, v)]
    return _ffmpeg_bgr(y, *full, subsampled=True, rng=rng)

