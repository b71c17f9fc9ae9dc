"""AVI container reader (pure Python, streaming): MJPG chunks, raw RGBA
frames and the stream's geometry.

Port of ``camera_linearity_tpu/utils/avi.py``, copied (importing the JAX
package would import JAX).  An AVI file is a RIFF tree; the walker goes
through it linearly and yields the video stream's data chunks.  For an MJPG
codec a chunk is a complete JFIF image, handed to the native libjpeg
decoder; for the ``RGBA`` codec (lossless, written by
``cv2.VideoWriter_fourcc(*"RGBA")``) a chunk is one top-down frame of
H * W * 4 bytes in R, G, B, A order, read here with NumPy.  So the port
reads both without a video codec library, and reads exactly the frames
``cv2.VideoCapture`` returns for them.

Handles the OpenDML/AVIX extension OpenCV's writer emits for files >1-2 GB
(the movi data simply continues inside subsequent ``RIFF AVIX`` segments —
the generic descend-into-RIFF/LIST rule covers it) and skips index
(``idx1``/``ix..``), ``JUNK``, and header chunks by the same rule.

Unlike the JAX package's walker, this one tracks the end of every
container it descends into, so a container of odd size (or one holding a
few bytes after its last child) cannot desynchronize the rest of the walk.

Reference decode flow: modules/general_functions.py:226-251
(cv2.VideoCapture frame generator).
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["mjpg_chunks", "probe_avi", "raw_frames", "AviInfo"]

# containers we descend into: their payload is a fourcc + nested chunks
_CONTAINERS = (b"RIFF", b"LIST")


def _chunk_spans(f, data_fourccs) -> Iterator[Tuple[bytes, int]]:
    """Linear RIFF walk yielding ``(fourcc, size)`` of every chunk whose
    fourcc is in ``data_fourccs``, with ``f`` positioned at its payload
    (the consumer may read it; the walk seeks past it either way).

    Each container's end (its size rounded up to a word) is kept on a
    stack: a chunk header that would cross the innermost open container's
    end is not read, and the walk resumes at that end.  Tolerates trailing
    garbage after the last well-formed chunk (truncated writers) by
    stopping cleanly."""
    ends: list = []
    pos = f.tell()
    while True:
        while ends and pos + 8 > ends[-1]:
            pos = max(pos, ends.pop())
        f.seek(pos)
        header = f.read(8)
        if len(header) < 8:
            return
        fourcc, size = struct.unpack("<4sI", header)
        body = pos + 8
        if fourcc in _CONTAINERS:
            ends.append(body + size + (size & 1))
            pos = body + 4  # skip the list/form type, descend into children
            continue
        if fourcc in data_fourccs:
            yield fourcc, size
        pos = body + size + (size & 1)  # RIFF chunks are word-aligned


def _stream_chunks(f, data_fourccs) -> Iterator[bytes]:
    """The payload of every chunk whose fourcc is in ``data_fourccs``; a
    truncated final chunk ends the walk."""
    for _, size in _chunk_spans(f, data_fourccs):
        payload = f.read(size)
        if len(payload) < size:
            return  # truncated final chunk
        yield payload


# the frames of stream 0, where OpenCV writes video: chunks with both the
# compressed (``dc``) and uncompressed (``db``) suffix
_FRAME_FOURCCS = (b"00dc", b"00db")


def mjpg_chunks(path: Path) -> Iterator[bytes]:
    """Yield each video frame's JPEG bytes from an MJPG AVI file (MJPG
    writers use ``00dc`` chunks)."""
    with open(path, "rb", buffering=1 << 20) as f:
        for payload in _stream_chunks(f, _FRAME_FOURCCS):
            yield payload


def _open_avi(f) -> bool:
    """True when ``f`` starts a RIFF AVI form; leaves ``f`` at offset 0."""
    head = f.read(12)
    f.seek(0)
    return len(head) == 12 and head[:4] == b"RIFF" and head[8:] == b"AVI "


def _first_jpeg_sof(path: Path) -> Optional[Tuple[int, int, int]]:
    """(height, width, components) of an AVI's first video frame when it
    is a JPEG, else None."""
    try:
        with open(path, "rb") as f:
            if not _open_avi(f):
                return None
            first = next(_stream_chunks(f, _FRAME_FOURCCS), None)
    except OSError:
        return None
    if first is None or first[:2] != b"\xff\xd8":
        return None
    return _jpeg_sof(first)


def _jpeg_sof(data: bytes) -> Optional[Tuple[int, int, int]]:
    """(height, width, components) from a JPEG's start-of-frame segment."""
    i = 2
    n = len(data)
    while i + 4 <= n:
        if data[i] != 0xFF:
            return None
        marker = data[i + 1]
        if marker == 0xFF:  # 0xFF fill bytes before a marker are legal
            i += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        seg_len = struct.unpack(">H", data[i + 2:i + 4])[0]
        # SOF0..SOF15 except DHT(C4)/JPG(C8)/DAC(CC) carry geometry
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if i + 10 > n:
                return None
            height, width, comps = struct.unpack(">HHB", data[i + 5:i + 10])
            return height, width, comps
        i += 2 + seg_len
    return None


class AviInfo(NamedTuple):
    """An AVI video stream's codec (the BITMAPINFOHEADER's compression
    fourcc, e.g. ``"MJPG"`` or ``"RGBA"``; ``"DIB"`` for uncompressed
    BI_RGB), frame geometry and components per pixel."""
    codec: str
    height: int
    width: int
    components: int


def probe_avi(path: Path) -> Optional[AviInfo]:
    """The first video stream of an AVI file, from its ``strh``/``strf``
    headers, or None when ``path`` is not a readable AVI with a video
    stream.

    For MJPG the geometry and the component count come from the first
    frame's own SOF segment, not the container's header, so a lying
    container cannot route mismatched frames into a fixed-size decode
    buffer (the native decoder re-checks every frame anyway); for other
    codecs from the stream's BITMAPINFOHEADER (components = bits per pixel
    / 8).
    """
    try:
        with open(path, "rb") as f:
            if not _open_avi(f):
                return None
            header = None
            video = False
            for fourcc, size in _chunk_spans(f, (b"strh", b"strf")):
                payload = f.read(size)
                if fourcc == b"strh":
                    video = payload[:4] == b"vids"
                elif video and len(payload) >= 20:
                    header = payload
                    break
    except OSError:
        return None
    if header is None:
        return None
    _, width, height, _, bit_count, compression = struct.unpack(
        "<IiiHH4s", header[:20])
    codec = "DIB" if compression == b"\0\0\0\0" else \
        compression.decode("latin-1").strip()
    if codec == "MJPG":
        sof = _first_jpeg_sof(path)
        if sof is None:
            return None
        return AviInfo(codec, *sof)
    return AviInfo(codec, abs(height), width, bit_count // 8)


def raw_frames(path: Path) -> Iterator[np.ndarray]:
    """Yield each frame of an ``RGBA`` AVI as an (H, W, 3) BGR uint8 view,
    the frame ``cv2.VideoCapture`` returns for it.

    Frames are top-down rows of R, G, B, A bytes whatever the sign of the
    header's height (OpenCV's writer stores them so).  Every view aliases
    one reused buffer: it is valid until the next frame is requested, so
    a consumer copies it out first.  A chunk of another size than
    H * W * 4 bytes raises ValueError; a truncated final chunk ends the
    stream.
    """
    info = probe_avi(path)
    if info is None or info.codec != "RGBA":
        raise ValueError(f"{path} is not an RGBA AVI (probed {info})")
    h, w = info.height, info.width
    buf = np.empty((h, w, 4), np.uint8)
    flat = memoryview(buf.reshape(-1))
    bgr = buf[..., 2::-1]
    with open(path, "rb", buffering=0) as f:
        for _, size in _chunk_spans(f, _FRAME_FOURCCS):
            if size != buf.size:
                raise ValueError(f"{path}: frame chunk of {size} bytes, "
                                 f"expected {h} x {w} x 4 = {buf.size}")
            got = 0
            while got < size:
                n = f.readinto(flat[got:])
                if not n:
                    return  # truncated final chunk
                got += n
            yield bgr
