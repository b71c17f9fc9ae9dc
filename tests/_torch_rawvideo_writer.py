"""Uncompressed AVI writer for the port's rawvideo tests (NumPy + struct,
no cv2).

``write_raw_avi`` writes one video stream in the layouts the port's
reader takes (``camera_linearity_tpu_torch/native/rawvideo_plain.py``):

* ``BI_RGB`` (compression 0) at 8 bits (a palette after the header), 16
  bits (RGB555), 24 bits (B, G, R) and 32 bits (B, G, R, X), as camera
  SDKs and ImageJ/Fiji's "Save As AVI, uncompressed" write them: rows
  padded to 4 bytes, bottom-up for a positive height, top-down for a
  negative one, ``00db`` chunks;
* the YUV and gray fourccs (``I420``, ``IYUV``, ``YV12``, ``NV12``,
  ``YUY2``, ``UYVY``, ``Y800``, ``GREY``, ``Y8  ``) as
  ``cv2.VideoWriter(path, cv2.CAP_FFMPEG, fourcc, ...)`` writes them:
  top-down unpadded planes, the height positive, ``00dc`` chunks, and
  ``biBitCount`` 12 for the 4:2:0 fourccs, 8 for the gray ones (16 for
  YUY2/UYVY, which cv2's writer does not write in their own layout: its
  ``YUY2`` file holds 4:2:0 frames under a 12-bit header and reads back
  as no frame).

``encode_frame`` packs a frame of a layout into its chunk's bytes.

``write_avi`` writes the container of both this writer and
``tests/_torch_mjpeg_writer.py``: the video as stream ``stream``, beside
``others`` (:class:`Stream`: PCM audio from :func:`pcm_stream`, a second
video from :func:`video_stream`), whose chunks (``NNwb``, ``NNdc``) are
interleaved with the frames, and optionally an ``idx1`` index.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Iterable, List, NamedTuple, Optional, Sequence

import numpy as np

# each fourcc's bits per pixel as cv2's writer (or the format) states it
BIT_COUNT = {"I444": 24, "YV24": 24, "I420": 12, "IYUV": 12, "YV12": 12, "NV12": 12, "YUY2": 16,
             "UYVY": 16, "Y800": 8, "GREY": 8, "Y8  ": 8}


def _pad_rows(rows: np.ndarray) -> np.ndarray:
    """(H, n) bytes -> (H, n rounded up to 4) with zero padding."""
    h, n = rows.shape
    out = np.zeros((h, -(-n // 4) * 4), np.uint8)
    out[:, :n] = rows
    return out


def encode_frame(codec: str, frame, bit_count: int = 0,
                 top_down: bool = False) -> bytes:
    """One frame's chunk bytes.

    ``codec`` ``"DIB"`` (BI_RGB) takes, by ``bit_count``: 8, an (H, W)
    palette index array; 16, (H, W) uint16 RGB555 words; 24, (H, W, 3)
    B, G, R; 32, (H, W, 4) B, G, R, X.  Rows are padded to 4 bytes and
    stored bottom-up unless ``top_down``.  ``I420``/``IYUV``/``YV12`` and
    ``NV12`` take a tuple (Y (H, W), U, V (ceil(H/2), ceil(W/2)));
    ``I444`` and ``YV24`` (V plane first) one of three (H, W) planes;
    ``YUY2``/``UYVY`` (Y (H, W), U, V (H, ceil(W/2))), an odd W padded
    with a zero sample; the gray fourccs an (H, W) array.
    """
    if codec == "DIB":
        a = np.ascontiguousarray(frame)
        h = a.shape[0]
        rows = _pad_rows(a.view(np.uint8).reshape(h, -1))
        return (rows if top_down else rows[::-1]).tobytes()
    if codec in ("Y800", "GREY", "Y8  "):
        return np.ascontiguousarray(frame, np.uint8).tobytes()
    y, u, v = (np.ascontiguousarray(p, np.uint8) for p in frame)
    if codec in ("I420", "IYUV"):
        return y.tobytes() + u.tobytes() + v.tobytes()
    if codec == "YV12":
        return y.tobytes() + v.tobytes() + u.tobytes()
    if codec == "I444":
        return y.tobytes() + u.tobytes() + v.tobytes()
    if codec == "YV24":
        return y.tobytes() + v.tobytes() + u.tobytes()
    if codec == "NV12":
        return y.tobytes() + np.stack([u, v], -1).tobytes()
    if codec in ("YUY2", "UYVY"):
        h, w = y.shape
        if w % 2:  # the last pair's second luma sample is padding
            y = np.concatenate([y, np.zeros((h, 1), np.uint8)], 1)
        px = np.empty((h, -(-w // 2), 4), np.uint8)
        lum, chrom = ((0, 2), (1, 3)) if codec == "YUY2" else ((1, 3), (0, 2))
        px[..., lum[0]], px[..., lum[1]] = y[:, 0::2], y[:, 1::2]
        px[..., chrom[0]], px[..., chrom[1]] = u, v
        return px.tobytes()
    raise ValueError(f"unknown codec {codec!r}")


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    """A RIFF chunk, padded to a word."""
    return struct.pack("<4sI", fourcc, len(payload)) + payload + \
        b"\0" * (len(payload) & 1)


def video_headers(height: int, width: int, tag: bytes, bit_count: int,
                  frames: int, biggest: int, fps: int = 30,
                  top_down: bool = False, compression: bytes = b"",
                  image_size: Optional[int] = None, clr_used: int = 0,
                  palette: bytes = b"") -> tuple:
    """A video stream's ``strh`` and ``strf`` payloads: ``tag`` is the
    stream header's handler, ``compression`` the BITMAPINFOHEADER's (the
    handler where empty)."""
    strh = struct.pack("<4s4sIHHIIIIIIII4h", b"vids", tag, 0, 0, 0, 0, 1,
                       fps, 0, frames, biggest, 0xFFFFFFFF, 0, 0, 0, width,
                       height)
    strf = struct.pack("<IiiHH4sIiiII", 40, width,
                       -height if top_down else height, 1, bit_count,
                       compression or tag,
                       biggest if image_size is None else image_size, 0, 0,
                       clr_used, 0) + palette
    return strh, strf


class Stream(NamedTuple):
    """A stream of an AVI beside its video: its ``strh`` and ``strf``
    payloads, its chunks' fourcc suffix (``b"wb"`` audio, ``b"dc"``
    video) and ``(index, payload)`` chunks, each put before video frame
    ``index`` (after the last frame where ``index`` is the frame count)."""
    strh: bytes
    strf: bytes
    suffix: bytes
    chunks: List[tuple]


def pcm_stream(sizes: Sequence[int], seed: int = 0) -> Stream:
    """An 8-bit mono 8 kHz PCM audio stream: a chunk of ``sizes[i]``
    random bytes before video frame ``i`` (odd sizes are padded to a word,
    as RIFF asks)."""
    rng = np.random.default_rng(seed)
    rate = 8000
    strh = struct.pack("<4s4sIHHIIIIIIII4h", b"auds", b"\0\0\0\0", 0, 0, 0,
                       0, 1, rate, 0, sum(sizes), max(sizes, default=0),
                       0xFFFFFFFF, 1, 0, 0, 0, 0)
    strf = struct.pack("<HHIIHHH", 1, 1, rate, rate, 1, 8, 0)
    return Stream(strh, strf, b"wb", [
        (i, rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        for i, n in enumerate(sizes)])


def video_stream(payloads: Sequence[bytes], height: int, width: int,
                 codec: str, bit_count: int) -> Stream:
    """Another video stream: one ``dc`` chunk before each frame of the
    main video."""
    tag = codec.encode()
    strh, strf = video_headers(height, width, tag, bit_count, len(payloads),
                               max(map(len, payloads), default=0))
    return Stream(strh, strf, b"dc", list(enumerate(payloads)))


def write_avi(path: Path, strh: bytes, strf: bytes, payloads: Sequence[bytes],
              suffix: bytes, extra_chunks: Sequence[tuple] = (),
              fps: int = 30, stream: int = 0, others: Sequence[Stream] = (),
              index: bool = False) -> None:
    """An AVI whose video (``strh``, ``strf``) is stream ``stream`` and
    whose frames are ``payloads``, in ``NN`` + ``suffix`` chunks; the
    ``others`` take the other stream numbers in order.  Before frame ``i``
    come the others' chunks of index ``i``, then ``extra_chunks``
    ((index, fourcc, bytes)) of that index, written as given.  ``index``
    appends an ``idx1`` of every chunk in the movi list."""
    payloads = list(payloads)
    n = len(payloads)
    biggest = max((len(p) for p in payloads), default=0)
    width, height = struct.unpack("<ii", strf[4:12])
    avih = struct.pack("<14I", 1000000 // fps, biggest * fps, 0, 0x10, n, 0,
                       1 + len(others), biggest, width, abs(height), 0, 0,
                       0, 0)
    order = list(others[:stream]) + [None] + list(others[stream:])
    strls = b""
    before = {}
    for k, other in enumerate(order):
        head, form = (strh, strf) if other is None else other[:2]
        strls += _chunk(b"LIST", b"strl" + _chunk(b"strh", head)
                        + _chunk(b"strf", form))
        if other is not None:
            for i, body in other.chunks:
                before.setdefault(i, []).append(
                    (b"%02d" % k + other.suffix, body))
    for i, fourcc, body in extra_chunks:
        before.setdefault(i, []).append((fourcc, body))
    frame_tag = b"%02d" % stream + suffix
    chunks = []
    for i in range(n + 1):
        chunks += before.get(i, [])
        if i < n:
            chunks.append((frame_tag, payloads[i]))
    hdrl = _chunk(b"LIST", b"hdrl" + _chunk(b"avih", avih) + strls)
    parts, entries, offset = [b"movi"], [], 4
    for fourcc, body in chunks:
        entries.append(struct.pack("<4sIII", fourcc, 0x10, offset,
                                   len(body)))
        parts.append(_chunk(fourcc, body))
        offset += len(parts[-1])
    movi = b"".join(parts)
    tail = _chunk(b"idx1", b"".join(entries)) if index else b""
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF",
                            4 + len(hdrl) + 8 + len(movi) + len(tail),
                            b"AVI "))
        f.write(hdrl)
        f.write(struct.pack("<4sI", b"LIST", len(movi)))
        f.write(movi)
        f.write(tail)


def write_raw_avi(path: Path, payloads: Iterable[bytes], height: int,
                  width: int, codec: str, bit_count: Optional[int] = None,
                  top_down: bool = False,
                  palette: Optional[np.ndarray] = None,
                  clr_used: Optional[int] = None,
                  compression: Optional[int] = None,
                  extra_chunks: Sequence[tuple] = (), fps: int = 30,
                  stream: int = 0, others: Sequence[Stream] = (),
                  index: bool = False) -> None:
    """An AVI of one video stream whose frames are ``payloads`` (chunk
    bytes, e.g. from :func:`encode_frame`), with no index unless
    ``index``.

    ``codec`` is a fourcc, or ``"DIB"`` for BI_RGB (compression 0, or
    ``compression`` where given: 3 is BI_BITFIELDS); ``bit_count``
    defaults to the fourcc's (:data:`BIT_COUNT`).  ``palette`` ((n, 4)
    B, G, R, X bytes) follows the header, ``clr_used`` (default n) is its
    stated length.  BI_RGB frames go into ``NNdb`` chunks, the others into
    ``NNdc``, ``NN`` the video's stream number ``stream`` (see
    :func:`write_avi` for ``others``); ``extra_chunks`` ((index, fourcc,
    bytes)) are put before frame ``index``."""
    payloads = list(payloads)
    dib = codec == "DIB"
    bits = bit_count if bit_count is not None else BIT_COUNT[codec]
    tag = struct.pack("<I", compression or 0) if dib else codec.encode()
    pal = b"" if palette is None else \
        np.ascontiguousarray(palette, np.uint8).tobytes()
    used = (len(pal) // 4) if clr_used is None else clr_used
    strh, strf = video_headers(
        height, width, b"\0\0\0\0" if dib else tag, bits, len(payloads),
        max((len(p) for p in payloads), default=0), fps, top_down, tag,
        clr_used=used, palette=pal)
    write_avi(path, strh, strf, payloads, b"db" if dib else b"dc",
              extra_chunks, fps, stream, others, index)
