"""AVI container reader (pure Python, streaming): MJPG chunks, raw RGBA
frames, the chunks of the other uncompressed layouts and of PNG, HuffYUV,
FFV1, Ut Video and Lagarith video, and the stream's geometry.

Port of ``camera_linearity_tpu/utils/avi.py``, copied (importing the JAX
package would import JAX).  An AVI file is a RIFF tree; the walker goes
through it linearly and yields the video stream's data chunks.  For an MJPG
codec a chunk is a complete JFIF image, handed to the port's own JPEG
decoder (``native/jpeg.cpp``); for the ``RGBA`` codec (lossless, written by
``cv2.VideoWriter_fourcc(*"RGBA")``) a chunk is one top-down frame of
H * W * 4 bytes in R, G, B, A order, read here with NumPy.  The other
uncompressed layouts FFmpeg's rawvideo decoder reads (BI_RGB at 8, 16, 24
and 32 bits, gray8, I420/YV12, NV12, YUY2/UYVY: ``AviInfo.layout``) are
read here chunk by chunk (:func:`raw_chunks`) and converted by the port's
``rawvideo`` reader (``native.raw_decode_bgr_batch``).  The lossless
compressed codecs ImageJ/Fiji and ``cv2.VideoWriter`` write, PNG
(``MPNG``, ``PNG1``, ``png ``: a PNG file a chunk) and HuffYUV (``HFYU``,
``FFVH``: the tables in the ``strf`` bytes after the header), and the
lossless codec of moving-image archives, FFV1 (``FFV1``: its header in the
``strf`` bytes after the header for versions 2 and 3, in every keyframe
for 0 and 1), and the lossless codec of capture tools, Ut Video (``ULRG``,
``ULRA``, ``ULY0``, ``ULY2``, ``ULY4``, ``ULH0``, ``ULH2``, ``ULH4``: 16
bytes of parameters after the header) and Lagarith (``LAGS``: each frame
names its own type; an empty chunk is Lagarith's null frame, which cv2
skips, as :func:`frame_chunks` does), are read chunk by chunk too
(:func:`frame_chunks`) and decoded by the port's
``native.png_decode_bgr_batch``, ``native.huffyuv_decode_bgr_batch``,
``native.ffv1_decode_bgr_batch``, ``native.utvideo_decode_bgr_batch`` and
``native.lagarith_decode_bgr_batch``.
So the port reads all of them without a video codec library, and reads
exactly the frames ``cv2.VideoCapture`` returns for them.

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

import re
import struct
from pathlib import Path
from typing import Callable, Iterator, NamedTuple, Optional, Tuple

import numpy as np

from ..native import (ffv1_plain, h264_plain, huffyuv_plain,
                      lagarith_plain, mpeg4_plain, png_plain, utvideo_plain)
from ..native.jpeg_plain import ffmpeg_format
from ..native.rawvideo_plain import (DIB_LAYOUTS, FOURCC_LAYOUTS,
                                     chunk_sizes, frame_bytes)

__all__ = ["mjpg_chunks", "probe_avi", "raw_frames", "raw_chunks",
           "frame_chunks", "raw_unsupported", "png_unsupported",
           "huffyuv_unsupported", "huffyuv_params", "AviInfo", "RawLayout",
           "JpegInfo", "jpeg_unsupported", "PNG_CODECS", "HUFFYUV_CODECS",
           "FFV1_CODECS", "ffv1_params", "ffv1_unsupported",
           "UTVIDEO_CODECS", "utvideo_params", "utvideo_unsupported",
           "LAGARITH_CODECS", "lagarith_unsupported", "MPEG4_CODECS",
           "mpeg4_params", "mpeg4_unsupported", "UTVIDEO_READ",
           "FOURCC_LAYOUTS", "H264_CODECS", "h264_params",
           "h264_unsupported"]

# the fourccs (stripped of trailing spaces) FFmpeg decodes as PNG, as
# HuffYUV, as FFV1 and as Ut Video (the Pro and pack-mode ones too, which
# the port refuses by name)
PNG_CODECS = png_plain.PNG_FOURCCS
HUFFYUV_CODECS = huffyuv_plain.HUFFYUV_FOURCCS
FFV1_CODECS = ffv1_plain.FFV1_FOURCCS
UTVIDEO_CODECS = utvideo_plain.UTVIDEO_FOURCCS + tuple(
    utvideo_plain.REFUSED_FOURCCS)
UTVIDEO_READ = utvideo_plain.UTVIDEO_FOURCCS   # the ones it decodes
LAGARITH_CODECS = lagarith_plain.LAGARITH_FOURCCS
# the MPEG-4 Part 2 fourccs FFmpeg maps to its mpeg4 decoder that cv2 reads
MPEG4_CODECS = mpeg4_plain.MPEG4_FOURCCS
# the H.264 fourccs FFmpeg maps to its h264 decoder that cv2 reads (an
# AVI's; "avc1" and "avc3" are the MP4 sample entries too, "H264" the
# codec Matroska's V_MPEG4/ISO/AVC routes to)
H264_CODECS = h264_plain.H264_FOURCCS

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


def _frame_fourccs(stream: int) -> Tuple[bytes, bytes]:
    """The frame chunks of AVI stream ``stream``: both the compressed
    (``NNdc``) and the uncompressed (``NNdb``) suffix, as FFmpeg's AVI
    reader takes them."""
    prefix = b"%02d" % stream
    return prefix + b"dc", prefix + b"db"


def mjpg_chunks(path: Path, stream: int = 0) -> Iterator[bytes]:
    """Yield each video frame's JPEG bytes from an MJPG AVI file.

    ``stream`` selects the AVI stream number (OpenCV writes video as
    stream 0; :func:`probe_avi` gives the video's as ``AviInfo.stream``).
    Chunks of other streams (audio ``NNwb``, text, indexes, ``JUNK``) are
    skipped."""
    with open(path, "rb", buffering=1 << 20) as f:
        for payload in _stream_chunks(f, _frame_fourccs(stream)):
            yield payload


def _open_avi(f) -> bool:
    """True when ``f`` starts a RIFF AVI form; leaves ``f`` at offset 0."""
    head = f.read(12)
    f.seek(0)
    return len(head) == 12 and head[:4] == b"RIFF" and head[8:] == b"AVI "


class JpegInfo(NamedTuple):
    """What a JPEG's headers say before any entropy-coded data is decoded:
    geometry, components, sample precision in bits, the start-of-frame
    marker (``0xC0`` baseline, ``0xC1`` extended sequential, ``0xC2``
    progressive, ...), each component's (horizontal, vertical) sampling
    factors and the number of scans (SOS markers)."""
    height: int
    width: int
    components: int
    precision: int
    sof: int
    sampling: Tuple[Tuple[int, int], ...]
    scans: int


def _first_jpeg_sof(path: Path, stream: int) -> Optional[JpegInfo]:
    """The headers of the first frame of an AVI's stream ``stream`` when it
    is a JPEG, else None."""
    try:
        with open(path, "rb") as f:
            if not _open_avi(f):
                return None
            first = next(_stream_chunks(f, _frame_fourccs(stream)), None)
    except OSError:
        return None
    if first is None or first[:2] != b"\xff\xd8":
        return None
    return _jpeg_sof(first)


# the end of entropy-coded data: 0xFF (fill 0xFFs too) before a byte that
# is neither a stuffed zero nor a restart marker
_SCAN_END = re.compile(rb"\xff+[^\x00\xd0-\xd7\xff]")


def _jpeg_sof(data: bytes) -> Optional[JpegInfo]:
    """A JPEG's :class:`JpegInfo` from its marker segments up to EOI (the
    scans' entropy-coded data is skipped, not decoded); None without a
    start-of-frame segment."""
    i = 2
    n = len(data)
    sof = None
    scans = 0
    while i + 2 <= n:
        if data[i] != 0xFF:
            return None
        marker = data[i + 1]
        if marker == 0xFF:  # 0xFF fill bytes before a marker are legal
            i += 1
            continue
        if marker == 0xD9:
            break
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        if i + 4 > n:
            break
        seg_len = struct.unpack(">H", data[i + 2:i + 4])[0]
        # SOF0..SOF15 except DHT(C4)/JPG(C8)/DAC(CC) carry geometry
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if i + 10 > n:
                return None
            precision, height, width, comps = struct.unpack(
                ">BHHB", data[i + 4:i + 10])
            factors = data[i + 10:i + 10 + 3 * comps][1::3]
            sof = (height, width, comps, precision, marker,
                   tuple((b >> 4, b & 15) for b in factors))
        i += 2 + seg_len
        if marker == 0xDA:
            scans += 1
            end = _SCAN_END.search(data, i)
            if end is None:
                break
            i = end.end() - 2
    if sof is None:
        return None
    return JpegInfo(*sof, scans)


_PROCESS = {0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical",
            0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
            0xC9: "arithmetic coding", 0xCA: "progressive arithmetic coding",
            0xCB: "lossless arithmetic coding",
            0xCD: "hierarchical arithmetic coding",
            0xCE: "hierarchical progressive arithmetic coding",
            0xCF: "hierarchical lossless arithmetic coding"}


def jpeg_unsupported(data_or_info, mode: str = "turbo") -> Optional[str]:
    """The feature of a JPEG (bytes or its :class:`JpegInfo`) that the
    port's decoder does not read in ``mode``, or None when it reads the
    headers' mode.  ``"turbo"`` and ``"turbo_fast"`` read baseline or
    extended-sequential Huffman coding of 8-bit samples, three components
    in one scan, the second and third sampled alike at full size, halved
    across (4:2:2) or halved both ways (4:2:0).  ``"ffmpeg"`` reads what
    FFmpeg's MJPEG decoder reads as gray or yuvj444p/422p/420p/411p/440p
    (grayscale at any factors; three components with the second and third
    sampled 1x1, after FFmpeg's halving of all-even factors), sequential
    or progressive (SOF2), in any number of scans, at any size."""
    info = data_or_info if isinstance(data_or_info, JpegInfo) else \
        _jpeg_sof(bytes(data_or_info))
    ffmpeg = mode == "ffmpeg"
    if info is None:
        return "no start-of-frame segment"
    if info.sof in _PROCESS and not (ffmpeg and info.sof == 0xC2):
        return _PROCESS[info.sof]
    if info.sof not in (0xC0, 0xC1, 0xC2):
        return f"start-of-frame marker 0x{info.sof:02X}"
    if info.precision != 8:
        return f"{info.precision}-bit samples"
    if info.components == 1 and not ffmpeg:
        return "grayscale"
    if info.components not in ((1, 3) if ffmpeg else (3,)):
        return f"{info.components} components"
    if info.scans != 1 and not ffmpeg:
        return f"multi-scan ({info.scans} scans)"
    sampling = "sampling " + " ".join(f"{h}x{v}" for h, v in info.sampling)
    if ffmpeg:
        if ffmpeg_format(info.sampling) is None or \
                info.components == 3 and info.sampling[1] != info.sampling[2]:
            return sampling
        return None
    (h0, v0), (h1, v1), (h2, v2) = info.sampling
    ratio = (h0 // max(h1, 1), v0 // max(v1, 1))
    if (h0, v0) != (max(h0, h1, h2), max(v0, v1, v2)) or \
            (h1, v1) != (h2, v2) or h0 % max(h1, 1) or v0 % max(v1, 1) or \
            ratio not in ((1, 1), (2, 1), (2, 2)):
        return sampling
    return None


class RawLayout(NamedTuple):
    """What the BITMAPINFOHEADER of an uncompressed stream says: the
    layout of the port's rawvideo reader (``native/rawvideo_plain.py``;
    None where it has none), the bits per pixel, whether the rows are
    stored bottom-up (BI_RGB of positive height) and, for 8-bit BI_RGB,
    the (256, 4) B, G, R, X palette as FFmpeg's AVI demuxer reads it (the
    last entries of the header's extra bytes, up to 256; the rest
    zero)."""
    layout: Optional[str]
    bit_count: int
    bottom_up: bool
    palette: Optional[np.ndarray]


class _AviHeader(NamedTuple):
    codec: str
    height: int
    width: int
    components: int
    jpeg: Optional[JpegInfo] = None


class AviInfo(_AviHeader):
    """A video stream's codec (the BITMAPINFOHEADER's compression
    fourcc stripped of trailing spaces, e.g. ``"MJPG"``, ``"RGBA"`` or
    ``"png"``; ``"DIB"`` for uncompressed BI_RGB, ``"BITFIELDS"`` for
    BI_BITFIELDS; for the other containers the fourcc their codec maps to,
    ``utils/containers.py``), frame geometry and components: the channels
    the port decodes a frame to, 3 for every codec it decodes (cv2 gives
    BGR) but MJPG, whose components are the JPEG's (what the ``"turbo"``
    modes decode to; the ``"ffmpeg"`` mode gives 3), and bits per pixel / 8
    for a codec only cv2 reads.  For MJPG also the first frame's
    :class:`JpegInfo`.  It compares as the tuple of those five;
    ``stream`` is the video's AVI stream number (its frames are
    ``NNdc``/``NNdb`` chunks), ``bit_count`` the header's bits per pixel
    and ``extra`` its ``strf`` bytes past the BITMAPINFOHEADER (HuffYUV's
    tables, a palette; the extradata in the other containers); for an
    uncompressed codec ``raw`` holds its :class:`RawLayout` and ``layout``
    the rawvideo reader's layout (None where the reader has none); for PNG
    ``png`` holds the first frame's ``IHDR`` (``png_plain.PngInfo``); for
    FFV1 ``ffv1`` the stream's header (``ffv1_plain.Ffv1Params``: from the
    extradata, or from the first frame for versions 0 and 1), or None and
    ``ffv1_error`` why it does not read; ``handler`` is the stream header's
    fourcc (FFmpeg's AVI demuxer takes an MPEG-4 stream handled by ``XVID``
    as Xvid).

    ``container`` is ``"avi"``, ``"mov"``, ``"mp4"``, ``"mkv"`` or
    ``"webm"``; ``codec_id`` the container's own name of the codec where
    it is not an AVI (a sample entry's fourcc, a Matroska CodecID);
    ``tag`` the codec tag FFmpeg's demuxer sets, which its MPEG-4 bug
    detection reads (None: the AVI's rule, :func:`mpeg4_params`);
    ``rotation`` the clockwise turn cv2 gives the frames (0, 90, 180, 270:
    the container's display matrix); ``samples`` the frames' byte ranges
    in the file where they are not AVI chunks (``utils/containers.py``);
    ``colour`` the container's colour tags, (matrix_coefficients, full
    range), None where it has none; ``first(limit=None)`` reads the
    stream's first non-empty frame, or its first ``limit`` bytes (empty
    where there is none), from whatever container (:func:`codec_info`'s
    ``first``)."""
    raw: Optional[RawLayout] = None
    stream: int = 0
    bit_count: int = 0
    extra: bytes = b""
    png: Optional[png_plain.PngInfo] = None
    ffv1: Optional[ffv1_plain.Ffv1Params] = None
    ffv1_error: Optional[str] = None
    handler: str = ""
    container: str = "avi"
    codec_id: str = ""
    tag: Optional[str] = None
    rotation: int = 0
    samples: object = None
    colour: Optional[Tuple[int, bool]] = None
    first: Optional[Callable[..., bytes]] = None

    @property
    def layout(self) -> Optional[str]:
        return None if self.raw is None else self.raw.layout

    @property
    def container_name(self) -> str:
        return CONTAINER_NAMES[self.container]

    @property
    def codec_name(self) -> str:
        """The codec as the container names it (for messages)."""
        return self.codec_id or self.codec


# the containers' names in messages
CONTAINER_NAMES = {"avi": "AVI", "mov": "QuickTime MOV", "mp4": "MP4",
                   "mkv": "Matroska", "webm": "WebM"}


def probe_avi(path: Path) -> Optional[AviInfo]:
    """The first video stream of an AVI file, from its ``strh``/``strf``
    headers, or None when ``path`` is not a readable AVI with a video
    stream.

    Every stream counts towards the video's number (``AviInfo.stream``),
    audio and text streams too; of several video streams the first is
    taken, as cv2 takes it.  A video stream without a single frame chunk
    raises a ValueError naming its number (cv2 reads no frame from such a
    file either).  The BITMAPINFOHEADER routes the stream to a decoder
    (:func:`bih_info`).
    """
    try:
        with open(path, "rb") as f:
            if not _open_avi(f):
                return None
            header = None
            stream = -1   # the number of the latest stream header
            video = False
            handler = b""
            for fourcc, size in _chunk_spans(f, (b"strh", b"strf")):
                payload = f.read(size)
                if fourcc == b"strh":
                    stream += 1
                    video = payload[:4] == b"vids"
                    handler = payload[4:8]
                elif video and len(payload) >= 20:
                    header = payload
                    break
            frames = _frame_fourccs(stream)
            f.seek(0)
            if header is not None and \
                    next(_chunk_spans(f, frames), None) is None:
                raise ValueError(
                    f"{path}: AVI video stream {stream} has no frame chunk "
                    f"({frames[0].decode()} or {frames[1].decode()})")
    except OSError:
        return None
    if header is None:
        return None
    info = bih_info(header, lambda limit=None: _first_chunk(path, stream,
                                                            limit),
                    lambda: _first_jpeg_sof(path, stream))
    if info is not None:
        info.stream = stream
        info.handler = handler.decode("latin-1").strip()
    return info


def bih_info(header: bytes, first: Callable[..., bytes],
             sof: Optional[Callable[[], Optional[JpegInfo]]] = None
             ) -> Optional[AviInfo]:
    """A video stream's :class:`AviInfo` from its BITMAPINFOHEADER
    (``header``: the header and the bytes after it), routed as
    :func:`codec_info` routes it; the DIB codecs (BI_RGB by bit count,
    BI_BITFIELDS) and the rawvideo fourccs get their :class:`RawLayout`
    (BI_RGB rows bottom-up where the height is positive, 8-bit BI_RGB's
    palette from the extra bytes)."""
    _, width, height, _, bit_count, compression = struct.unpack(
        "<IiiHH4s", header[:20])
    codec = {b"\0\0\0\0": "DIB", b"\3\0\0\0": "BITFIELDS"}.get(
        compression) or compression.decode("latin-1").strip()
    extra = bytes(header[40:])
    info = codec_info(codec, abs(height), width, bit_count, extra, first,
                      sof)
    if info is None or info.raw is None or codec not in ("DIB",
                                                          "BITFIELDS"):
        return info
    palette = None
    if info.layout == "pal8":
        # avidec.c: the last (1 << bits) * 4 bytes after the header, or all
        # of them where fewer
        n = min(1024, len(extra))
        palette = np.zeros((256, 4), np.uint8)
        palette.reshape(-1)[:n // 4 * 4] = np.frombuffer(
            extra, np.uint8, n // 4 * 4, len(extra) - n)
    info.raw = info.raw._replace(bottom_up=codec == "DIB" and height > 0,
                                 palette=palette)
    return info


def codec_info(codec: str, height: int, width: int, bit_count: int,
               extra: bytes, first: Callable[..., bytes],
               sof: Optional[Callable[[], Optional[JpegInfo]]] = None
               ) -> Optional[AviInfo]:
    """A stream's :class:`AviInfo` from its codec fourcc, geometry, bits
    per pixel and extradata, whatever the container: ``first(limit=None)``
    gives the first non-empty frame's first ``limit`` bytes, which MJPG
    (the geometry, components and JPEG mode come from its headers, unless
    ``sof`` gives them), PNG (its ``IHDR``: cv2's writer states 40 bits for
    gray ``MPNG``) and FFV1 versions 0 and 1 (their header) read; the
    other codecs take the container's geometry.  None for an MJPG stream
    whose first frame has no JPEG headers."""
    if codec == "MJPG":
        jpeg = sof() if sof else _jpeg_sof(first())
        if jpeg is None:
            return None
        info = AviInfo(codec, jpeg.height, jpeg.width, jpeg.components, jpeg)
    elif codec in PNG_CODECS:
        ihdr = png_plain.read_header(first(33))
        info = AviInfo(codec, *((ihdr.height, ihdr.width) if ihdr else
                                (height, width)), 3)
        info.png = ihdr
    elif codec in H264_CODECS:
        # the geometry the SPS gives (cv2's frames: the cropped size)
        sps, _ = h264_plain.probe(extra, first())
        if sps is not None:
            height, width = h264_plain.geometry(sps)
        info = AviInfo(codec, height, width, 3)
    elif codec in HUFFYUV_CODECS or codec in UTVIDEO_CODECS or \
            codec in LAGARITH_CODECS or codec in MPEG4_CODECS:
        info = AviInfo(codec, height, width, 3)
    elif codec in FFV1_CODECS:
        info = AviInfo(codec, height, width, 3)
        try:
            info.ffv1 = ffv1_plain.params(extra, first)
        except ffv1_plain.Ffv1Error as exc:
            info.ffv1_error = str(exc)
    else:
        layout = DIB_LAYOUTS.get(bit_count) if codec == "DIB" else \
            FOURCC_LAYOUTS.get(codec)
        info = AviInfo(codec, height, width, 3 if layout or
                       codec == "RGBA" else bit_count // 8)
        info.raw = RawLayout(layout, bit_count, False, None)
    info.bit_count, info.extra, info.first = bit_count, extra, first
    return info


def _first_chunk(path: Path, stream: int, limit: Optional[int] = None
                 ) -> bytes:
    """The first non-empty frame chunk of stream ``stream``, or its first
    ``limit`` bytes (empty where there is none)."""
    with open(path, "rb") as f:
        for _, size in _chunk_spans(f, _frame_fourccs(stream)):
            if size:
                return f.read(size if limit is None else min(size, limit))
    return b""


def png_unsupported(info: AviInfo) -> Optional[str]:
    """What of a PNG AVI the port's PNG decoder does not read, or None:
    its first frame (no PNG, or a layout ``png_plain.unsupported``
    names).  A later frame that is no PNG, or whose ``IHDR`` differs from
    the first one's, raises when it is decoded, naming it."""
    if info.png is None:
        return "the first frame is no PNG file"
    return png_plain.unsupported(info.png)


def huffyuv_params(info: AviInfo) -> huffyuv_plain.HuffyuvParams:
    """A HuffYUV stream's parameters (``huffyuv_plain.params``) from its
    header; raises ``huffyuv_plain.HuffyuvError`` (a ValueError) for a
    header the decoder does not read."""
    return huffyuv_plain.params(info.codec, info.bit_count, info.extra,
                                info.height)


def huffyuv_unsupported(info: AviInfo) -> Optional[str]:
    """What of a HuffYUV stream's header the port's decoder does not
    read, or None (``huffyuv_plain.unsupported``)."""
    return huffyuv_plain.unsupported(info.codec, info.bit_count, info.extra,
                                     info.height, info.width)


def ffv1_params(info: AviInfo) -> ffv1_plain.Ffv1Params:
    """An FFV1 stream's header (``ffv1_plain.Ffv1Params``); raises
    ``ffv1_plain.Ffv1Error`` (a ValueError) where it does not read."""
    if info.ffv1 is None:
        raise ffv1_plain.Ffv1Error(info.ffv1_error or "no FFV1 header")
    return info.ffv1


def ffv1_unsupported(info: AviInfo) -> Optional[str]:
    """What of an FFV1 stream the port's decoder does not read, or None,
    before any decode: its header (a CRC that fails, a first frame that is
    no keyframe for versions 0 and 1) or a layout
    ``ffv1_plain.unsupported`` names (version 4, RGB or YUV past 8 bits,
    gray past 8 bits but 16, alpha beside gray or YUV, yuv440p, yuv411p,
    yuv410p, Bayer, a slice grid that leaves a chroma row undecoded)."""
    if info.ffv1 is None:
        return f"its header: {info.ffv1_error or 'none'}"
    why = ffv1_plain.unsupported(info.ffv1, info.height, info.width)
    return why and f"{why} ({ffv1_plain.layout_name(info.ffv1)})"


def utvideo_params(info: AviInfo) -> utvideo_plain.UtvideoParams:
    """A Ut Video stream's parameters (``utvideo_plain.params``) from its
    fourcc and extradata; raises ``utvideo_plain.UtvideoError`` (a
    ValueError) for a header the decoder does not read."""
    return utvideo_plain.params(info.codec, info.extra)


def utvideo_unsupported(info: AviInfo) -> Optional[str]:
    """What of a Ut Video stream the port's decoder does not read, or None,
    before any decode (``utvideo_plain.unsupported``: the Pro and pack-mode
    fourccs, extradata under 16 bytes, a frame-information size other than
    4, odd subsampled sizes, an interlaced height that leaves rows
    undecoded, the interlaced median on a plane one sample wide)."""
    return utvideo_plain.unsupported(info.codec, info.extra, info.height,
                                     info.width)


def lagarith_unsupported(path: Path, info: AviInfo) -> Optional[str]:
    """What of a Lagarith stream the port's decoder does not read, or None,
    from its first frame's type (``lagarith_plain.unsupported``: the
    uncompressed, old arithmetic RGB and reduced-resolution types, and the
    types FFmpeg does not know).  The type is a frame's, not the
    stream's: the decoder checks every later frame as it decodes it."""
    try:
        head = info.first(1)
    except OSError as exc:
        return f"unreadable ({exc})"
    if not head:
        return None
    return lagarith_plain.unsupported(head[0], info.height, info.width,
                                      info.bit_count)


def mpeg4_params(info: AviInfo) -> Tuple[str, bytes]:
    """An MPEG-4 Part 2 stream's (tag, extradata): the codec tag FFmpeg's
    bug detection reads (in an AVI the header's fourcc, or ``XVID`` where
    the stream header's handler is ``XVID``, as FFmpeg's AVI demuxer takes
    it; in the other containers the tag their demuxer sets,
    ``AviInfo.tag``: a sample entry's fourcc, the BITMAPINFOHEADER's under
    Matroska's ``V_MS/VFW/FOURCC``, none for Matroska's ``V_MPEG4/*``) and
    the extradata (the ``strf`` bytes after the BITMAPINFOHEADER, a VOL
    some writers put there; the ``esds`` DecoderSpecificInfo, Matroska's
    CodecPrivate)."""
    if info.tag is not None:
        return info.tag, info.extra
    tag = "XVID" if info.handler == "XVID" else info.codec
    return tag, info.extra


def mpeg4_unsupported(path: Path, info: AviInfo) -> Optional[str]:
    """What of an MPEG-4 Part 2 stream the port's decoder does not read, or
    None, before any decode: from the extradata and the first chunk's
    headers (``mpeg4_plain.unsupported``: S-VOPs (GMC) and sprites,
    quarter-pel, interlaced VOLs, data partitioning and reversible VLCs,
    the short video header, shapes other than rectangular, ``not_8_bit``,
    newpred, reduced resolution, scalability, complexity estimation, a
    full-range signal or a matrix other than BT.601 and BT.709; a first
    VOP that is a P-VOP, a VOL of another size than the container's).
    B-VOPs, packed bitstreams (DivX 5, Xvid's packed mode), MPEG
    quantisation (``quant_type`` 1) and the Xvid IDCT FFmpeg's bug
    detection picks for Xvid streams are read.  A later chunk that is
    refused raises when it is decoded, naming its frame."""
    try:
        head = info.first()
    except OSError as exc:
        return f"unreadable ({exc})"
    if not head:
        return None
    try:
        mpeg4_plain.Stream(*mpeg4_params(info), info.height,
                           info.width).next(head)
    except mpeg4_plain.Mpeg4Error as exc:
        return str(exc).removeprefix("frame 0: ")
    return None


def h264_params(info: AviInfo) -> bytes:
    """An H.264 stream's extradata: an AVI's ``strf`` bytes after the
    BITMAPINFOHEADER (Annex B parameter sets, or none: the chunks carry
    them), an MP4 sample entry's ``avcC``, Matroska's CodecPrivate (an
    avcC under ``V_MPEG4/ISO/AVC``).  An avcC's NAL length size splits the
    samples; without one they are Annex B."""
    return info.extra


def h264_unsupported(path: Path, info: AviInfo) -> Optional[str]:
    """What of an H.264 stream the port's decoder does not read, or None,
    before any decode: from the extradata and the first sample's
    parameter sets and slice header (``h264_plain.unsupported``: B, SP
    and SI slices (and weighted_bipred_idc with them), interlaced coding
    (PAFF and MBAFF), bit depths over 8, chroma formats other than 4:2:0
    (monochrome among them), lossless macroblocks, slice groups,
    redundant pictures, a
    left crop that is no multiple of 64, a matrix other than BT.601 and
    BT.709, full-range BT.709; a first picture that is no IDR).  A later
    sample that is refused raises when it is decoded, naming its frame."""
    try:
        head = info.first()
    except OSError as exc:
        return f"unreadable ({exc})"
    if not head:
        return None
    return h264_plain.probe(h264_params(info), head)[1]


def raw_unsupported(path: Path, info: AviInfo) -> Optional[str]:
    """What of an uncompressed AVI the port's rawvideo reader does not
    read, or None when it reads every frame: 1-, 2- and 4-bit BI_RGB,
    BI_BITFIELDS, palette-change (``NNpc``) chunks, or a frame chunk
    longer than the layout's frame that is not its padded size either
    (the chunk headers are walked, no frame is read).  Empty chunks are
    skipped, as FFmpeg's AVI reader skips them, and a shorter chunk ends
    the video, as cv2's read loop ends there.  Other codecs are not asked
    about here."""
    bits = info.raw.bit_count if info.raw else 0
    if info.codec == "BITFIELDS":
        return f"BI_BITFIELDS ({bits}-bit)"
    if info.codec == "DIB" and bits in (1, 2, 4):
        return f"{bits}-bit BI_RGB"
    if info.layout is None:
        return None
    sizes = chunk_sizes(info.layout, info.height, info.width)
    change = b"%02dpc" % info.stream   # a palette change
    try:
        with open(path, "rb") as f:
            for fourcc, size in _chunk_spans(
                    f, _frame_fourccs(info.stream) + (change,)):
                if fourcc == change:
                    return f"palette-change ({change.decode()}) chunks"
                if size > sizes[0] and size not in sizes:
                    return (f"a {info.layout} frame chunk of {size} bytes, "
                            f"not the {info.height} x {info.width} frame's "
                            + " or ".join(map(str, sizes)))
    except OSError as exc:
        return f"unreadable ({exc})"
    return None


def frame_chunks(path: Path, info: AviInfo, ring: int = 1, need: int = 0
                 ) -> Iterator[np.ndarray]:
    """Yield each non-empty frame chunk of the video stream as a uint8
    array, read into one of ``ring`` reused buffers in turn: a chunk is
    valid until ``ring`` more are requested.  Empty chunks are skipped, as
    FFmpeg's AVI reader skips them; a chunk shorter than ``need`` bytes
    ends the stream, and so does a truncated final chunk."""
    buffers: list = [np.empty(0, np.uint8)] * ring
    with open(path, "rb", buffering=0) as f:
        for i, (_, size) in enumerate(
                (s for s in _chunk_spans(f, _frame_fourccs(info.stream))
                 if s[1])):
            if size < need:
                return
            slot = i % ring
            if buffers[slot].size < size:
                buffers[slot] = np.empty(size, np.uint8)
            view = memoryview(buffers[slot])[:size]
            got = 0
            while got < size:
                n = f.readinto(view[got:])
                if not n:
                    return  # truncated final chunk
                got += n
            yield buffers[slot][:size]


def raw_chunks(path: Path, info: AviInfo, ring: int = 1
               ) -> Iterator[np.ndarray]:
    """:func:`frame_chunks` of an uncompressed AVI of ``info.layout``: a
    chunk shorter than the layout's frame ends the stream, as cv2's read
    loop ends at it (FFmpeg decodes no frame from it)."""
    return frame_chunks(path, info, ring,
                        frame_bytes(info.layout, info.height, info.width))


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
        for _, size in _chunk_spans(f, _frame_fourccs(info.stream)):
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
