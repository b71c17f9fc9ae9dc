"""Matroska demuxer (``.mkv``, ``.webm``): the video track's frames and
what FFmpeg's ``matroska`` demuxer makes of its headers, pure Python.

EBML: the header and its DocType (``matroska`` or ``webm``), IDs and sizes
of 1 to 8 bytes, Segments and Clusters of unknown size (a Cluster of
unknown size ends where an element that is no Cluster child starts), Void
and CRC-32 elements (skipped: FFmpeg does not check them).  The Tracks
must come before the first Cluster.  Of the tracks the first video one is
taken, as cv2 takes FFmpeg's first video stream; its CodecID routes it:

- ``V_MS/VFW/FOURCC``: the CodecPrivate is a BITMAPINFOHEADER, routed as an
  AVI's (``avi.bih_info``; its fourcc is the codec tag);
- ``V_MJPEG``: the JPEG decoder (in its ``ffmpeg`` mode by default);
- ``V_MPEG4/ISO/SP``, ``/ASP``, ``/AP``: the MPEG-4 Part 2 decoder, the
  CodecPrivate its extradata, with no codec tag;
- ``V_MPEG4/ISO/AVC``: the H.264 decoder, the CodecPrivate its avcC (a
  ``V_MS/VFW/FOURCC`` track of an H.264 fourcc carries Annex B frames);
- ``V_FFV1``: the FFV1 decoder, the CodecPrivate its extradata;
- ``V_UNCOMPRESSED``: the rawvideo reader's layout (or ``RGBA``'s) of the
  ``ColourSpace`` fourcc.

``Video/PixelWidth`` and ``PixelHeight`` are the geometry; ``Colour`` gives
the colour tags (MatrixCoefficients, Range); a rectangular ``Projection``
turns the frames as FFmpeg 8 turns its pose into a display matrix (yaw 0
or 180, pitch 0, any roll; ``containers.rotation``).  ``ContentEncodings``
of one encoding are undone: header stripping (algorithm 3) and zlib (0),
on the frames and, where its scope says so, on the CodecPrivate.  Frames
come from SimpleBlocks and BlockGroups' Blocks, unlaced or in Xiph, EBML
or fixed-size lacing; the other tracks' blocks are skipped.

Refused by name, before any decode (ValueError): encryption, bzlib and
lzo compression, several encodings, other projections, a ``V_UNCOMPRESSED``
track without a ColourSpace the port reads, BI_RGB under
``V_MS/VFW/FOURCC``, a ``V_MPEG4/ISO/AVC`` CodecPrivate that is no avcC,
a block or a lace past its element or the end of the file, and empty
frames.
"""
from __future__ import annotations

import math
import os
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import avi
from .containers import SampleTable, check_ranges, rotation

__all__ = ["probe_mkv", "MkvError", "MKV_CODECS"]


class MkvError(ValueError):
    """A Matroska file the port refuses, or cannot read as cv2 does."""


EBML, SEGMENT, CLUSTER = 0x1A45DFA3, 0x18538067, 0x1F43B675
TRACKS, TRACK_ENTRY, VIDEO = 0x1654AE6B, 0xAE, 0xE0
SIMPLE_BLOCK, BLOCK_GROUP, BLOCK = 0xA3, 0xA0, 0xA1
# the Segment's children: one of these ends a Cluster of unknown size
_TOP = {0x114D9B74, 0x1549A966, TRACKS, CLUSTER, 0x1C53BB6B, 0x1254C367,
        0x1043A770, 0x1941A469, SEGMENT, EBML}
_MPEG4_IDS = ("V_MPEG4/ISO/SP", "V_MPEG4/ISO/ASP", "V_MPEG4/ISO/AP")
_AVC_ID = "V_MPEG4/ISO/AVC"
# the CodecIDs the port reads, by the codec avi.codec_info routes
MKV_CODECS: Dict[str, str] = {"V_MJPEG": "MJPG", "V_FFV1": "FFV1",
                              **{c: "FMP4" for c in _MPEG4_IDS},
                              _AVC_ID: "H264"}
UNKNOWN = -1


def _vint(data: bytes, at: int, keep_marker: bool) -> Tuple[int, int]:
    """(value, length) of an EBML variable-size integer at ``at``; sizes of
    all ones give :data:`UNKNOWN`."""
    first = data[at]
    if not first:
        raise MkvError(f"an EBML number of more than 8 bytes at byte {at}")
    n = 8 - first.bit_length() + 1
    if at + n > len(data):
        raise MkvError(f"an EBML number cut short at byte {at}")
    value = first if keep_marker else first & ((1 << (8 - n)) - 1)
    for b in data[at + 1:at + n]:
        value = (value << 8) | b
    if not keep_marker and value == (1 << (7 * n)) - 1:
        return UNKNOWN, n
    return value, n


class _Reader:
    """Element headers read from a file, a few bytes at a time."""

    def __init__(self, f, size: int) -> None:
        self.f, self.size = f, size

    def header(self, pos: int) -> Optional[Tuple[int, int, int]]:
        """(id, size, body start) of the element at ``pos``, None at the
        end of the file."""
        self.f.seek(pos)
        head = self.f.read(16)
        if len(head) < 2:
            return None
        eid, n = _vint(head, 0, True)
        size, m = _vint(head, n, False)
        return eid, size, pos + n + m

    def read(self, a: int, b: int) -> bytes:
        self.f.seek(a)
        return self.f.read(b - a)

    def children(self, a: int, b: int) -> List[Tuple[int, int, int]]:
        """(id, body start, body end) of the children of a master element
        whose body is [a, b)."""
        out = []
        while a < b:
            h = self.header(a)
            if h is None:
                break
            eid, size, body = h
            end = b if size == UNKNOWN else body + size
            out.append((eid, body, min(end, b)))
            a = end
        return out


def _uint(data: bytes) -> int:
    return int.from_bytes(data, "big")


def _float(data: bytes) -> float:
    if len(data) == 4:
        return struct.unpack(">f", data)[0]
    if len(data) == 8:
        return struct.unpack(">d", data)[0]
    return 0.0


class _Track:
    def __init__(self) -> None:
        self.number = 0
        self.kind = 0
        self.codec = ""
        self.private = b""
        self.width = self.height = 0
        self.colour_space = b""
        self.colour: Optional[Tuple[int, bool]] = None
        self.projection: Optional[Tuple[int, float, float, float]] = None
        self.encodings: List[Tuple[int, int, int, bytes]] = []
        self.encrypted = False


def _parse_track(r: _Reader, a: int, b: int) -> _Track:
    t = _Track()
    for eid, x, y in r.children(a, b):
        if eid == 0xD7:
            t.number = _uint(r.read(x, y))
        elif eid == 0x83:
            t.kind = _uint(r.read(x, y))
        elif eid == 0x86:
            t.codec = r.read(x, y).rstrip(b"\0").decode("latin-1")
        elif eid == 0x63A2:
            t.private = r.read(x, y)
        elif eid == VIDEO:
            for vid, p, q in r.children(x, y):
                if vid == 0xB0:
                    t.width = _uint(r.read(p, q))
                elif vid == 0xBA:
                    t.height = _uint(r.read(p, q))
                elif vid == 0x2EB524:
                    t.colour_space = r.read(p, q)
                elif vid == 0x55B0:
                    matrix, full = 2, False
                    for cid, c, d in r.children(p, q):
                        if cid == 0x55B1:
                            matrix = _uint(r.read(c, d))
                        elif cid == 0x55B9:
                            full = _uint(r.read(c, d)) == 2
                    t.colour = (matrix, full)
                elif vid == 0x7670:
                    kind, yaw, pitch, roll = 0, 0.0, 0.0, 0.0
                    for pid, c, d in r.children(p, q):
                        if pid == 0x7671:
                            kind = _uint(r.read(c, d))
                        elif pid == 0x7673:
                            yaw = _float(r.read(c, d))
                        elif pid == 0x7674:
                            pitch = _float(r.read(c, d))
                        elif pid == 0x7675:
                            roll = _float(r.read(c, d))
                    t.projection = (kind, yaw, pitch, roll)
        elif eid == 0x6D80:
            for enc_id, p, q in r.children(x, y):
                if enc_id != 0x6240:
                    continue
                scope, kind, algo, settings = 1, 0, 0, b""
                for cid, c, d in r.children(p, q):
                    if cid == 0x5032:
                        scope = _uint(r.read(c, d))
                    elif cid == 0x5033:
                        kind = _uint(r.read(c, d))
                    elif cid == 0x5035:
                        t.encrypted = True
                    elif cid == 0x5034:
                        for zid, e, g in r.children(c, d):
                            if zid == 0x4254:
                                algo = _uint(r.read(e, g))
                            elif zid == 0x4255:
                                settings = r.read(e, g)
                t.encodings.append((scope, kind, algo, settings))
    return t


def _projection_matrix(yaw: float, roll: float) -> Tuple[int, ...]:
    """FFmpeg's display matrix of a rectangular projection's pose
    (``mkv_create_display_matrix``: ``av_display_rotation_set`` of the
    roll, negated unless flipped, then a horizontal flip for a yaw of
    180)."""
    hflip = yaw != 0.0
    angle = roll * (2 * hflip - 1)
    rad = -angle * math.pi / 180.0
    c, s = math.cos(rad), math.sin(rad)
    m = [int(c * 65536), int(-s * 65536), 0, int(s * 65536), int(c * 65536),
         0, 0, 0, 1 << 30]
    if hflip:
        for i in (0, 3, 6):
            m[i] = -m[i]
    return tuple(m)


def _lace(data: bytes, flags: int, what: str) -> List[Tuple[int, int]]:
    """(offset, size) of each frame in a block's data after its header
    (``data``: the bytes after track number, timecode and flags)."""
    kind = (flags >> 1) & 3
    if kind == 0:
        return [(0, len(data))]
    if not data:
        raise MkvError(f"{what}: a laced block without its lace count")
    count = data[0] + 1
    at = 1
    sizes: List[int] = []
    if kind == 1:      # Xiph
        for _ in range(count - 1):
            n = 0
            while True:
                if at >= len(data):
                    raise MkvError(f"{what}: Xiph lacing past the block")
                b = data[at]
                at += 1
                n += b
                if b != 255:
                    break
            sizes.append(n)
    elif kind == 3:    # EBML
        n, k = _vint(data, at, False)
        at += k
        sizes.append(n)
        for _ in range(count - 2):
            raw, k = _vint(data, at, False)
            n += raw - ((1 << (7 * k - 1)) - 1)
            at += k
            sizes.append(n)
    else:              # fixed size
        rest = len(data) - at
        if rest % count:
            raise MkvError(f"{what}: fixed-size lacing of {rest} bytes in "
                           f"{count} frames")
        sizes = [rest // count] * (count - 1)
    last = len(data) - at - sum(sizes)
    if last < 0 or any(n < 0 for n in sizes):
        raise MkvError(f"{what}: lace sizes past the block")
    out = []
    for n in sizes + [last]:
        out.append((at, n))
        at += n
    return out


def _blocks(r: _Reader, a: int, b: int, unknown: bool, number: int,
            frames: list, name: str) -> int:
    """Append (offset, size) of each frame of track ``number`` in the
    Cluster whose body starts at ``a`` to ``frames``; returns where the
    Cluster ends: at ``b``, or, for a Cluster of ``unknown`` size, at the
    first element that is no Cluster child (or ``b``, the Segment's
    end)."""
    pos = a
    while pos < b:
        h = r.header(pos)
        if h is None:
            return pos
        eid, size, body = h
        if unknown and eid in _TOP:
            return pos
        if size == UNKNOWN:
            raise MkvError(f"{name}: an element of unknown size "
                           f"(0x{eid:X}) in a Cluster")
        end = body + size
        if end > r.size:
            raise MkvError(f"{name}: an element (0x{eid:X}) at byte {pos} "
                           f"past the end of the file (frame "
                           f"{len(frames)})")
        blocks = [(body, end)] if eid == SIMPLE_BLOCK else \
            [(x, y) for bid, x, y in r.children(body, end) if bid == BLOCK] \
            if eid == BLOCK_GROUP else []
        for x, y in blocks:
            head = r.read(x, min(y, x + 12))
            track, n = _vint(head, 0, False)
            if track != number:
                continue
            if y - x < n + 3:
                raise MkvError(f"{name}: frame {len(frames)}: a block "
                               "shorter than its header")
            flags = head[n + 2]
            if (flags >> 1) & 3:
                data = r.read(x + n + 3, y)
                for off, size in _lace(data, flags,
                                       f"{name}: frame {len(frames)}"):
                    frames.append((x + n + 3 + off, size))
            else:
                frames.append((x + n + 3, y - x - n - 3))
        pos = end
    return pos


def probe_mkv(path: Path) -> Optional[avi.AviInfo]:
    """The first video track of a Matroska or WebM file, or None where it
    has none.  Raises an :class:`MkvError` (a ValueError) naming what the
    port refuses."""
    path = Path(path)
    try:
        size = os.path.getsize(path)
        f = open(path, "rb")
    except OSError:
        return None
    with f:
        r = _Reader(f, size)
        h = r.header(0)
        if h is None or h[0] != EBML:
            return None
        doctype = "matroska"
        for eid, x, y in r.children(h[2], h[2] + h[1]):
            if eid == 0x4282:
                doctype = r.read(x, y).rstrip(b"\0").decode("latin-1")
        container = "webm" if doctype == "webm" else "mkv"
        name = f"{path}: the {avi.CONTAINER_NAMES[container]}"
        pos = h[2] + h[1]
        seg = None
        while pos < size:
            h = r.header(pos)
            if h is None:
                break
            if h[0] == SEGMENT:
                seg = h
                break
            pos = h[2] + (h[1] if h[1] != UNKNOWN else size)
        if seg is None:
            return None
        seg_end = size if seg[1] == UNKNOWN else min(size, seg[2] + seg[1])
        track: Optional[_Track] = None
        frames: List[Tuple[int, int]] = []
        pos = seg[2]
        while pos < seg_end:
            h = r.header(pos)
            if h is None:
                break
            eid, esize, body = h
            end = seg_end if esize == UNKNOWN else body + esize
            if eid == TRACKS and track is None:
                entries = [_parse_track(r, x, y) for tid, x, y in
                           r.children(body, min(end, seg_end))
                           if tid == TRACK_ENTRY]
                video = [t for t in entries if t.kind == 1]
                if not video:
                    return None
                track = video[0]
            elif eid == CLUSTER:
                if track is None:
                    raise MkvError(f"{name}'s Tracks come after its first "
                                   "Cluster")
                end = _blocks(r, body, min(end, seg_end), esize == UNKNOWN,
                              track.number, frames, name)
            pos = end
        if track is None:
            return None
        return _info(path, track, frames, container, size, name)


def _info(path: Path, t: _Track, frames, container: str, size: int,
          name: str) -> avi.AviInfo:
    what = f"{name}'s video track ({t.codec})"
    if t.encrypted or any(kind == 1 for _, kind, _, _ in t.encodings):
        raise MkvError(f"{what} is encrypted")
    if len(t.encodings) > 1:
        raise MkvError(f"{what} has {len(t.encodings)} content encodings "
                       "(FFmpeg reads one)")
    prefix, compressed, private = b"", False, t.private
    if t.encodings:
        scope, _, algo, settings = t.encodings[0]
        if algo not in (0, 3):
            raise MkvError(f"{what} is compressed by "
                           f"{ {1: 'bzlib', 2: 'lzo'}.get(algo, algo)}")
        if scope & 1:
            prefix, compressed = (settings, False) if algo == 3 else \
                (b"", True)
        if scope & 2 and private:
            private = settings + private if algo == 3 else \
                zlib.decompress(private)
    offsets = np.array([o for o, _ in frames], np.int64)
    sizes = np.array([n for _, n in frames], np.int64)
    table = SampleTable(offsets, sizes, prefix, compressed)
    check_ranges(table, size, what)
    first = (lambda limit=None: table.first(path, limit))
    h, w = t.height, t.width
    tag: Optional[str] = ""
    if t.codec == "V_MS/VFW/FOURCC":
        if len(private) < 40:
            raise MkvError(f"{what}: a CodecPrivate of {len(private)} bytes, "
                           "not a BITMAPINFOHEADER")
        info = avi.bih_info(private, first)
        tag = private[16:20].decode("latin-1")
        if info is None:     # an MJPEG track whose first frame is no JPEG
            info = avi.AviInfo(tag.strip(), h, w, 3)
        if info.codec in ("DIB", "BITFIELDS"):
            raise MkvError(f"{what}: {info.codec} frames under "
                           "V_MS/VFW/FOURCC (FFmpeg does not turn their "
                           "rows as its AVI reader does)")
        codec_id = f"V_MS/VFW/FOURCC {info.codec}"
    elif t.codec == "V_UNCOMPRESSED":
        space = t.colour_space.decode("latin-1").strip()
        if space != "RGBA" and space not in avi.FOURCC_LAYOUTS:
            raise MkvError(f"{what} of ColourSpace {space or 'none'!r}, "
                           "which the port's rawvideo reader has no layout "
                           "of")
        info = avi.codec_info(space, h, w, 0, b"", first)
        codec_id = f"V_UNCOMPRESSED {space}"
    elif t.codec in MKV_CODECS:
        if t.codec == _AVC_ID and private[:1] != b"\x01":
            raise MkvError(f"{what}: a CodecPrivate of {len(private)} bytes "
                           "that is no avcC (AVCDecoderConfigurationRecord)")
        info = avi.codec_info(MKV_CODECS[t.codec], h, w, 0, private, first)
        if info is None:     # an MJPEG track whose first frame is no JPEG
            info = avi.AviInfo("MJPG", h, w, 3)
        codec_id = t.codec
    else:
        info = avi.AviInfo(t.codec, h, w, 3)
        codec_id = t.codec
    info.container, info.codec_id, info.tag = container, codec_id, tag
    info.samples = table
    info.colour = t.colour
    if t.projection is not None:
        kind, yaw, pitch, roll = t.projection
        if kind != 0:
            raise MkvError(f"{what} has a projection of type {kind} (the "
                           "port reads the rectangular one)")
        if pitch != 0.0 or yaw not in (0.0, 180.0, -180.0) or \
                math.isnan(roll):
            raise MkvError(f"{what} has a projection pose of yaw {yaw:g}, "
                           f"pitch {pitch:g}, roll {roll:g} (FFmpeg ignores "
                           "it; the port reads yaw 0 or 180 and pitch 0)")
        if yaw or roll:
            turn = rotation(_projection_matrix(yaw, roll))
            if turn is None:
                raise MkvError(f"{what} has a projection roll of {roll:g} "
                               "degrees, no quarter turn")
            info.rotation = turn
    return info
