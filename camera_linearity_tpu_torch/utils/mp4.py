"""QuickTime and ISO BMFF demuxer (``.mov``, ``.mp4``, ``.m4v``): the
video track's samples and what FFmpeg's ``mov`` demuxer makes of its
headers, pure Python.

The box walk takes 32- and 64-bit sizes and size 0 (to the end of the
file), a ``moov`` before or after the ``mdat``, and skips ``free``,
``skip``, ``wide`` and any box it does not know.  Of the tracks it takes
the first whose handler is ``vide``, as cv2 takes FFmpeg's first video
stream.  Its sample entry (one only) gives the codec, routed as an AVI's
fourcc is (``avi.codec_info``): ``mp4v`` by its ``esds`` object type (0x20
MPEG-4 Part 2, whose DecoderSpecificInfo is the extradata; 0x6C JPEG; 0x6D
PNG), ``avc1`` and ``avc3`` H.264 with their ``avcC`` as the extradata,
``jpeg`` and ``MJPG`` MJPEG, ``png `` PNG, ``FFV1``, ``HFYU``/``FFVH`` and
the Ut Video fourccs with their ``glbl`` extradata, ``RGBA`` and the
rawvideo fourccs; its depth is the bits per pixel; ``colr`` (``nclx``,
``nclc``) gives the colour tags.  ``stsz``/``stz2``, ``stco``/``co64`` and
``stsc`` (any runs) place the samples; ``stts``, ``ctts`` and ``stss`` time
and key them, and an edit list (``elst``) is applied as FFmpeg applies it:
empty edits first are honoured (they only delay the track), and of the
one edit after them FFmpeg decodes from the key sample at or before its
media time and shows the frames whose composition time lies in it (the
frames before and after are decoded where the decoding needs them, and
dropped).
The ``tkhd`` matrix, times the ``mvhd`` one, is the display matrix
(``containers.rotation``).

Refused by name, before any decode (ValueError): fragmented files
(``moof``/``mvex``), a compressed ``moov`` (``cmov``), external data
references, an ``avc1``/``avc3`` without its ``avcC``, encrypted sample
entries (``encv``, ``sinf``), several sample
descriptions, QuickTime's two-field ``mjpa``/``mjpb``, a ``raw `` track
(FFmpeg's RGB layouts the port has no reader of; at depths FFmpeg has no
pixel format for, cv2 opens no such file), several edits after the empty
ones, rates other than 1, display matrices other than quarter turns, a
sample table past the end of the file and empty samples.
"""
from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from . import avi
from .containers import SampleTable, check_ranges, rotation

__all__ = ["probe_mp4", "Mp4Error", "MOV_CODECS"]


class Mp4Error(ValueError):
    """An MOV/MP4 file the port refuses, or cannot read as cv2 does."""


# sample-entry fourccs -> the codec avi.codec_info routes (FFmpeg's mov
# tags, and the AVI tags it falls back to for video)
MOV_CODECS: Dict[str, str] = {
    "jpeg": "MJPG", "MJPG": "MJPG", "png ": "png", "MPNG": "MPNG",
    "FFV1": "FFV1", "HFYU": "HFYU", "FFVH": "FFVH", "RGBA": "RGBA",
    "LAGS": "LAGS",
    "avc1": "avc1", "avc3": "avc3",
    **{f: f for f in avi.MPEG4_CODECS}, **{f: f for f in avi.UTVIDEO_CODECS},
    **{f.ljust(4): f for f in avi.FOURCC_LAYOUTS},
}
# mp4v's esds object types -> codec
_OBJECT_TYPES = {0x20: None, 0x6C: "MJPG", 0x6D: "png"}
# QuickTime 'raw ' depths FFmpeg has a pixel format for
_RAW_DEPTHS = {1: "monob", 2: "pal8", 4: "pal8", 8: "pal8", 16: "rgb555be",
               24: "rgb24", 32: "argb", 33: "monob", 34: "gray", 36: "gray",
               40: "gray8"}


def _boxes(f, start: int, end: int) -> Iterator[Tuple[bytes, int, int]]:
    """(type, body start, body end) of the boxes in [start, end): 32-bit
    and 64-bit sizes, size 0 to ``end``; a box that runs past ``end`` is
    cut there, as FFmpeg's reader cuts it."""
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        head = f.read(16)
        if len(head) < 8:
            return
        size, kind = struct.unpack(">I4s", head[:8])
        body = pos + 8
        if size == 1:
            if len(head) < 16:
                return
            size = struct.unpack(">Q", head[8:16])[0]
            body = pos + 16
        elif size == 0:
            size = end - pos
        if size < body - pos:
            return     # a size smaller than its header: the walk ends
        yield kind, body, min(pos + size, end)
        pos += size


def _children(f, start: int, end: int) -> Dict[bytes, List[Tuple[int, int]]]:
    out: Dict[bytes, List[Tuple[int, int]]] = {}
    for kind, a, b in _boxes(f, start, end):
        out.setdefault(kind, []).append((a, b))
    return out


def _read(f, span: Tuple[int, int]) -> bytes:
    f.seek(span[0])
    return f.read(span[1] - span[0])


def _descriptor(data: bytes, at: int) -> Tuple[int, int, int]:
    """(tag, body start, body end) of an MPEG-4 descriptor at ``at``."""
    tag = data[at]
    at += 1
    size = 0
    for _ in range(4):
        b = data[at]
        at += 1
        size = (size << 7) | (b & 127)
        if not b & 128:
            break
    return tag, at, min(at + size, len(data))


def _esds(body: bytes) -> Tuple[int, bytes]:
    """(object type, DecoderSpecificInfo) of an ``esds`` box's body."""
    tag, a, end = _descriptor(body, 0)
    if tag != 3:
        return 0x20, b""
    flags = body[a + 2]
    a += 3
    if flags & 0x80:
        a += 2
    if flags & 0x40:
        a += 1 + body[a]
    if flags & 0x20:
        a += 2
    tag, a, end = _descriptor(body, a)
    if tag != 4:
        return 0x20, b""
    oti = body[a]
    a += 13
    dsi = b""
    while a < end:
        tag, b, e = _descriptor(body, a)
        if tag == 5:
            dsi = body[b:e]
        a = e
    return oti, dsi


def _matrix(data: bytes) -> Tuple[int, ...]:
    return struct.unpack(">9i", data)


def _times(runs, n: int) -> np.ndarray:
    """Per-sample values from (count, value) runs, the last value repeated
    or the runs cut to ``n`` samples."""
    counts = np.array([r[0] for r in runs], np.int64)
    values = np.array([r[1] for r in runs], np.int64)
    out = np.repeat(values, counts)[:n]
    if out.size < n:
        out = np.concatenate([out, np.full(n - out.size, values[-1] if
                                           values.size else 0, np.int64)])
    return out


class _Track:
    def __init__(self) -> None:
        self.handler = b""
        self.matrix = (65536, 0, 0, 0, 65536, 0, 0, 0, 1 << 30)
        self.timescale = 1
        self.entries: List[Tuple[bytes, bytes]] = []   # (fourcc, body)
        self.children: Dict[bytes, List[Tuple[int, int]]] = {}
        self.elst: Optional[List[Tuple[int, int, float]]] = None
        self.external = False


def _parse_track(f, span: Tuple[int, int]) -> _Track:
    t = _Track()
    kids = _children(f, *span)
    if b"tkhd" in kids:
        body = _read(f, kids[b"tkhd"][0])
        at = 4 + (32 if body[0] == 1 else 20) + 16
        if len(body) >= at + 36:
            t.matrix = _matrix(body[at:at + 36])
    for edts in kids.get(b"edts", []):
        for kind, a, b in _boxes(f, *edts):
            if kind != b"elst":
                continue
            body = _read(f, (a, b))
            version = body[0]
            n = struct.unpack(">I", body[4:8])[0]
            fmt, step = (">qqhh", 20) if version == 1 else (">iihh", 12)
            t.elst = []
            for i in range(n):
                rec = body[8 + i * step:8 + (i + 1) * step]
                if len(rec) < step:
                    break
                dur, media, whole, frac = struct.unpack(fmt, rec)
                if version != 1:
                    dur &= 0xFFFFFFFF
                t.elst.append((dur, media, whole + frac / 65536))
    mdia = _children(f, *kids[b"mdia"][0]) if b"mdia" in kids else {}
    if b"mdhd" in mdia:
        body = _read(f, mdia[b"mdhd"][0])
        t.timescale = struct.unpack(">I", body[20:24] if body[0] == 1
                                    else body[12:16])[0] or 1
    if b"hdlr" in mdia:
        t.handler = _read(f, mdia[b"hdlr"][0])[8:12]
    minf = _children(f, *mdia[b"minf"][0]) if b"minf" in mdia else {}
    for dinf in minf.get(b"dinf", []):
        for kind, a, b in _boxes(f, *dinf):
            if kind == b"dref":
                n = struct.unpack(">I", _read(f, (a + 4, a + 8)))[0]
                for j, (_, ea, eb) in enumerate(_boxes(f, a + 8, b)):
                    if j >= n:
                        break
                    flags = struct.unpack(">I", _read(f, (ea, ea + 4)))[0]
                    t.external |= not flags & 1
    if b"stbl" in minf:
        t.children = _children(f, *minf[b"stbl"][0])
        if b"stsd" in t.children:
            a, b = t.children[b"stsd"][0]
            for kind, ea, eb in _boxes(f, a + 8, b):
                t.entries.append((kind, _read(f, (ea, eb))))
    return t


def _sample_entry(body: bytes) -> Tuple[int, int, int, Dict[bytes, bytes]]:
    """(width, height, depth, child boxes) of a video sample entry."""
    width, height = struct.unpack(">HH", body[24:28])
    depth, ctab = struct.unpack(">Hh", body[74:78])
    at = 78
    if ctab == 0 and (depth & 0x1F) in (2, 4, 8) and len(body) >= at + 8:
        # an inline QuickTime colour table
        count = struct.unpack(">H", body[at + 6:at + 8])[0] + 1
        at += 8 + 8 * count
    kids: Dict[bytes, bytes] = {}
    while at + 8 <= len(body):
        size, kind = struct.unpack(">I4s", body[at:at + 8])
        if size < 8:
            break
        kids.setdefault(kind, body[at + 8:at + size])
        at += size
    return width, height, depth, kids


def _samples(f, t: _Track, what: str) -> Tuple[np.ndarray, ...]:
    """(offsets, sizes, dts, cts, keys) of a track's samples in decode
    order."""
    c = t.children
    if b"stsz" in c:
        body = _read(f, c[b"stsz"][0])
        fixed, n = struct.unpack(">II", body[4:12])
        sizes = np.full(n, fixed, np.int64) if fixed else \
            np.frombuffer(body[12:12 + 4 * n], ">u4").astype(np.int64)
    elif b"stz2" in c:
        body = _read(f, c[b"stz2"][0])
        bits = body[7]
        n = struct.unpack(">I", body[8:12])[0]
        if bits == 4:
            raw = np.frombuffer(body[12:12 + (n + 1) // 2], np.uint8)
            sizes = np.stack([raw >> 4, raw & 15], 1).reshape(-1)[:n]
        elif bits in (8, 16):
            sizes = np.frombuffer(body[12:12 + n * bits // 8],
                                  ">u%d" % (bits // 8))
        else:
            raise Mp4Error(f"an stz2 of {bits}-bit sizes")
        sizes = sizes.astype(np.int64)
    else:
        raise Mp4Error(f"{what} has no sample sizes (stsz or stz2)")
    if sizes.size < n:
        raise Mp4Error(f"{what}: its sample size table ends early "
                       f"({sizes.size} of {n} sizes)")
    if b"stco" in c:
        body = _read(f, c[b"stco"][0])
        k = struct.unpack(">I", body[4:8])[0]
        chunk_at = np.frombuffer(body[8:8 + 4 * k], ">u4").astype(np.int64)
    elif b"co64" in c:
        body = _read(f, c[b"co64"][0])
        k = struct.unpack(">I", body[4:8])[0]
        chunk_at = np.frombuffer(body[8:8 + 8 * k], ">u8").astype(np.int64)
    else:
        raise Mp4Error(f"{what} has no chunk offsets (stco or co64)")
    runs = []
    if b"stsc" in c:
        body = _read(f, c[b"stsc"][0])
        for i in range(struct.unpack(">I", body[4:8])[0]):
            first, per, desc = struct.unpack(">III", body[8 + 12 * i:
                                                          20 + 12 * i])
            if desc != 1:
                raise Mp4Error(f"{what}: chunks of sample description "
                               f"{desc} (several sample descriptions)")
            runs.append((first, per))
    if not runs or runs[0][0] != 1:
        raise Mp4Error(f"{what}: its sample-to-chunk table (stsc) does not "
                       "start at chunk 1")
    per_chunk = np.zeros(len(chunk_at), np.int64)
    for i, (first, per) in enumerate(runs):
        last = runs[i + 1][0] - 1 if i + 1 < len(runs) else len(chunk_at)
        per_chunk[first - 1:last] = per
    # the samples the chunks hold, up to the size table's count (FFmpeg's
    # index stops at the shorter)
    n = min(int(per_chunk.sum()), int(sizes.size))
    sizes = sizes[:n]
    chunk_of = np.repeat(np.arange(len(chunk_at)), per_chunk)[:n]
    starts = np.cumsum(per_chunk) - per_chunk
    csum = np.cumsum(sizes) - sizes          # bytes before each sample
    offsets = chunk_at[chunk_of] + csum - csum[starts[chunk_of]]
    stts = []
    if b"stts" in c:
        body = _read(f, c[b"stts"][0])
        for i in range(struct.unpack(">I", body[4:8])[0]):
            stts.append(struct.unpack(">II", body[8 + 8 * i:16 + 8 * i]))
    deltas = _times(stts or [(n, 1)], n)
    dts = np.cumsum(deltas) - deltas
    cts = dts.copy()
    if b"ctts" in c:
        body = _read(f, c[b"ctts"][0])
        runs_c = [struct.unpack(">Ii", body[8 + 8 * i:16 + 8 * i])
                  for i in range(struct.unpack(">I", body[4:8])[0])]
        cts = dts + _times(runs_c, n)
    keys = np.ones(n, bool)
    if b"stss" in c:
        body = _read(f, c[b"stss"][0])
        k = struct.unpack(">I", body[4:8])[0]
        sync = np.frombuffer(body[8:8 + 4 * k], ">u4").astype(np.int64) - 1
        keys[:] = False
        keys[sync[(sync >= 0) & (sync < n)]] = True
    return offsets, sizes, dts, cts, keys


def _edit(t: _Track, movie_scale: int, dts: np.ndarray, cts: np.ndarray,
          keys: np.ndarray, what: str) -> Tuple[int, int, int, int]:
    """(first sample, end sample, frames not shown first, frames shown) of
    a track under its edit list, as FFmpeg applies it: it decodes from the
    last key sample at or before the edit's media time and shows the
    frames whose composition time lies in the edit, [media time, media
    time + duration)."""
    n = len(dts)
    if t.elst is None or not n:
        return 0, n, 0, n
    edits = list(t.elst)
    while edits and edits[0][1] == -1:
        edits.pop(0)        # empty edits: the track starts later
    if len(edits) != 1:
        raise Mp4Error(f"{what}: an edit list of {len(t.elst)} edits "
                       f"({len(edits)} after the empty ones; the port "
                       "reads one)")
    duration, media, rate = edits[0]
    if rate != 1:
        raise Mp4Error(f"{what}: an edit at rate {rate:g}")
    if media < 0:
        raise Mp4Error(f"{what}: an edit at media time {media}")
    end = media + (duration * t.timescale + movie_scale // 2) // movie_scale
    at = np.flatnonzero(keys & (cts <= media))
    if not at.size:
        raise Mp4Error(f"{what}: no key sample at or before the edit's "
                       f"media time {media}")
    start = int(at[-1])
    inside = (cts >= media) & (cts < end)
    last = np.flatnonzero(cts < end)
    stop = max(start, int(last[-1]) + 1) if last.size else start
    skip = int(np.count_nonzero(cts[start:stop] < media))
    return start, stop, skip, int(np.count_nonzero(inside[start:stop]))


def probe_mp4(path: Path) -> Optional[avi.AviInfo]:
    """The first video track of a QuickTime or ISO BMFF file, or None where
    it has none (or no ``moov``).  Raises an :class:`Mp4Error` (a
    ValueError) naming what the port refuses."""
    path = Path(path)
    try:
        size = os.path.getsize(path)
        f = open(path, "rb")
    except OSError:
        return None
    with f:
        top = _children(f, 0, size)
        ftyp = _read(f, top[b"ftyp"][0])[:4] if b"ftyp" in top else b""
        container = "mov" if ftyp in (b"qt  ", b"") else "mp4"
        name = avi.CONTAINER_NAMES[container]
        if b"moof" in top:
            raise Mp4Error(f"{path}: a fragmented {name} (moof boxes)")
        if b"moov" not in top:
            return None
        moov = _children(f, *top[b"moov"][0])
        if b"cmov" in moov:
            raise Mp4Error(f"{path}: a compressed moov (cmov)")
        if b"mvex" in moov:
            raise Mp4Error(f"{path}: a fragmented {name} (mvex)")
        movie_matrix = (65536, 0, 0, 0, 65536, 0, 0, 0, 1 << 30)
        movie_scale = 1
        if b"mvhd" in moov:
            body = _read(f, moov[b"mvhd"][0])
            at = 20 if body[0] == 1 else 12
            movie_scale = struct.unpack(">I", body[at:at + 4])[0] or 1
            at += (12 if body[0] == 1 else 8) + 4 + 2 + 10
            movie_matrix = _matrix(body[at:at + 36])
        tracks = [_parse_track(f, span) for span in moov.get(b"trak", [])]
        video = [t for t in tracks if t.handler == b"vide"]
        if not video:
            return None
        t = video[0]
        what = f"{path}: the {name}'s video track"
        if t.external:
            raise Mp4Error(f"{what} keeps its data in another file (a dref "
                           "that is not self-contained)")
        if len(t.entries) != 1:
            raise Mp4Error(f"{what} has {len(t.entries)} sample "
                           "descriptions (the port reads one)")
        fourcc, body = t.entries[0]
        code = fourcc.decode("latin-1")
        if fourcc in (b"encv", b"drmi") or b"sinf" in body:
            raise Mp4Error(f"{what} is encrypted ({code})")
        if fourcc in (b"mjpa", b"mjpb"):
            raise Mp4Error(f"{what} is QuickTime Motion JPEG format "
                           f"{'A' if fourcc == b'mjpa' else 'B'} ({code}): "
                           "frames of two fields")
        width, height, depth, kids = _sample_entry(body)
        offsets, sizes, dts, cts, keys = _samples(f, t, what)
        start, stop, skip, shown = _edit(t, movie_scale, dts, cts, keys,
                                         what)
        table = SampleTable(offsets[start:stop], sizes[start:stop],
                            skip=skip, shown=shown)
        check_ranges(table, size, what)
        extra = b""
        codec = MOV_CODECS.get(code)
        if fourcc == b"mp4v":
            oti, dsi = _esds(kids[b"esds"][4:]) if b"esds" in kids \
                else (0x20, b"")
            if oti not in _OBJECT_TYPES:
                codec = None
                code = f"mp4v (object type 0x{oti:02X})"
            else:
                codec = _OBJECT_TYPES[oti] or "mp4v"
            extra = dsi
        elif fourcc in (b"avc1", b"avc3"):
            if b"avcC" not in kids:
                raise Mp4Error(f"{what} is H.264 ({code}) without its avcC "
                               "(the decoder configuration: the NAL length "
                               "size and the parameter sets)")
            extra = kids[b"avcC"]
        elif b"esds" in kids:
            extra = _esds(kids[b"esds"][4:])[1]
        elif b"glbl" in kids:
            extra = kids[b"glbl"]
        if fourcc == b"raw ":
            fmt = _RAW_DEPTHS.get(depth)
            if fmt is None:
                raise Mp4Error(
                    f"{what} is 'raw ' of depth {depth}, which FFmpeg has no "
                    "pixel format for: cv2 does not open it (Unable to "
                    "open video file)")
            codec, code = None, f"raw  ({fmt}, depth {depth})"
        first = (lambda limit=None: table.first(path, limit))
        if codec is None:
            info = avi.AviInfo(code.strip(), height, width, max(depth, 8)
                               // 8)
        else:
            info = avi.codec_info(codec, height, width, depth, extra, first)
            if info is None:    # an MJPG track whose first frame is no JPEG
                info = avi.AviInfo(codec, height, width, 3)
        info.container, info.codec_id = container, code
        info.tag = fourcc.decode("latin-1")
        info.samples = table
        info.colour = _colour(kids.get(b"colr"))
        matrix = _times_matrix(t.matrix, movie_matrix)
        turn = rotation(matrix)
        if turn is None:
            raise Mp4Error(f"{what} has a display matrix of another turn "
                           f"than a quarter ({matrix})")
        info.rotation = turn
        return info


def _times_matrix(track, movie) -> Tuple[int, ...]:
    """FFmpeg's product of the ``tkhd`` matrix and the ``mvhd`` one."""
    shifts = (16, 16, 30)
    out = []
    for i in range(3):
        for j in range(3):
            out.append(sum((track[i * 3 + e] * movie[e * 3 + j]) >> shifts[e]
                           for e in range(3)))
    return tuple(out)


def _colour(body: Optional[bytes]) -> Optional[Tuple[int, bool]]:
    """(matrix_coefficients, full range) of a ``colr`` box (``nclx``,
    ``nclc``), None for none (or an ICC profile)."""
    if body is None or body[:4] not in (b"nclx", b"nclc") or len(body) < 10:
        return None
    matrix = struct.unpack(">H", body[8:10])[0]
    full = body[:4] == b"nclx" and len(body) > 10 and bool(body[10] & 0x80)
    return matrix, full
