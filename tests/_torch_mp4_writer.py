"""A test muxer for QuickTime and ISO BMFF (``.mov``, ``.mp4``): plain
Python that wraps given samples, with the layouts ``cv2.VideoWriter``
never writes.

It writes one video track of given samples and sample-entry children
(``esds``, ``glbl``, ``colr``, ``fiel``: the helpers below build them),
and optionally a PCM audio track first, a second video track, a ``tkhd``
display matrix turned by 90, 180 or 270 degrees, ``co64`` chunk offsets,
``stsc`` runs of several chunk sizes, ``stz2`` sizes, ``ctts``, ``stss``
and ``elst`` entries, ``moov`` before or after ``mdat``, a 64-bit or a
size-0 ``mdat``, and ``free``/``skip``/``wide`` boxes.  ``chip_smoke.py``
imports it to remux its 4K bitstreams, as it imports the other writers of
``tests/``: the card's machine has no cv2.
"""
from __future__ import annotations

import math
import struct
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence

__all__ = ["box", "full_box", "esds", "glbl", "colr_nclx", "colr_nclc",
           "fiel", "Track", "video_track", "pcm_track", "write_mp4",
           "rotation_matrix"]

TIMESCALE = 12800          # the media timescale FFmpeg's muxer picks at 25 fps
DELTA = 512                # a frame's duration in it
MOVIE_TIMESCALE = 1000


def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(body), kind) + body


def full_box(kind: bytes, version: int, flags: int, body: bytes) -> bytes:
    return box(kind, struct.pack(">I", (version << 24) | flags) + body)


def _descriptor(tag: int, body: bytes) -> bytes:
    # the four-byte size form FFmpeg's muxer writes
    n = len(body)
    size = bytes([0x80 | (n >> 21) & 127, 0x80 | (n >> 14) & 127,
                  0x80 | (n >> 7) & 127, n & 127])
    return bytes([tag]) + size + body


def esds(dsi: bytes, oti: int = 0x20) -> bytes:
    """An ``esds`` box: an ES descriptor whose DecoderConfigDescriptor has
    object type ``oti`` (0x20 MPEG-4 Visual, 0x6C JPEG, 0x6D PNG) and, where
    ``dsi`` is given, a DecoderSpecificInfo holding it."""
    dec = bytes([oti, 0x11]) + bytes(3) + struct.pack(">II", 0, 0)
    if dsi:
        dec += _descriptor(5, dsi)
    es = struct.pack(">HB", 1, 0) + _descriptor(4, dec) + \
        _descriptor(6, b"\x02")
    return full_box(b"esds", 0, 0, _descriptor(3, es))


def glbl(extradata: bytes) -> bytes:
    return box(b"glbl", extradata)


def colr_nclx(primaries: int, transfer: int, matrix: int,
              full_range: bool) -> bytes:
    return box(b"colr", b"nclx" + struct.pack(
        ">HHHB", primaries, transfer, matrix, 0x80 if full_range else 0))


def colr_nclc(primaries: int, transfer: int, matrix: int) -> bytes:
    return box(b"colr", b"nclc" + struct.pack(">HHH", primaries, transfer,
                                             matrix))


def fiel(fields: int, detail: int = 0) -> bytes:
    return box(b"fiel", bytes([fields, detail]))


def rotation_matrix(degrees: int) -> tuple:
    """The nine ``tkhd`` matrix values (16.16 but for u, v, w, 2.30) that
    turn the picture by ``degrees`` clockwise on display."""
    r = math.radians(degrees)
    c, s = round(math.cos(r)), round(math.sin(r))
    return (c << 16, s << 16, 0, -s << 16, c << 16, 0, 0, 0, 1 << 30)


IDENTITY = rotation_matrix(0)


class Track(NamedTuple):
    """One track: its handler (``vide``/``soun``), ``stsd`` entry, samples
    and tables.  ``chunks`` are the samples per chunk, cycled (default one
    chunk of every sample); ``ctts`` composition offsets, ``sync`` the
    1-based key samples (None: no ``stss``, every sample a key), ``elst``
    (duration in the movie timescale, media time, rate) entries (None: no
    ``edts``)."""
    handler: bytes
    entry: bytes
    samples: Sequence[bytes]
    width: int = 0
    height: int = 0
    chunks: Sequence[int] = ()
    ctts: Optional[Sequence[int]] = None
    ctts_version: int = 0
    sync: Optional[Sequence[int]] = None
    elst: Optional[Sequence[tuple]] = None
    matrix: tuple = IDENTITY
    delta: int = DELTA
    timescale: int = TIMESCALE
    stz2: bool = False
    fixed_size: bool = False


def video_track(samples: Sequence[bytes], height: int, width: int,
                fourcc: bytes = b"mp4v", children: Sequence[bytes] = (),
                depth: int = 24, qt: bool = False, **kw) -> Track:
    """A video track whose sample entry is ``fourcc`` with the given child
    boxes (``esds``, ``glbl``, ``colr``, ``fiel``); ``qt`` writes the
    QuickTime vendor and qualities as FFmpeg's MOV muxer does."""
    vendor = b"FFMP" if qt else bytes(4)
    quality = struct.pack(">II", 512, 512) if qt else bytes(8)
    entry = bytes(6) + struct.pack(">H", 1) + struct.pack(">HH", 0, 0) + \
        vendor + quality + struct.pack(">HH", width, height) + \
        struct.pack(">II", 0x480000, 0x480000) + struct.pack(">I", 0) + \
        struct.pack(">H", 1) + bytes(32) + struct.pack(">Hh", depth, -1) + \
        b"".join(children)
    return Track(b"vide", box(fourcc, entry), list(samples), width, height,
                 **kw)


def pcm_track(samples: Sequence[bytes], **kw) -> Track:
    """A 16-bit mono ``sowt`` audio track of the given sample chunks."""
    entry = bytes(6) + struct.pack(">H", 1) + bytes(8) + \
        struct.pack(">HHHHI", 1, 16, 0, 0, 48000 << 16)
    return Track(b"soun", box(b"sowt", entry), list(samples), **kw)


def _runs(counts: List[int]) -> List[tuple]:
    runs = []
    for i, n in enumerate(counts):
        if not runs or runs[-1][1] != n:
            runs.append((i + 1, n))
    return runs


def _trak(index: int, track: Track, offsets: List[int], counts: List[int],
          co64: bool) -> bytes:
    n = len(track.samples)
    duration = n * track.delta
    movie = duration * MOVIE_TIMESCALE // track.timescale
    tkhd = full_box(b"tkhd", 0, 3, struct.pack(
        ">IIIII", 0, 0, index + 1, 0, movie) + bytes(8) + struct.pack(
        ">hhhH", 0, 0, 0x100 if track.handler == b"soun" else 0, 0)
        + struct.pack(">9i", *track.matrix)
        + struct.pack(">II", track.width << 16, track.height << 16))
    edts = b""
    if track.elst is not None:
        edts = box(b"edts", full_box(b"elst", 0, 0, struct.pack(
            ">I", len(track.elst)) + b"".join(
            struct.pack(">IiI", d, t, int(r * 65536))
            for d, t, r in track.elst)))
    mdhd = full_box(b"mdhd", 0, 0, struct.pack(
        ">IIIIHH", 0, 0, track.timescale, duration, 0x55C4, 0))
    hdlr = full_box(b"hdlr", 0, 0, bytes(4) + track.handler + bytes(12) +
                    b"Handler\0")
    media_header = full_box(b"vmhd", 0, 1, bytes(8)) \
        if track.handler == b"vide" else full_box(b"smhd", 0, 0, bytes(4))
    dinf = box(b"dinf", full_box(b"dref", 0, 0, struct.pack(">I", 1) +
                                 full_box(b"url ", 0, 1, b"")))
    stsd = full_box(b"stsd", 0, 0, struct.pack(">I", 1) + track.entry)
    stts = full_box(b"stts", 0, 0, struct.pack(">III", 1, n, track.delta))
    tables = [stsd, stts]
    if track.ctts is not None:
        runs: List[list] = []
        for v in track.ctts:
            if runs and runs[-1][1] == v:
                runs[-1][0] += 1
            else:
                runs.append([1, v])
        tables.append(full_box(b"ctts", track.ctts_version, 0, struct.pack(
            ">I", len(runs)) + b"".join(
            struct.pack(">Ii", c, v) for c, v in runs)))
    if track.sync is not None:
        tables.append(full_box(b"stss", 0, 0, struct.pack(
            ">I", len(track.sync)) + b"".join(
            struct.pack(">I", s) for s in track.sync)))
    runs = _runs(counts)
    tables.append(full_box(b"stsc", 0, 0, struct.pack(">I", len(runs)) +
                           b"".join(struct.pack(">III", c, k, 1)
                                    for c, k in runs)))
    sizes = [len(s) for s in track.samples]
    if track.stz2:
        tables.append(full_box(b"stz2", 0, 0, struct.pack(
            ">I", 16) + struct.pack(">I", n) + b"".join(
            struct.pack(">H", s) for s in sizes)))
    elif track.fixed_size and len(set(sizes)) == 1:
        tables.append(full_box(b"stsz", 0, 0, struct.pack(">II", sizes[0],
                                                          n)))
    else:
        tables.append(full_box(b"stsz", 0, 0, struct.pack(">II", 0, n) +
                               b"".join(struct.pack(">I", s)
                                        for s in sizes)))
    if co64:
        tables.append(full_box(b"co64", 0, 0, struct.pack(
            ">I", len(offsets)) + b"".join(struct.pack(">Q", o)
                                           for o in offsets)))
    else:
        tables.append(full_box(b"stco", 0, 0, struct.pack(
            ">I", len(offsets)) + b"".join(struct.pack(">I", o)
                                           for o in offsets)))
    stbl = box(b"stbl", b"".join(tables))
    minf = box(b"minf", media_header + dinf + stbl)
    mdia = box(b"mdia", mdhd + hdlr + minf)
    return box(b"trak", tkhd + edts + mdia)


def _layout(tracks: Sequence[Track]):
    """Each track's chunks (lists of samples), interleaved track by track
    in turn: [(track, samples)] in file order."""
    per = []
    for t in tracks:
        cycle = list(t.chunks) or [max(1, len(t.samples))]
        chunks, at, k = [], 0, 0
        while at < len(t.samples):
            n = cycle[k % len(cycle)]
            chunks.append(t.samples[at:at + n])
            at += n
            k += 1
        per.append(chunks)
    order = []
    for i in range(max(len(c) for c in per)):
        for t, chunks in enumerate(per):
            if i < len(chunks):
                order.append((t, chunks[i]))
    return order


def write_mp4(path: Path, tracks: Sequence[Track], qt: bool = False,
              moov_first: bool = False, co64: bool = False,
              mdat64: bool = False, mdat_size0: bool = False,
              spacers: Sequence[bytes] = (b"free",),
              movie_matrix: tuple = IDENTITY, extra_top: bytes = b"",
              moov_extra: bytes = b"") -> None:
    """Write ``tracks`` into one ``mdat`` (their chunks interleaved) and a
    ``moov``; ``qt`` writes a QuickTime ``ftyp`` (``qt  ``), else an ISO
    one (``isom``).  ``spacers`` are empty boxes written before ``mdat``
    (``free``, ``skip``, ``wide``); ``mdat_size0`` writes ``mdat`` last
    with size 0 (to the end of the file), so the ``moov`` goes first;
    ``extra_top`` and ``moov_extra`` are raw boxes written at the top level
    and inside ``moov``."""
    ftyp = box(b"ftyp", b"qt  " + struct.pack(">I", 0x200) + b"qt  ") \
        if qt else box(b"ftyp", b"isom" + struct.pack(">I", 0x200) +
                       b"isomiso2mp41")
    head = ftyp + extra_top + b"".join(box(s, b"") for s in spacers)
    order = _layout(tracks)
    size = sum(len(s) for _, samples in order for s in samples)
    mdat_header = 16 if mdat64 else 8
    moov_first = moov_first or mdat_size0

    def moov(base: int) -> bytes:
        offsets: List[List[int]] = [[] for _ in tracks]
        counts: List[List[int]] = [[] for _ in tracks]
        at = base
        for t, samples in order:
            offsets[t].append(at)
            counts[t].append(len(samples))
            at += sum(len(s) for s in samples)
        duration = max(len(t.samples) * t.delta * MOVIE_TIMESCALE //
                       t.timescale for t in tracks)
        mvhd = full_box(b"mvhd", 0, 0, struct.pack(
            ">IIIIIH", 0, 0, MOVIE_TIMESCALE, duration, 0x10000, 0x100) +
            bytes(10) + struct.pack(">9i", *movie_matrix) + bytes(24) +
            struct.pack(">I", len(tracks) + 1))
        return box(b"moov", mvhd + moov_extra + b"".join(
            _trak(i, t, offsets[i], counts[i], co64)
            for i, t in enumerate(tracks)))

    if moov_first:
        data = moov(len(head) + len(moov(0)) + mdat_header)
    else:
        data = moov(len(head) + mdat_header)
    if mdat64:
        mdat = struct.pack(">I4sQ", 1, b"mdat", 16 + size)
    elif mdat_size0:
        mdat = struct.pack(">I4s", 0, b"mdat")
    else:
        mdat = struct.pack(">I4s", 8 + size, b"mdat")
    # the samples go straight to the file: 4K videos are large
    with open(path, "wb") as f:
        f.write(head)
        if moov_first:
            f.write(data)
        f.write(mdat)
        for _, samples in order:
            for s in samples:
                f.write(s)
        if not moov_first:
            f.write(data)
