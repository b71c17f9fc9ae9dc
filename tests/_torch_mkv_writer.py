"""A test muxer for Matroska (``.mkv``, ``.webm``): plain Python that wraps
given frames, with the layouts ``cv2.VideoWriter`` never writes.

It writes an EBML header and a Segment with Info, Tracks and Clusters: one
video track of given frames (CodecID, CodecPrivate, ``Video`` with its
``Colour``, ``Projection`` and ``ColourSpace``), optionally an audio
track first or a second video track, frames in SimpleBlocks or in
BlockGroups, laced (Xiph, EBML or fixed-size) or not, in Clusters of a
known or an unknown size, under ``ContentEncodings`` (header stripping or
zlib), with CRC-32 and Void elements.  ``chip_smoke.py`` imports it to
remux its 4K bitstreams: the card's machine has no cv2.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence

__all__ = ["element", "Track", "video_track", "audio_track", "write_mkv",
           "UNKNOWN"]

UNKNOWN = -1   # an element size of all ones: unknown


def _id(value: int) -> bytes:
    n = (value.bit_length() + 7) // 8
    return value.to_bytes(n, "big")


def _size(n: int, width: int = 0) -> bytes:
    if n == UNKNOWN:
        return b"\x01" + b"\xff" * 7
    width = width or next(w for w in range(1, 9)
                          if n < (1 << (7 * w)) - 1)
    return ((1 << (7 * width)) | n).to_bytes(width, "big")


def element(eid: int, body, width: int = 0) -> bytes:
    """An element: ``body`` bytes, an int (unsigned, big-endian), or a
    float (8 bytes)."""
    if isinstance(body, bool):
        body = int(body)
    if isinstance(body, int):
        body = body.to_bytes(max(1, (body.bit_length() + 7) // 8), "big")
    elif isinstance(body, float):
        body = struct.pack(">d", body)
    elif isinstance(body, str):
        body = body.encode()
    return _id(eid) + _size(len(body), width) + body


def _crc(children: bytes) -> bytes:
    return element(0xBF, struct.pack("<I", zlib.crc32(children)))


def _master(eid: int, children: bytes, crc: bool = False,
            unknown: bool = False) -> bytes:
    if crc:
        children = _crc(children) + children
    if unknown:
        return _id(eid) + _size(UNKNOWN) + children
    return element(eid, children)


class Track(NamedTuple):
    """One track: its number, type (1 video, 2 audio), CodecID,
    CodecPrivate, the raw elements of its ``Video`` master, its frames and
    its ``ContentEncodings`` (``("strip", header)`` or ``("zlib", scope)``
    entries)."""
    number: int
    kind: int
    codec: str
    private: bytes
    video: bytes
    frames: Sequence[bytes]
    encodings: Sequence[tuple] = ()


def video_track(frames: Sequence[bytes], height: int, width: int,
                codec: str, private: bytes = b"", number: int = 1,
                colour: Optional[Dict[int, int]] = None,
                colour_space: bytes = b"",
                projection: Optional[Dict[int, float]] = None,
                encodings: Sequence[tuple] = ()) -> Track:
    """A video track; ``colour`` maps ``Colour`` child IDs to values
    (0x55B1 MatrixCoefficients, 0x55B9 Range, 0x55BA
    TransferCharacteristics, 0x55BB Primaries), ``projection`` maps
    ``Projection`` child IDs to values (0x7671 ProjectionType, an int;
    0x7673 PoseYaw, 0x7674 PosePitch, 0x7675 PoseRoll, floats)."""
    video = element(0xB0, width) + element(0xBA, height)
    if colour_space:
        video += element(0x2EB524, colour_space)
    if colour:
        video += element(0x55B0, b"".join(element(k, v)
                                          for k, v in colour.items()))
    if projection:
        video += element(0x7670, b"".join(
            element(k, float(v) if k != 0x7671 else int(v))
            for k, v in projection.items()))
    return Track(number, 1, codec, private, video, list(frames),
                 tuple(encodings))


def audio_track(frames: Sequence[bytes], number: int) -> Track:
    audio = element(0xB5, 48000.0) + element(0x9F, 1)
    return Track(number, 2, "A_PCM/INT/LIT", b"", audio, list(frames))


def _encodings(track: Track) -> bytes:
    out = b""
    for order, enc in enumerate(track.encodings):
        if enc[0] == "strip":
            comp = element(0x4254, 3) + element(0x4255, enc[1])
            scope = enc[2] if len(enc) > 2 else 1
        elif enc[0] == "zlib":
            comp = element(0x4254, 0)
            scope = enc[1] if len(enc) > 1 else 1
        else:   # ("encrypt",)
            out += element(0x6240, element(0x5031, order) +
                           element(0x5032, 1) + element(0x5033, 1) +
                           element(0x5035, element(0x47E1, 5)))
            continue
        out += element(0x6240, element(0x5031, order) +
                       element(0x5032, scope) + element(0x5033, 0) +
                       element(0x5034, comp))
    return element(0x6D80, out) if out else b""


def _entry(track: Track) -> bytes:
    body = element(0xD7, track.number) + element(0x73C5, track.number) + \
        element(0x83, track.kind) + element(0x86, track.codec)
    if track.private:
        body += element(0x63A2, track.private)
    body += element(0xE0 if track.kind == 1 else 0xE1, track.video)
    return element(0xAE, body + _encodings(track))


def _coded(track: Track, frame: bytes) -> bytes:
    for enc in track.encodings:
        if enc[0] == "strip":
            if not frame.startswith(enc[1]):
                raise ValueError("a frame without the stripped header")
            frame = frame[len(enc[1]):]
        elif enc[0] == "zlib" and (enc[1] if len(enc) > 1 else 1) & 1:
            frame = zlib.compress(frame)
    return frame


def _xiph(n: int) -> bytes:
    return b"\xff" * (n // 255) + bytes([n % 255])


def _signed_vint(v: int, width: int = 0) -> bytes:
    width = width or next(w for w in range(1, 9)
                          if -(1 << (7 * w - 1)) < v < (1 << (7 * w - 1)) - 1)
    return _size(v + (1 << (7 * width - 1)) - 1, width)


def _block(track: Track, frames: List[bytes], lacing: str, timecode: int,
           key: bool, simple: bool) -> bytes:
    flags = (0x80 if key and simple else 0)
    body = b"".join(frames)
    lace = b""
    if len(frames) > 1:
        flags |= {"xiph": 0x02, "fixed": 0x04, "ebml": 0x06}[lacing]
        lace = bytes([len(frames) - 1])
        if lacing == "xiph":
            lace += b"".join(_xiph(len(f)) for f in frames[:-1])
        elif lacing == "ebml":
            lace += _size(len(frames[0]))
            for a, b in zip(frames, frames[1:-1]):
                lace += _signed_vint(len(b) - len(a))
        elif len(set(map(len, frames))) != 1:
            raise ValueError("fixed-size lacing of frames of several sizes")
    head = _size(track.number) + struct.pack(">hB", timecode, flags)
    block = head + lace + body
    if simple:
        return element(0xA3, block)
    group = element(0xA1, block)
    if not key:
        group += element(0xFB, b"\xff")     # ReferenceBlock -1
    return element(0xA0, group)


def write_mkv(path: Path, tracks: Sequence[Track], doctype: str = "matroska",
              per_cluster: int = 4, lace: int = 1, lacing: str = "xiph",
              block_groups: bool = False, unknown_cluster: bool = False,
              unknown_segment: bool = False, crc: bool = False,
              void: bool = False, keys: Optional[Sequence[int]] = None,
              header_extra: bytes = b"") -> None:
    """Write ``tracks`` into a Segment.  Each Cluster holds ``per_cluster``
    of every track's frames, in turn track by track, ``lace`` frames a
    block (laced by ``lacing`` where more than one); ``block_groups``
    writes BlockGroups, else SimpleBlocks; ``unknown_cluster`` and
    ``unknown_segment`` write those sizes as unknown; ``crc`` puts a
    CRC-32 first in every master of the Segment that takes one, ``void``
    a Void element between elements; ``keys`` are the video frames that
    are keyframes (default all)."""
    ebml = element(0x1A45DFA3, element(0x4286, 1) + element(0x42F7, 1) +
                   element(0x42F2, 4) + element(0x42F3, 8) +
                   element(0x4282, doctype) + element(0x4287, 4) +
                   element(0x4285, 2))
    spacer = element(0xEC, bytes(5)) if void else b""
    info = _master(0x1549A966, element(0x2AD7B1, 1000000) +
                   element(0x4D80, "test muxer") + element(0x5741,
                                                           "test muxer"),
                   crc)
    entries = b"".join(_entry(t) + spacer for t in tracks)
    parts = [info + spacer + _master(0x1654AE6B, entries, crc) + spacer +
             header_extra]
    n = max(len(t.frames) for t in tracks)
    for at in range(0, n, per_cluster):
        children = [element(0xE7, at * 40)]
        for t in tracks:
            frames = [_coded(t, f) for f in t.frames[at:at + per_cluster]]
            for i in range(0, len(frames), lace):
                index = at + i
                key = keys is None or t.kind != 1 or index in keys
                children += [_block(t, frames[i:i + lace], lacing, i * 40,
                                    key, not block_groups), spacer]
        parts.append(_master(0x1F43B675, b"".join(children), crc,
                             unknown_cluster))
    size = sum(map(len, parts))
    with open(path, "wb") as f:
        f.write(ebml + _id(0x18538067) + (_size(UNKNOWN) if unknown_segment
                                          else _size(size, 8)))
        for part in parts:
            f.write(part)
