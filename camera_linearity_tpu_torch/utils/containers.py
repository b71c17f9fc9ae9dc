"""The video containers the port reads without cv2: AVI (``utils/avi.py``),
QuickTime and ISO BMFF (``.mov``, ``.mp4``, ``.m4v``: ``utils/mp4.py``) and
Matroska (``.mkv``, ``.webm``: ``utils/mkv.py``).

:func:`probe_video` tells them apart by their first bytes, never by the
file name's suffix, and gives the video stream's ``avi.AviInfo``: its
codec routed as an AVI's BITMAPINFOHEADER routes it (``avi.codec_info``),
so every decoder of the port reads its frames whatever the container.
:func:`frame_chunks` then yields the frames' bytes: an AVI's chunks, or
the samples an MP4 or Matroska demuxer found (a :class:`SampleTable` of
byte ranges, with Matroska's header stripping and zlib undone).  An
H.264 frame's bytes go to its decoder as they are: Annex B NAL units
(an AVI's chunk, ``V_MS/VFW/FOURCC``) or length-prefixed ones (under an
``avcC``, whose length size ``h264_plain.Stream`` takes), several NAL
units a frame in either form.

What FFmpeg's demuxers do that changes the frames ``cv2.VideoCapture``
gives is done here too: the first video track is the one cv2 picks; an
MP4 edit list drops the frames shown before and after it (they are
decoded, not shown: :attr:`SampleTable.skip`, ``shown``); the display
matrix (an
MP4's ``tkhd`` and ``mvhd`` matrices, a Matroska ``Projection``'s pose)
turns the frames as cv2 turns them (``AviInfo.rotation``: :func:`rotation`
is FFmpeg's ``av_display_rotation_get`` and cv2's rounding).  What it
cannot match raises a ValueError naming it, before any decode.

Where a frame's bytes come from (an AVI's chunks or a :class:`SampleTable`)
is decided here only: the decoders and ``utils/avi.py``'s routing take
the bytes from :func:`frame_chunks`, :func:`mjpg_chunks`,
:func:`raw_chunks`, :func:`rgba_frames` and ``AviInfo.first``.
"""
from __future__ import annotations

import math
import zlib
from pathlib import Path
from typing import Iterator, NamedTuple, Optional, Sequence

import numpy as np

from . import avi

__all__ = ["probe_video", "frame_chunks", "mjpg_chunks", "raw_chunks",
           "rgba_frames", "raw_unsupported", "SampleTable", "rotation",
           "sniff"]

# ISO BMFF and QuickTime top-level boxes a file may start with
_BOX_STARTS = (b"ftyp", b"moov", b"mdat", b"free", b"skip", b"wide",
               b"pnot", b"uuid", b"jP  ")


def sniff(path: Path) -> Optional[str]:
    """``"avi"``, ``"isobmff"`` or ``"ebml"`` from a file's first bytes, or
    None (unreadable, or none of them)."""
    try:
        with open(path, "rb") as f:
            head = f.read(12)
    except OSError:
        return None
    if head[:4] == b"RIFF" and head[8:12] == b"AVI ":
        return "avi"
    if head[:4] == b"\x1a\x45\xdf\xa3":
        return "ebml"
    if len(head) >= 8 and head[4:8] in _BOX_STARTS:
        return "isobmff"
    return None


def probe_video(path: Path) -> Optional[avi.AviInfo]:
    """The first video stream of an AVI, MOV/MP4 or Matroska file, or None
    when ``path`` is none of them (or has no video stream).  Raises a
    ValueError naming what the port cannot read the way cv2 reads it
    (``utils/mp4.py``, ``utils/mkv.py``)."""
    kind = sniff(path)
    if kind == "avi":
        return avi.probe_avi(path)
    if kind == "isobmff":
        from . import mp4
        return mp4.probe_mp4(path)
    if kind == "ebml":
        from . import mkv
        return mkv.probe_mkv(path)
    return None


class SampleTable(NamedTuple):
    """A stream's frames in an MP4 or Matroska file, in decode order: each
    frame's stored bytes at ``offsets`` (int64) of ``sizes`` (int64), with
    ``prefix`` put before them (Matroska's header stripping) and, where
    ``compressed``, inflated first (zlib); of the frames the decoder gives,
    the first ``skip`` are not shown and only ``shown`` after them are
    (None: all; an MP4 edit list: FFmpeg decodes the frames before and
    after the edit where the decoding needs them, and drops them)."""
    offsets: np.ndarray
    sizes: np.ndarray
    prefix: bytes = b""
    compressed: bool = False
    skip: int = 0
    shown: Optional[int] = None

    def __len__(self) -> int:
        return len(self.sizes)

    def read(self, f, i: int) -> bytes:
        """Frame ``i``'s bytes as the decoder takes them (``f``: the file,
        opened in binary)."""
        size = int(self.sizes[i])
        f.seek(int(self.offsets[i]))
        data = f.read(size)
        if len(data) < size:
            raise ValueError(f"sample {i} ends early: {len(data)} of its "
                             f"{size} bytes are in the file")
        if self.compressed:
            try:
                data = zlib.decompress(data)
            except zlib.error as exc:
                raise ValueError(f"sample {i} does not inflate: {exc}") \
                    from None
        return self.prefix + data

    def first(self, path: Path, limit: Optional[int] = None) -> bytes:
        """The first frame's bytes (its first ``limit``), empty where the
        stream has none."""
        if not len(self):
            return b""
        with open(path, "rb") as f:
            data = self.read(f, 0)
        return data if limit is None else data[:limit]

    def decoded_sizes(self) -> Optional[np.ndarray]:
        """Each frame's size as the decoder takes it; None where the frames
        are compressed (known only once inflated)."""
        if self.compressed:
            return None
        return self.sizes + len(self.prefix)


def check_ranges(table: SampleTable, file_size: int, what: str) -> None:
    """Raise a ValueError naming the first frame whose bytes lie past the
    end of the file (a damaged sample table or a cut file)."""
    ends = table.offsets + table.sizes
    bad = np.flatnonzero((table.offsets < 0) | (ends > file_size))
    if bad.size:
        i = int(bad[0])
        raise ValueError(f"{what} sample {i} lies past the end of the file "
                         f"(bytes {int(table.offsets[i])}-{int(ends[i])} of "
                         f"a {file_size}-byte file)")
    empty = np.flatnonzero(table.sizes + len(table.prefix) == 0)
    if empty.size:
        raise ValueError(f"{what} sample {int(empty[0])} is empty")


def rotation(matrix: Sequence[int]) -> Optional[int]:
    """The clockwise turn cv2 gives frames under a display matrix (nine
    ints, FFmpeg's layout: 16.16 but for the third column, 2.30): FFmpeg's
    ``av_display_rotation_get`` and cv2's rounding of it, 0, 90, 180 or
    270; None for another angle (cv2 does not turn the frame then, but the
    port does not follow it there) or a degenerate matrix."""
    s0 = math.hypot(matrix[0] / 65536, matrix[3] / 65536)
    s1 = math.hypot(matrix[1] / 65536, matrix[4] / 65536)
    if s0 == 0 or s1 == 0:
        return None
    got = -math.degrees(math.atan2(matrix[1] / 65536 / s1,
                                   matrix[0] / 65536 / s0))
    angle = -round(got) % 360   # cvRound (to even), then into 0..359
    return angle if angle % 90 == 0 else None


def frame_chunks(path: Path, info: avi.AviInfo, ring: int = 1,
                 need: int = 0) -> Iterator[np.ndarray]:
    """Yield each non-empty frame of the video stream as a uint8 array,
    read into one of ``ring`` reused buffers in turn (valid until ``ring``
    more are requested), whatever the container: an AVI's chunks
    (``avi.frame_chunks``), an MP4's or Matroska file's samples.  A frame
    shorter than ``need`` bytes ends the stream."""
    if info.container == "avi":
        yield from avi.frame_chunks(path, info, ring, need)
        return
    table: SampleTable = info.samples
    buffers: list = [np.empty(0, np.uint8)] * ring
    plain = not table.compressed and not table.prefix
    with open(path, "rb", buffering=0) as f:
        for i in range(len(table)):
            slot = i % ring
            if plain:
                size = int(table.sizes[i])
                if size < need:
                    return
                if buffers[slot].size < size:
                    buffers[slot] = np.empty(size, np.uint8)
                f.seek(int(table.offsets[i]))
                view = memoryview(buffers[slot])[:size]
                got = 0
                while got < size:
                    n = f.readinto(view[got:])
                    if not n:
                        raise ValueError(
                            f"{path}: sample {i} ends early: {got} of its "
                            f"{size} bytes are in the file")
                    got += n
                yield buffers[slot][:size]
                continue
            try:
                data = table.read(f, i)
            except ValueError as exc:
                raise ValueError(f"{path}: {exc}") from None
            if len(data) < need:
                return
            if buffers[slot].size < len(data):
                buffers[slot] = np.empty(len(data), np.uint8)
            buffers[slot][:len(data)] = np.frombuffer(data, np.uint8)
            yield buffers[slot][:len(data)]


def mjpg_chunks(path: Path, info: avi.AviInfo) -> Iterator[bytes]:
    """Each frame of an MJPG stream as bytes, whatever the container: an
    AVI's chunks, empty ones too (``avi.mjpg_chunks``: the JPEG decoder's
    ``"ffmpeg"`` mode drops them, as FFmpeg's AVI reader does), or an MP4's
    or Matroska file's samples."""
    if info.container == "avi":
        return avi.mjpg_chunks(path, info.stream)
    return (bytes(c) for c in frame_chunks(path, info))


def raw_chunks(path: Path, info: avi.AviInfo, ring: int = 1
               ) -> Iterator[np.ndarray]:
    """:func:`frame_chunks` of an uncompressed stream of ``info.layout``:
    a frame shorter than the layout's ends the stream, as cv2's read loop
    ends at it (FFmpeg decodes no frame from it)."""
    return frame_chunks(path, info, ring, avi.frame_bytes(
        info.layout, info.height, info.width))


def rgba_frames(path: Path, info: avi.AviInfo) -> Iterator[np.ndarray]:
    """Each frame of an ``RGBA`` stream as an (H, W, 3) BGR uint8 view of a
    reused buffer (valid until the next one is requested): an AVI's through
    ``avi.raw_frames``; another container's samples, top-down rows of R,
    G, B, A bytes, any other size raising a ValueError naming the
    sample."""
    if info.container == "avi":
        yield from avi.raw_frames(path)
        return
    h, w = info.height, info.width
    for i, chunk in enumerate(frame_chunks(path, info)):
        if chunk.size != h * w * 4:
            raise ValueError(f"{path}: RGBA sample {i} of {chunk.size} bytes,"
                             f" expected {h} x {w} x 4 = {h * w * 4}")
        yield chunk.reshape(h, w, 4)[..., 2::-1]


def raw_unsupported(path: Path, info: avi.AviInfo) -> Optional[str]:
    """What of an uncompressed stream the port's rawvideo reader does not
    read, or None when it reads every frame: an AVI's as
    ``avi.raw_unsupported`` finds it; in an MP4 or Matroska file a frame
    longer than the layout's frame that is not its padded size either
    (zlib-compressed frames' sizes are known only once inflated, so they
    are not checked here: a wrong one raises when it is read)."""
    if info.container == "avi":
        return avi.raw_unsupported(path, info)
    if info.layout is None:
        return None
    sizes = avi.chunk_sizes(info.layout, info.height, info.width)
    decoded = info.samples.decoded_sizes()
    big = [] if decoded is None else [
        i for i, n in enumerate(decoded) if n > sizes[0] and n not in sizes]
    if not big:
        return None
    n = int(decoded[big[0]])
    return (f"a {info.layout} frame (sample {big[0]}) of {n} bytes, not the "
            f"{info.height} x {info.width} frame's "
            + " or ".join(map(str, sizes)))
