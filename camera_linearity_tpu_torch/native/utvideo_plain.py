"""Plain version of the port's UtVideo decoder (``utvideo.cpp``): one frame
chunk of a Ut Video AVI into its planes and into the (H, W, 3) BGR uint8
frame ``cv2.VideoCapture`` gives for it.

cv2 reads such an AVI through FFmpeg 8: the AVI demuxer, the utvideo
decoder (utvideodec.c) and swscale to BGR24.  The fourcc gives the layout
(``LAYOUTS``): ``ULRG`` gbrp, ``ULRA`` gbrap, ``ULY0``/``ULH0`` yuv420p,
``ULY2``/``ULH2`` yuv422p, ``ULY4``/``ULH4`` yuv444p.  The stream's
parameters are the 16 bytes after the BITMAPINFOHEADER (:func:`params`;
FFmpeg reads the first 16 of longer extradata): the encoder's version,
the original format, the frame-information size (4) and the flags:
``(flags >> 24) + 1`` slices, ``0x800`` interlaced (bit 0, Huffman
coding, and the others are not read).

A frame is its planes (G, B, R, A for RGB; Y, U, V for YUV), then a
32-bit frame-information word whose bits 8-9 are the predictor (0 none,
1 left, 2 gradient, 3 median; the other bits, and any bytes after it,
are not read).  A plane is 256 code lengths, one cumulative 32-bit end
offset per slice, then the slices' data.  A length of 0 (the first one
in symbol order) makes the whole plane that symbol; 255 is an unused
symbol; 1-32 a code length, the codes canonical with the longest codes
and, within a length, the largest symbols taking the smallest values
(:func:`canonical_codes`; a tree that is not full is read).  A slice is
32-bit little-endian words read most significant bit first; slice ``i``
of a plane of ``h`` rows spans rows ``h * i // slices`` to ``h * (i + 1)
// slices``, each rounded down to even for the luma of yuv420p
(interlaced: to a multiple of 4 for that luma, of 2 for every other
plane).

Prediction restarts at every slice.  Left: a running sum from 0x80 through
the slice's rows.  Gradient and median: the first row as left, then each
row's first sample from the one above and the others from ``top -
top_left + left`` (gradient) or the median of left, top and that
(median), the median's left neighbours running on from the end of the
row above.  An interlaced stream predicts each pair of rows as one row of
twice the width.  RGB's B and R planes hold ``B - G + 0x80`` and ``R - G
+ 0x80``; the alpha plane is decoded and dropped (cv2 gives BGR).  YUV
planes go through swscale's limited-range conversion as the port's
rawvideo reader converts them (``rawvideo_plain.decode_bgr``: ``i420``,
``yuv422p``, ``yuv444p``), with the BT.601 matrix for ``ULY*`` and BT.709
for ``ULH*``: FFmpeg tags the frames so and cv2's swscale follows the tag
(:func:`matrix`).  cv2 5.0 gives memory swscale never wrote for an
interlaced frame (it refuses to convert interlaced frames to progressive
ones); this decoder gives the picture the stream holds (the planes
FFmpeg's decoder gives, converted as a progressive frame).

Refused (:func:`unsupported`), before any decode: Ut Video Pro's 10-bit
fourccs (``UQY0``, ``UQY2``, ``UQRG``, ``UQRA``) and the pack mode's
(``UM*``), which FFmpeg reads but the port does not; extradata under 16
bytes (FFmpeg refuses it) and a frame-information size other than 4; an
odd width for yuv420p and yuv422p, an odd height for yuv420p (FFmpeg
refuses both); an interlaced height that leaves the last rows undecoded,
and the interlaced median predictor on a plane one sample wide (FFmpeg
reads an unset neighbour there).  A frame whose planes run past the
chunk, whose code lengths FFmpeg's table builder refuses, whose codes
are in no table or run past their slice, or whose coded slice is empty
(FFmpeg fails on each) raises :class:`UtvideoError` naming the plane and
the slice.
"""
from __future__ import annotations

import struct
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from .rawvideo_plain import decode_bgr as _raw_bgr

__all__ = ["UTVIDEO_FOURCCS", "REFUSED_FOURCCS", "PREDICTORS", "LAYOUTS",
           "UtvideoParams", "UtvideoError", "params", "unsupported",
           "size_unsupported", "layout_name", "plane_shapes", "slice_rows",
           "canonical_codes",
           "decode_planes", "decode_bgr", "yuv_layout", "matrix"]

# fourcc: layout
LAYOUTS = {"ULRG": "gbrp", "ULRA": "gbrap", "ULY0": "yuv420p",
           "ULH0": "yuv420p", "ULY2": "yuv422p", "ULH2": "yuv422p",
           "ULY4": "yuv444p", "ULH4": "yuv444p"}
UTVIDEO_FOURCCS = tuple(LAYOUTS)
# what FFmpeg also reads as Ut Video, and the port refuses by name
REFUSED_FOURCCS = {
    **{f: "Ut Video Pro (10-bit)" for f in ("UQY0", "UQY2", "UQRG",
                                            "UQRA")},
    **{f: "Ut Video's pack mode" for f in ("UMY2", "UMH2", "UMY4", "UMH4",
                                           "UMRG", "UMRA")}}
NONE, LEFT, GRADIENT, MEDIAN = 0, 1, 2, 3
PREDICTORS = ("none", "left", "gradient", "median")
INTERLACED = 0x800


class UtvideoError(ValueError):
    """A Ut Video stream the decoder does not read, or a frame FFmpeg would
    fail to decode or decode into memory it never wrote."""


class UtvideoParams(NamedTuple):
    """What a stream's header says: the fourcc, the layout (``"gbrp"``,
    ``"gbrap"``, ``"yuv420p"``, ``"yuv422p"``, ``"yuv444p"``), the number of
    slices and whether it is interlaced."""
    codec: str
    layout: str
    slices: int
    interlaced: bool


def params(codec: str, extradata: bytes) -> UtvideoParams:
    """A stream's :class:`UtvideoParams` from its fourcc and extradata (the
    ``strf`` bytes past 40).  Raises :class:`UtvideoError` naming what the
    decoder does not read."""
    if codec in REFUSED_FOURCCS:
        raise UtvideoError(f"{REFUSED_FOURCCS[codec]} ({codec})")
    if codec not in LAYOUTS:
        raise UtvideoError(f"fourcc {codec!r}")
    if len(extradata) < 16:
        raise UtvideoError(f"extradata of {len(extradata)} bytes (FFmpeg "
                           "needs 16)")
    info_size, flags = struct.unpack("<II", bytes(extradata[8:16]))
    if info_size != 4:
        raise UtvideoError(f"a frame-information size of {info_size} bytes "
                           "(FFmpeg reads 4)")
    return UtvideoParams(codec, LAYOUTS[codec], (flags >> 24) + 1,
                         bool(flags & INTERLACED))


def layout_name(p: UtvideoParams) -> str:
    """E.g. ``"ULY0 yuv420p, 9 slices, interlaced"``."""
    return (f"{p.codec} {p.layout}, {p.slices} slice"
            + "s" * (p.slices > 1) + ", interlaced" * p.interlaced)


def plane_shapes(layout: str, height: int, width: int) -> List[Tuple[int,
                                                                     int]]:
    """Each coded plane's (rows, columns), in the order they are stored."""
    if layout in ("gbrp", "gbrap"):
        return [(height, width)] * (3 if layout == "gbrp" else 4)
    ch = height // 2 if layout == "yuv420p" else height
    cw = width if layout == "yuv444p" else width // 2
    return [(height, width), (ch, cw), (ch, cw)]


def _row_mask(p: UtvideoParams, plane: int) -> int:
    """The multiple slice boundaries of ``plane`` are rounded down to."""
    luma420 = plane == 0 and p.layout == "yuv420p"
    return (4 if luma420 else 2) if p.interlaced else (2 if luma420 else 1)


def slice_rows(p: UtvideoParams, plane: int, rows: int) -> List[Tuple[int,
                                                                      int]]:
    """The [start, end) rows of each slice of ``plane`` (``rows`` high)."""
    m = _row_mask(p, plane)
    ends = [rows * (i + 1) // p.slices // m * m for i in range(p.slices)]
    return list(zip([0] + ends[:-1], ends))


def unsupported(codec: str, extradata: bytes, height: int,
                width: int) -> Optional[str]:
    """What of a Ut Video stream's header the decoder does not read, or
    None."""
    try:
        p = params(codec, extradata)
    except UtvideoError as exc:
        return str(exc)
    return size_unsupported(p, height, width)


def size_unsupported(p: UtvideoParams, height: int,
                     width: int) -> Optional[str]:
    """What of a stream of ``p`` at ``height`` x ``width`` the decoder
    does not read, or None."""
    if width < 1 or height < 1:
        return f"an image of {height} x {width}"
    if p.layout in ("yuv420p", "yuv422p") and width % 2 or \
            p.layout == "yuv420p" and height % 2:
        return (f"{layout_name(p)} of {height} x {width} (FFmpeg refuses "
                "odd dimensions for subsampled chroma)")
    for k, (rows, cols) in enumerate(plane_shapes(p.layout, height, width)):
        if slice_rows(p, k, rows)[-1][1] != rows:
            return (f"{layout_name(p)} of height {height}: FFmpeg leaves "
                    "the last rows undecoded")
        if p.interlaced and cols == 1:
            # restore_median_planar_il then reads a neighbour it never set
            return (f"{layout_name(p)} with a plane one sample wide (FFmpeg's "
                    "interlaced median reads an unset neighbour there)")
    return None


def canonical_codes(lengths: np.ndarray) -> Tuple[np.ndarray, bool]:
    """The codes of ``lengths`` (1-32; 0 for unused symbols) as FFmpeg's
    utvideo decoder builds them: the longest codes first, and within a
    length the symbols in descending order, take consecutive values from
    0.  Also False where ``ff_vlc_init_from_lengths`` refuses them (a code
    not aligned to its length, or more codes than fit)."""
    order = sorted((s for s in range(len(lengths)) if lengths[s]),
                   key=lambda s: (-int(lengths[s]), -s))
    codes = np.zeros(len(lengths), np.uint64)
    code = 0
    for s in order:
        n = int(lengths[s])
        if code & ((1 << (32 - n)) - 1):
            return codes, False
        codes[s] = code >> (32 - n)
        code += 1 << (32 - n)
        if code > 1 << 32:
            return codes, False
    return codes, True


class _Table:
    """One plane's code table, or its fill symbol: the next 12 bits look up
    codes of up to 12 bits (``lut``: length << 8 | symbol), longer ones
    are found by length."""

    def __init__(self, raw: bytes) -> None:
        self.fill = None
        lengths = np.zeros(256, np.uint8)
        for s, n in enumerate(raw):
            if n == 0:
                self.fill = s
                return
            if n > 32 and n != 255:
                raise UtvideoError(f"code length {n} for symbol {s}")
            lengths[s] = 0 if n == 255 else n
        if not lengths.any():
            raise UtvideoError("no symbol has a code")
        codes, ok = canonical_codes(lengths)
        if not ok:
            raise UtvideoError("code lengths FFmpeg refuses (not a prefix "
                               "code)")
        self.lut = [0] * 4096
        self.long = {}
        for s in range(256):
            n, code = int(lengths[s]), int(codes[s])
            if not n:
                continue
            if n <= 12:
                base = code << (12 - n)
                for k in range(1 << (12 - n)):
                    self.lut[base + k] = n << 8 | s
            else:
                self.long[(n, code)] = s

    def read(self, data: bytes, start: int, size: int, count: int
             ) -> np.ndarray:
        """``count`` symbols from the slice of ``size`` bytes at ``start``
        of ``data``: 32-bit little-endian words, each from its most
        significant bit; words past the data read as zero."""
        nwords = -(-size // 4) + 2
        chunk = bytes(data[start:start + 4 * nwords])
        chunk += bytes(4 * nwords - len(chunk))
        words = np.frombuffer(chunk, "<u4").astype(np.uint64)
        windows = ((words[:-1] << np.uint64(32)) | words[1:]).tolist()
        lut, long_, p, out = self.lut, self.long, 0, []
        append = out.append
        limit = 8 * size
        for _ in range(count):
            if p >= limit:
                raise UtvideoError("its codes run past the slice")
            w = (windows[p >> 5] >> (32 - (p & 31))) & 0xFFFFFFFF
            e = lut[w >> 20]
            if not e:
                for n in range(13, 33):
                    s = long_.get((n, w >> (32 - n)))
                    if s is not None:
                        e = n << 8 | s
                        break
                else:
                    raise UtvideoError("a code that is in no table")
            p += e >> 8
            append(e & 255)
        if p > limit:
            raise UtvideoError("its codes run past the slice")
        return np.array(out, np.int64)


def _restore(res: np.ndarray, predictor: int) -> np.ndarray:
    """One slice's samples from its residuals ((rows, columns), int64;
    an interlaced slice's row pairs as rows of twice the width)."""
    if predictor == NONE or not res.size:
        return res & 255
    if predictor == LEFT:
        return (0x80 + np.cumsum(res.reshape(-1))).reshape(res.shape) & 255
    out = np.empty_like(res)
    out[0] = (0x80 + np.cumsum(res[0])) & 255
    if predictor == GRADIENT:
        # top - top_left + left + residual along a row is the row above
        # plus the running sum of the residuals
        for r in range(1, len(res)):
            out[r] = (out[r - 1] + np.cumsum(res[r])) & 255
        return out
    if len(res) < 2:
        return out
    w = res.shape[1]
    top = out[0].tolist()
    left = (top[0] + int(res[1, 0])) & 255
    row = [left]
    lt = top[0]
    for r in range(1, len(res)):
        diff = res[r].tolist()
        for i in range(1 if r == 1 else 0, w):
            t = top[i]
            g = (left + t - lt) & 255
            lo, hi = (left, t) if left < t else (t, left)
            left = ((lo if g < lo else hi if g > hi else g) + diff[i]) & 255
            lt = t
            row.append(left)
        out[r] = row
        top, row = row, []
    return out


def decode_planes(payload, p: UtvideoParams, height: int,
                  width: int) -> Tuple[List[np.ndarray], int]:
    """One chunk's decoded planes (uint8, in stored order: G, B - G + 0x80,
    R - G + 0x80 and A for RGB; Y, U, V for YUV) and its predictor.
    Raises :class:`UtvideoError` naming the plane and slice FFmpeg would
    fail on."""
    data = bytes(payload)
    shapes = plane_shapes(p.layout, height, width)
    at, spans = 0, []
    for k, _ in enumerate(shapes):
        if len(data) - at < 256 + 4 * p.slices:
            raise UtvideoError(f"plane {k} runs past the chunk")
        ends = struct.unpack_from(f"<{p.slices}I", data, at + 256)
        start = 0
        for j, end in enumerate(ends):
            if end < start or len(data) - (at + 256 + 4 * p.slices) < end:
                raise UtvideoError(f"plane {k}, slice {j}: its end offset "
                                   f"{end} runs past the chunk")
            start = end
        spans.append((at, ends))
        at += 256 + 4 * p.slices + ends[-1]
    if len(data) - at < 4:
        raise UtvideoError("the frame information runs past the chunk")
    predictor = (struct.unpack_from("<I", data, at)[0] >> 8) & 3
    planes = []
    for k, ((rows, cols), (base, ends)) in enumerate(zip(shapes, spans)):
        try:
            table = _Table(data[base:base + 256])
        except UtvideoError as exc:
            raise UtvideoError(f"plane {k}: {exc}") from None
        plane = np.zeros((rows, cols), np.int64)
        body = base + 256 + 4 * p.slices
        pair = 2 if p.interlaced else 1
        for j, (r0, r1) in enumerate(slice_rows(p, k, rows)):
            n = (r1 - r0) * cols
            if table.fill is not None:
                res = np.full(n, table.fill, np.int64)
            else:
                start = ends[j - 1] if j else 0
                if ends[j] == start:
                    raise UtvideoError(f"plane {k}, slice {j}: an empty "
                                       "slice in a coded plane")
                try:
                    res = table.read(data, body + start, ends[j] - start, n)
                except UtvideoError as exc:
                    raise UtvideoError(f"plane {k}, slice {j}: {exc}"
                                       ) from None
            view = res.reshape((r1 - r0) // pair, cols * pair)
            plane[r0:r1] = _restore(view, predictor).reshape(r1 - r0, cols)
        planes.append(plane.astype(np.uint8))
    return planes, predictor


def yuv_layout(p: UtvideoParams) -> Optional[str]:
    """The rawvideo layout a YUV stream's planes convert as (``"i420"``,
    ``"yuv422p"`` or ``"yuv444p"``); None for RGB."""
    return {"yuv420p": "i420", "yuv422p": "yuv422p",
            "yuv444p": "yuv444p"}.get(p.layout)


def matrix(p: UtvideoParams) -> str:
    """The matrix a YUV stream's planes convert with: ``"bt709"`` for the
    ``ULH*`` fourccs (FFmpeg tags them BT.709 and cv2's swscale follows
    the tag), else ``"bt601"``."""
    return "bt709" if p.codec.startswith("ULH") else "bt601"


def decode_bgr(payload, p: UtvideoParams, height: int,
               width: int) -> np.ndarray:
    """One chunk's (H, W, 3) BGR uint8 frame, as cv2 gives it."""
    planes, _ = decode_planes(payload, p, height, width)
    if p.layout in ("gbrp", "gbrap"):
        g = planes[0].astype(np.int64)
        b = (planes[1] + g - 0x80) & 255
        r = (planes[2] + g - 0x80) & 255
        return np.stack([b, g, r], -1).astype(np.uint8)
    return _raw_bgr(b"".join(c.tobytes() for c in planes), yuv_layout(p),
                    height, width, matrix=matrix(p))
