"""Plain NumPy version of the port's PNG-in-AVI decoder (``png.cpp``): one
PNG file (a frame chunk of an ``MPNG``, ``PNG1`` or ``png `` AVI) into the
(H, W, 3) BGR uint8 frame ``cv2.VideoCapture`` gives for it.

cv2 reads such an AVI through FFmpeg 8: the AVI demuxer, the PNG decoder
(pngdec.c) and swscale to BGR24.  What comes out, by the ``IHDR``'s colour
type and bit depth:

* gray (type 0) at 1, 2 and 4 bits: each sample scaled to 8 bits (x 255,
  85 and 17), in three equal channels; at 8 bits as it is; at 16 bits
  ``min(255, (v + 128) >> 8)`` (swscale's gray16 to 8 bits, probed on
  every one of the 65536 values);
* gray + alpha (type 4) at 8 and 16 bits: the gray sample as type 0's,
  the alpha dropped (not blended);
* RGB (type 2) and RGBA (type 6) at 8 bits: B, G, R, the alpha dropped;
  at 16 bits through swscale's scaled path (:func:`rgb16_to_bgr`), which
  takes FFmpeg's rgb48be and rgba64be to limited-range YUV with full
  chroma and back (probed on every value of each channel alone and of
  gray);
* palette (type 3) at 1, 2, 4 and 8 bits: the ``PLTE`` entry of each
  index, ``tRNS`` ignored;
* ``tRNS`` on the other types changes no sample (FFmpeg adds an alpha
  channel that swscale drops), and ``gAMA``, ``sRGB``, ``iCCP``,
  ``pHYs``, ``cHRM`` and text chunks are not applied.

The scanlines are unfiltered as the PNG specification (section 9) says,
each row by its own filter type (0-4, mixed freely), and an Adam7 image
(interlace 1) is put together from its seven passes, an empty pass having
no scanline.  cv2 5.0 gives memory it never wrote for an interlaced frame
(swscale refuses FFmpeg's interlaced frame with "Invalid argument"); the
port gives the image the file holds there.

Where FFmpeg would conceal an error the port raises, naming what: a chunk
whose CRC is wrong (FFmpeg checks CRCs only under ``err_detect``), a zlib
stream that is corrupt or ends before the image does, a filter type past
4, a palette index past the ``PLTE`` entries (FFmpeg gives opaque black).
"""
from __future__ import annotations

import struct
import zlib
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from .jpeg_plain import SWS_LIMITED

__all__ = ["SIGNATURE", "PNG_FOURCCS", "COLOR_TYPES", "PngInfo", "PngFrame",
           "PngError", "read_header", "unsupported", "read_frame",
           "passes", "scan_bytes", "unfilter", "decode_bgr", "layout_name",
           "rgb16_to_bgr"]

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# the AVI fourccs FFmpeg decodes as PNG
PNG_FOURCCS = ("MPNG", "PNG1", "png")
# samples per pixel of each colour type
COLOR_TYPES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}
# Adam7: (x0, y0, dx, dy) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


class PngError(ValueError):
    """A PNG the decoder does not read, or one FFmpeg would read with an
    error it conceals."""


class PngInfo(NamedTuple):
    """A PNG's ``IHDR``."""
    height: int
    width: int
    bit_depth: int
    color_type: int
    interlace: int


class PngFrame(NamedTuple):
    """One PNG, its chunks read: the header, the ``PLTE`` entries ((n, 3)
    R, G, B; None without one) and the zlib stream of its ``IDAT``
    chunks, joined."""
    info: PngInfo
    palette: Optional[np.ndarray]
    idat: bytes


def layout_name(info: PngInfo) -> str:
    """E.g. ``"RGB 8-bit"``, ``"palette 4-bit"``, ``"gray 16-bit
    interlaced"``."""
    return (f"{_NAMES.get(info.color_type, f'colour type {info.color_type}')}"
            f" {info.bit_depth}-bit" + " interlaced" * bool(info.interlace))


def _ihdr(body: bytes) -> PngInfo:
    if len(body) != 13:
        raise PngError(f"an IHDR of {len(body)} bytes")
    width, height, depth, ctype, comp, filt, inter = struct.unpack(
        ">IIBBBBB", body)
    if comp or filt:
        raise PngError(f"compression method {comp}, filter method {filt}")
    if inter > 1:
        raise PngError(f"interlace method {inter}")
    return PngInfo(height, width, depth, ctype, inter)


def read_header(data) -> Optional[PngInfo]:
    """The ``IHDR`` of a PNG file's bytes, or None where they do not start
    with a PNG signature and an ``IHDR``."""
    head = bytes(data[:33])
    if len(head) < 33 or head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        return None
    try:
        return _ihdr(head[16:29])
    except PngError:
        return None


def unsupported(info: PngInfo) -> Optional[str]:
    """What of a PNG's header the decoder does not read, or None."""
    if info.color_type not in DEPTHS or \
            info.bit_depth not in DEPTHS[info.color_type]:
        return (f"colour type {info.color_type} at {info.bit_depth} bits "
                "(not a PNG layout)")
    if info.width < 1 or info.height < 1:
        return f"an empty {info.height} x {info.width} image"
    return None


def read_frame(data) -> PngFrame:
    """A PNG's chunks, up to ``IEND``: its header, palette and zlib
    stream.  Raises :class:`PngError` for a missing signature or ``IHDR``,
    a chunk that runs past the data or whose CRC is wrong, a bad
    ``PLTE``, a palette image without one, or no ``IDAT``."""
    data = memoryview(data).cast("B")   # no copy of the frame's bytes
    if data[:8] != SIGNATURE:
        raise PngError("no PNG signature")
    pos, info, palette, idat = 8, None, None, []
    while True:
        if pos + 12 > len(data):
            raise PngError("the data end before IEND")
        size, tag = struct.unpack_from(">I4s", data, pos)
        end = pos + 12 + size
        if end > len(data):
            raise PngError(f"a {tag.decode('latin-1')!r} chunk runs past "
                           "the data")
        body = data[pos + 8:pos + 8 + size]
        if zlib.crc32(data[pos + 4:pos + 8 + size]) != \
                struct.unpack_from(">I", data, end - 4)[0]:
            raise PngError(f"a wrong CRC in the {tag.decode('latin-1')!r} "
                           "chunk")
        if info is None and tag != b"IHDR":
            raise PngError(f"{tag.decode('latin-1')!r} before IHDR")
        if tag == b"IHDR":
            if info is not None:
                raise PngError("a second IHDR")
            info = _ihdr(bytes(body))
        elif tag == b"PLTE":
            if size % 3 or not 0 < size <= 768:
                raise PngError(f"a PLTE of {size} bytes")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3).copy()
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos = end
    if not idat:
        raise PngError("no IDAT chunk")
    if info.color_type == 3 and palette is None:
        raise PngError("a palette image without PLTE")
    return PngFrame(info, palette, b"".join(idat))


def passes(info: PngInfo) -> List[Tuple[int, int, int, int, int, int]]:
    """(x0, y0, dx, dy, width, height) of every non-empty pass: the image
    itself, or Adam7's seven less the empty ones."""
    h, w = info.height, info.width
    if not info.interlace:
        return [(0, 0, 1, 1, w, h)]
    out = []
    for x0, y0, dx, dy in ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:
            out.append((x0, y0, dx, dy, pw, ph))
    return out


def _row_bytes(info: PngInfo, width: int) -> int:
    return -(-width * COLOR_TYPES[info.color_type] * info.bit_depth // 8)


def scan_bytes(info: PngInfo) -> int:
    """The bytes of the inflated scanlines: each pass's rows, a filter
    byte before each."""
    return sum(ph * (1 + _row_bytes(info, pw))
               for *_, pw, ph in passes(info))


def unfilter(scanlines: np.ndarray, bpp: int) -> np.ndarray:
    """(h, 1 + n) scanlines, each with its filter byte first, into the (h,
    n) bytes they hold (PNG section 9; ``bpp``: bytes a complete pixel,
    at least 1).  A wavefront over the anti-diagonals of (row, pixel):
    every filter reads only the pixel to the left, above and above-left,
    so the pixels of one diagonal are independent."""
    h = scanlines.shape[0]
    ftype = scanlines[:, 0].astype(np.int32)
    if (ftype > 4).any():
        raise PngError(f"filter type {int(ftype.max())} in row "
                       f"{int(np.argmax(ftype > 4))}")
    x = scanlines[:, 1:].reshape(h, -1, bpp).astype(np.int32)
    m = x.shape[1]
    out = np.zeros((h + 1, m + 1, bpp), np.int32)  # a zero row and column
    rows = np.arange(h)
    for d in range(h + m - 1):
        i = rows[max(0, d - m + 1):min(h, d + 1)]
        j = d - i
        a, b, c = out[i + 1, j], out[i, j + 1], out[i, j]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ftype[i][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[i + 1, j + 1] = (x[i, j] + pred) & 255
    return out[1:, 1:].reshape(h, -1).astype(np.uint8)


def _samples(rows: np.ndarray, info: PngInfo, width: int) -> np.ndarray:
    """(h, row bytes) -> (h, width, channels) samples."""
    h, ch, bd = rows.shape[0], COLOR_TYPES[info.color_type], info.bit_depth
    if bd == 16:
        return rows.view(">u2").reshape(h, width, ch).astype(np.int32)
    if bd == 8:
        return rows.reshape(h, width, ch).astype(np.int32)
    bits = np.unpackbits(rows, axis=1)[:, :width * bd].reshape(h, width, bd)
    weights = 1 << np.arange(bd - 1, -1, -1)
    return (bits * weights).sum(-1, dtype=np.int32)[..., None]


def _to_bgr(rows: np.ndarray, info: PngInfo, width: int,
            palette: Optional[np.ndarray]) -> np.ndarray:
    """One pass's unfiltered rows as (h, width, 3) BGR."""
    s = _samples(rows, info, width)
    bd = info.bit_depth
    if info.color_type == 3:
        idx = s[..., 0]
        if idx.max() >= len(palette):
            raise PngError(f"palette index {int(idx.max())} past the "
                           f"{len(palette)} PLTE entries")
        return np.ascontiguousarray(palette[idx][..., ::-1])
    if info.color_type in (0, 4):
        g = s[..., 0]
        g = np.minimum(255, (g + 128) >> 8) if bd == 16 else \
            g * (255 // ((1 << bd) - 1))
        return np.repeat(g[..., None], 3, -1).astype(np.uint8)
    if bd == 16:
        return rgb16_to_bgr(s)
    return np.ascontiguousarray(s[..., 2::-1]).astype(np.uint8)


# swscale's RGB-to-YUV coefficients (RGB2YUV_SHIFT 15) for the default
# BT.601 matrix, which fill_rgb2yuv_table sets from these C doubles
_S = 1 << 15
RGB2YUV = dict(
    ry=int(0.299 * 219 / 255 * _S + 0.5), gy=int(0.587 * 219 / 255 * _S + 0.5),
    by=int(0.114 * 219 / 255 * _S + 0.5), ru=-int(0.169 * 224 / 255 * _S + 0.5),
    gu=-int(0.331 * 224 / 255 * _S + 0.5), bu=int(0.500 * 224 / 255 * _S + 0.5),
    rv=int(0.500 * 224 / 255 * _S + 0.5), gv=-int(0.419 * 224 / 255 * _S + 0.5),
    bv=-int(0.081 * 224 / 255 * _S + 0.5))


def rgb16_to_bgr(s: np.ndarray) -> np.ndarray:
    """(h, w, 3 or 4) 16-bit R, G, B(, A) samples as swscale gives them in
    BGR24: rgb48ToY/rgb48ToUV (rgba64's are the same) to 16-bit
    limited-range Y, U, V at full chroma (an RGB source's chroma is not
    subsampled, so the output takes full chroma too), hScale16To15's
    one-tap identity (v >> 1), then the full-chroma C output
    (yuv2rgb_write_full) with the limited-range tables; the alpha
    dropped."""
    r, g, b = (s[..., k].astype(np.int64) for k in range(3))
    t, rng = RGB2YUV, SWS_LIMITED

    def plane(kr, kg, kb, offset):       # 15 bits: (16-bit sum) >> 1
        return (kr * r + kg * g + kb * b + (offset << 14)) >> 16
    y = plane(t["ry"], t["gy"], t["by"], 0x2001)
    u = (plane(t["ru"], t["gu"], t["bu"], 0x10001) - (128 << 7)) * 4
    v = (plane(t["rv"], t["gv"], t["bv"], 0x10001) - (128 << 7)) * 4
    yy = (y * 4 - (rng.oy >> 7)) * rng.yc + (1 << 21)
    bgr = (yy + u * rng.ub, yy + u * rng.ug + v * rng.vg, yy + v * rng.vr)
    return np.stack([np.clip(c, 0, (1 << 30) - 1) >> 22 for c in bgr],
                    -1).astype(np.uint8)


def decode_bgr(data, height: Optional[int] = None,
               width: Optional[int] = None) -> np.ndarray:
    """One PNG file's (H, W, 3) BGR uint8 frame, as cv2 gives it (an
    interlaced one as the file holds it).  ``height``/``width``, where
    given, must be the ``IHDR``'s.  Raises :class:`PngError` (a
    ValueError) naming what it does not read or what is wrong."""
    frame = read_frame(data)
    info = frame.info
    if (height, width) != (None, None) and \
            (info.height, info.width) != (height, width):
        raise PngError(f"a {info.height} x {info.width} image, not "
                       f"{height} x {width}")
    why = unsupported(info)
    if why:
        raise PngError(why)
    try:
        raw = zlib.decompress(frame.idat)
    except zlib.error as exc:
        raise PngError(f"a corrupt zlib stream ({exc})") from exc
    need = scan_bytes(info)
    if len(raw) < need:
        raise PngError(f"the zlib stream holds {len(raw)} bytes of the "
                       f"{need} the scanlines need")
    out = np.empty((info.height, info.width, 3), np.uint8)
    bpp = max(1, COLOR_TYPES[info.color_type] * info.bit_depth // 8)
    data = np.frombuffer(raw, np.uint8)
    at = 0
    for x0, y0, dx, dy, pw, ph in passes(info):
        n = ph * (1 + _row_bytes(info, pw))
        rows = unfilter(data[at:at + n].reshape(ph, -1), bpp)
        out[y0::dy, x0::dx] = _to_bgr(rows, info, pw, frame.palette)
        at += n
    return out
