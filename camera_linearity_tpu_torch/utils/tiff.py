"""The port's TIFF reader and writer: the container around the native
codec (``native/tiff.cpp``).

``imread`` returns what ``cv2.imread`` (OpenCV 5.0 and its libtiff)
returns for the TIFFs it reads, so the port loads captures on machines
without OpenCV exactly as the JAX package loads them with it.  OpenCV
takes one of two routes, and so does ``imread``:

* libtiff's RGBA reader (``TIFFReadRGBA*``) whenever the result has 8-bit
  samples: always under ``IMREAD_COLOR``, and under ``IMREAD_UNCHANGED``
  for 8-bit samples, palette images and 16-bit gray + alpha.  It maps each
  pixel to 8-bit RGBA as libtiff does (16-bit gray as ``v >> 8``, 16-bit
  RGB as ``round(v / 257)``, MinIsWhite inverted, palette colours through
  the colormap, shifted down 8 bits unless every entry is below 256, CMYK
  as ``(255 - K) * (255 - C) // 255``, unassociated alpha premultiplied as
  ``(v * a + 127) // 255``), then OpenCV keeps BGR, BGRA (4 samples under
  IMREAD_UNCHANGED) or one gray channel (``(R*4899 + G*9617 + B*1868 +
  8192) >> 14``, ``v`` itself for gray images); signed 8-bit samples come
  back as int8 with the same bytes.  Orientation: libtiff mirrors each
  tile (strip) across its width for Orientation 2, 3, 6 and 7, the rows
  are flipped for 3, 4, 7 and 8, both axes for 6 and 8, and 5-8 are
  transposed.  In chunky gray and palette tiles cut by the right edge,
  libtiff steps from row to row by a wrong count (``_gray_edge_tiles``).
* a direct read for everything else under ``IMREAD_UNCHANGED``: the
  samples as stored (RGB as BGR, RGBA as BGRA; 10-, 12- and 14-bit
  samples as uint16 ``v << (16 - bits)``; MinIsWhite not inverted), then
  the Orientation applied as EXIF defines it.

``None`` where cv2 gives None: 32- and 64-bit samples and 10/12/14-bit
samples under IMREAD_COLOR; Orientation 5-8 on an image that is not
square (OpenCV cannot transpose it in place); two samples other than 8-
or 16-bit gray + alpha and 8-bit palette + alpha (RGB with 2 samples
among them); RGB with one sample under the RGBA reader.  One known divergence: cv2 reads
PlanarConfiguration 2 through the direct route as if the planes were
chunky (its result depends on memory it never wrote); ``imread`` gives
the stored image.

It reads the first IFD of a classic TIFF or a BigTIFF, ``II`` or ``MM``
byte order, strips or tiles, chunky or planar samples, FillOrder 1 or 2,
Orientation 1-8; compression 1, 5 (LZW, native), 8 and 32946 (Deflate,
through ``zlib``), 32773 (PackBits, native), 7 (JPEG, native: below) or
2, 3 and 4 (CCITT Modified Huffman, T.4 one- and two-dimensional with or
without fill bits, T.6; native, 1-bit rows filled 1 for black as
libtiff's decoder fills them); predictor 1, 2 (8-64 bit integers and
floats) or 3 (floats); 8-, 16-, 32- and 64-bit unsigned or signed integer
and 32- and 64-bit float samples, packed 10-, 12- and 14-bit samples
(signed ones as ``min(v << (16 - bits), 32767)`` in int16, cv2's
saturation); photometric MinIsWhite (0) and MinIsBlack (1) with 1 to 4
samples (with 3 or 4: the first sample on the RGBA route, cv2's gray of
the first three, taken as RGB, on the direct one) or 1-bit (0 or 255;
2- and 4-bit gray give None, as cv2), RGB (2) with 1, 3 or 4, palette
(3) of 1-, 4- or 8-bit indices (8-bit with alpha too; an 8-bit one
without its ColorMap reads as gray, 1- and 4-bit ones give None, as
cv2), CMYK (5, InkSet 1) of 4 8-bit samples, YCbCr (6) of 3 8-bit
chunky samples; a predictor only under LZW and Deflate, as libtiff.

YCbCr outside JPEG comes in units (a block of YCbCrSubSampling Y, then
Cb and Cr; 1x1, 2x1, 2x2, 1x2, 4x1, 4x2 and 4x4 read, 1x4 and 2x4 give
None as libtiff refuses them), converted as libtiff's RGBA reader does:
chroma repeated over its block, ``TIFFYCbCrtoRGB``'s integer tables from
YCbCrCoefficients and ReferenceBlackWhite (rationals as
single-precision floats; defaults 0.299/0.587/0.114 and 0, 255, 128,
255, 128, 255); YCbCrPositioning is not used.  JPEG chunks decode as
libtiff has libjpeg decode them for ``TIFFReadRGBA*``: the JPEGTables
stream's segments spliced after each chunk's SOI, then libjpeg-turbo's
islow IDCT, fancy upsampling and ``jdcolor`` tables
(``native.jpeg_decode_tiff_chunks``): photometric YCbCr converted to RGB
whatever JFIF, Adobe or the component IDs say, RGB as stored, gray as
one component; a tile at its full size, the last strip at its own rows;
YCbCr sampling 1x1, 2x1 or 2x2, taken from the first chunk where the
YCbCrSubSampling tag is missing (libtiff's JPEGFixupTags); FillOrder is
ignored, as libtiff's JPEG codec ignores it.  A chunk sampled otherwise
than the tags say, or with another component count, gives None (libtiff
refuses it, and cv2 gives None).

Refused before any decode, by a ValueError naming the tag and its value
(nothing falls back to another codec): old-style JPEG (6), JPEG 2000,
LZMA, ZSTD, WebP, JPEG XL and other compressions; JPEG chunks of other
than 8-bit gray, RGB or YCbCr chunky samples (CMYK among them); CCITT of
other than one 1-bit sample, T4Options or T6Options uncompressed mode;
CIELab, ICCLab, ITULab and other photometrics; YCbCr of other than 3
8-bit chunky samples, other subsamplings, a predictor on subsampled
units, strips of a row count that is not a multiple of the unit, tiles
not a multiple of it, 4x4 units in tiles of an image whose sides are not
multiples of 4 (libtiff writes wrong pixels there); sub-byte gray with
more than one sample, gray of 3-4 samples wider than 16 bits, 2-bit and
16-bit palettes, a missing ColorMap on other than one unsigned sample,
16-bit floats, CMYK other than 4 8-bit samples, more than 4 samples;
mixed BitsPerSample or SampleFormat; signed packed samples of more than
one sample; predictor 2 on packed samples, predictor 3 on integers;
FillOrder 2 on uncompressed tiles (cv2 gives None or not by the tile
size).  Raised while decoding, naming the chunk: a JPEG chunk libjpeg
would stop on or that is progressive, lossless, arithmetic or 12-bit,
or whose frame is not the chunk's size; a CCITT chunk libtiff would read
only by concealing an error (a bad code, a row of the wrong length, a
missing EOL, data that end inside a row).

``imwrite`` makes OpenCV's choices: LZW with predictor 2 for uint8 and
uint16, no compression for float32 and float64, strips of about 8 KiB,
RGB in the file from a BGR array; so files the port writes match what
users get from the JAX package.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np

from .. import native

__all__ = ["IMREAD_UNCHANGED", "IMREAD_COLOR", "imread", "imwrite"]

# cv2's flag values
IMREAD_UNCHANGED = -1
IMREAD_COLOR = 1

_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_FILL_ORDER, _STRIP_OFFSETS, _ORIENTATION, _SPP = 266, 273, 274, 277
_ROWS_PER_STRIP, _STRIP_COUNTS, _PLANAR, _PREDICTOR = 278, 279, 284, 317
_COLORMAP, _TILE_WIDTH, _TILE_LENGTH, _TILE_OFFSETS = 320, 322, 323, 324
_TILE_COUNTS, _INKSET, _EXTRA_SAMPLES, _SAMPLE_FORMAT = 325, 332, 338, 339
_T4_OPTIONS, _T6_OPTIONS, _JPEG_TABLES = 292, 293, 347
_YCBCR_COEFFICIENTS, _YCBCR_SUBSAMPLING, _REFERENCE_BW = 529, 530, 532

_TAG_NAMES = {
    _BITS: "BitsPerSample", _COMPRESSION: "Compression",
    _PHOTOMETRIC: "PhotometricInterpretation", _FILL_ORDER: "FillOrder",
    _ORIENTATION: "Orientation", _SPP: "SamplesPerPixel",
    _PLANAR: "PlanarConfiguration", _PREDICTOR: "Predictor",
    _COLORMAP: "ColorMap", _INKSET: "InkSet",
    _EXTRA_SAMPLES: "ExtraSamples", _SAMPLE_FORMAT: "SampleFormat",
    _T4_OPTIONS: "T4Options", _T6_OPTIONS: "T6Options",
    _YCBCR_COEFFICIENTS: "YCbCrCoefficients",
    _YCBCR_SUBSAMPLING: "YCbCrSubSampling",
    _REFERENCE_BW: "ReferenceBlackWhite", _ROWS_PER_STRIP: "RowsPerStrip",
    _TILE_WIDTH: "TileWidth",
}
# TIFF field type -> NumPy code (the byte order is added per file)
_TYPES = {1: "u1", 2: "u1", 3: "u2", 4: "u4", 6: "i1", 7: "u1", 8: "i2",
          9: "i4", 11: "f4", 12: "f8", 13: "u4", 16: "u8", 17: "i8",
          18: "u8"}
_COMPRESSIONS = (1, 2, 3, 4, 5, 7, 8, 32773, 32946)
_CCITT = (2, 3, 4)
# YCbCrSubSampling libtiff's RGBA reader converts (uncompressed units);
# (1, 4) and (2, 4) it refuses (cv2 gives None); JPEG: libjpeg's fancy
# upsampling as jpeg.cpp reads it
_YCBCR_UNITS = ((1, 1), (2, 1), (2, 2), (1, 2), (4, 1), (4, 2), (4, 4))
_YCBCR_NONE = ((1, 4), (2, 4))
_YCBCR_JPEG = ((1, 1), (2, 1), (2, 2))
_REVERSED_BITS = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                          np.uint8)


class _Ifd:
    """The numeric tags of one IFD, read from the file image (``big``: a
    BigTIFF IFD, 8-byte counts and offsets)."""

    def __init__(self, data: np.ndarray, order: str, offset: int,
                 big: bool = False):
        self.order = order
        self.tags: Dict[int, np.ndarray] = {}
        head, entry, inline = (8, 20, 8) if big else (2, 12, 4)
        if offset + head > data.size:
            raise ValueError(f"IFD offset {offset} lies outside the file")
        (n,) = struct.unpack_from(order + ("Q" if big else "H"), data,
                                  offset)
        if offset + head + entry * n > data.size:
            raise ValueError("the IFD runs past the end of the file")
        for k in range(n):
            tag, typ, count, value = struct.unpack_from(
                order + ("HHQ8s" if big else "HHI4s"), data,
                offset + head + entry * k)
            rational = typ in (5, 10)
            code = ("u4" if typ == 5 else "i4") if rational else \
                _TYPES.get(typ)
            if code is None:
                continue
            size = np.dtype(code).itemsize * count * (2 if rational else 1)
            if size <= inline:
                raw = np.frombuffer(value, np.uint8, size)
            else:
                (at,) = struct.unpack(order + ("Q" if big else "I"), value)
                if at + size > data.size:
                    raise ValueError(f"tag {tag}'s values lie outside the "
                                     "file")
                raw = data[at:at + size]
            values = raw.view(order + code)
            if rational:  # as libtiff reads them: float num / float den
                num, den = (values[0::2].astype(np.float32),
                            values[1::2].astype(np.float32))
                self.tags[tag] = np.divide(num, den, out=np.zeros_like(num),
                                           where=den != 0)
            else:
                self.tags[tag] = values.astype(np.int64)

    def get(self, tag: int, default=None):
        v = self.tags.get(tag)
        return default if v is None else v

    def one(self, tag: int, default: Optional[int] = None) -> int:
        v = self.tags.get(tag)
        if v is None:
            if default is None:
                raise ValueError(f"required tag {tag} is missing")
            return default
        return int(v[0])


def _unsupported(tag: int, value) -> ValueError:
    return ValueError(f"unsupported TIFF: {_TAG_NAMES.get(tag, tag)}="
                      f"{value}")


class _Layout(NamedTuple):
    height: int
    width: int
    spp: int
    bits: int             # per sample as stored
    code: str             # NumPy code of a sample once unpacked
    compression: int
    predictor: int
    photometric: int
    planar: bool
    fill_order: int
    orientation: int
    unassociated: bool    # the 4th sample is unassociated alpha
    colormap: Optional[np.ndarray]   # (3, 2 ** bits) for a palette
    ycbcr: Optional[Tuple[int, int]] = None  # YCbCrSubSampling (YCbCr)
    t4: int = 0           # T4Options (compression 3)

    @property
    def packed(self) -> bool:
        return self.bits % 8 != 0


def _same(ifd: _Ifd, tag: int, default: int) -> int:
    values = ifd.get(tag, np.array([default])).tolist()
    if len(set(values)) != 1:
        raise _unsupported(tag, values)
    return int(values[0])


def _sample_code(bits: int, fmt: int, photometric: int) -> str:
    """The NumPy code a sample unpacks to; raises for what is refused."""
    if fmt not in (1, 2, 3):
        raise _unsupported(_SAMPLE_FORMAT, fmt)
    if photometric == 3:
        if bits not in (1, 4, 8) or fmt == 3:
            raise _unsupported(_BITS, f"{bits} with "
                               "PhotometricInterpretation=3")
        return "i1" if bits == 8 and fmt == 2 else "u1"
    if fmt == 3:
        if bits not in (32, 64):
            raise _unsupported(_BITS, f"{bits} with SampleFormat=3")
        return f"f{bits // 8}"
    if bits in (8, 16, 32, 64):
        return f"{'ui'[fmt - 1]}{bits // 8}"
    if bits in (10, 12, 14):
        return "iu"[fmt == 1] + "2"
    if bits in (1, 2, 4) and fmt == 1 and photometric in (0, 1):
        return "u1"
    raise _unsupported(_BITS, bits if fmt == 1 else
                       f"{bits} with SampleFormat={fmt}")


def _layout(ifd: _Ifd) -> _Layout:
    """Validate the tags: the one place that says which layouts are
    read.  Raises a ValueError naming the tag and value of anything
    refused."""
    width, height = ifd.one(_WIDTH), ifd.one(_LENGTH)
    if width < 1 or height < 1:
        raise ValueError(f"unsupported TIFF: an image of {width} x {height}")
    compression = ifd.one(_COMPRESSION, 1)
    if compression not in _COMPRESSIONS:
        raise _unsupported(_COMPRESSION, compression)
    photometric = ifd.one(_PHOTOMETRIC)
    if photometric not in (0, 1, 2, 3, 5, 6):
        raise _unsupported(_PHOTOMETRIC, photometric)
    spp = ifd.one(_SPP, 1)
    if not 1 <= spp <= 4:
        raise _unsupported(_SPP, spp)
    bits = _same(ifd, _BITS, 1)
    fmt = _same(ifd, _SAMPLE_FORMAT, 1)
    code = _sample_code(bits, fmt, photometric)
    if photometric == 3 and _COLORMAP not in ifd.tags and bits == 8 and \
            fmt == 1 and spp == 1:
        photometric = 1   # cv2 reads it as gray
    gray_wide = photometric in (0, 1) and spp > 2
    if (gray_wide and code not in ("u1", "u2")) or \
            (photometric in (0, 1) and bits < 8 and spp > 1) or \
            (photometric == 3 and spp > (2 if bits == 8 else 1)):
        raise _unsupported(_SPP, f"{spp} with PhotometricInterpretation="
                           f"{photometric} and {bits}-bit samples")
    if code[0] == "i" and bits % 8 and spp > 1:
        raise _unsupported(_BITS, f"{bits} with SampleFormat=2 and "
                           f"SamplesPerPixel={spp}")
    planar = ifd.one(_PLANAR, 1)
    if compression in _CCITT and (bits != 1 or spp != 1):
        raise _unsupported(_COMPRESSION, f"{compression} with {spp} "
                           f"samples of {bits} bits")
    t4 = ifd.one(_T4_OPTIONS, 0) if compression == 3 else 0
    if t4 & 2:
        raise _unsupported(_T4_OPTIONS, f"{t4} (uncompressed mode)")
    if compression == 4 and ifd.one(_T6_OPTIONS, 0) & 2:
        raise _unsupported(_T6_OPTIONS, f"{ifd.one(_T6_OPTIONS)} "
                           "(uncompressed mode)")
    if compression == 7 and (bits != 8 or fmt != 1 or planar != 1 or (
            spp, photometric) not in ((1, 0), (1, 1), (3, 2), (3, 6))):
        raise _unsupported(_COMPRESSION, f"7 with {spp} {bits}-bit samples"
                           f", PhotometricInterpretation={photometric}, "
                           f"PlanarConfiguration={planar}")
    ycbcr = _ycbcr_layout(ifd, compression, spp, bits, fmt, planar) \
        if photometric == 6 else None
    if photometric == 5 and (spp != 4 or bits != 8 or
                             ifd.one(_INKSET, 1) != 1):
        raise _unsupported(_PHOTOMETRIC, f"5 with SamplesPerPixel={spp}, "
                           f"BitsPerSample={bits}, InkSet="
                           f"{ifd.one(_INKSET, 1)}")
    # libtiff applies a predictor only under LZW and Deflate
    predictor = ifd.one(_PREDICTOR, 1) if compression in (5, 8, 32946) \
        else 1
    if predictor not in (1, 2, 3) or (predictor == 2 and bits % 8) or \
            (predictor == 3 and fmt != 3):
        raise _unsupported(_PREDICTOR, f"{predictor} with {bits}-bit "
                           f"SampleFormat={fmt} samples")
    if predictor != 1 and ycbcr not in (None, (1, 1)):
        raise _unsupported(_PREDICTOR, f"{predictor} with "
                           f"YCbCrSubSampling={list(ycbcr)}")
    if planar not in (1, 2):
        raise _unsupported(_PLANAR, planar)
    fill_order = ifd.one(_FILL_ORDER, 1)
    if fill_order not in (1, 2):
        raise _unsupported(_FILL_ORDER, fill_order)
    if fill_order == 2 and compression == 1 and _TILE_WIDTH in ifd.tags:
        # cv2 gives None for these under libtiff's RGBA reader, or not,
        # by the tile's size
        raise _unsupported(_FILL_ORDER, "2 with uncompressed tiles")
    orientation = ifd.one(_ORIENTATION, 1)
    if not 1 <= orientation <= 8:
        raise _unsupported(_ORIENTATION, orientation)
    extra = ifd.get(_EXTRA_SAMPLES, np.array([], np.int64)).tolist()
    if len(extra) > spp or any(e not in (0, 1, 2) for e in extra):
        raise _unsupported(_EXTRA_SAMPLES, extra)
    colormap = None
    if photometric == 3:
        colormap = ifd.get(_COLORMAP)
        if colormap is None and (bits == 8 or code != "u1" or spp != 1):
            raise _unsupported(_COLORMAP, f"missing, with {spp} {bits}-bit "
                               f"SampleFormat={fmt} samples")
        if colormap is not None:  # missing: cv2 gives None (1-, 4-bit)
            if colormap.size != 3 << bits:
                raise _unsupported(_COLORMAP, f"of {colormap.size} entries")
            colormap = colormap.reshape(3, 1 << bits)
    if ycbcr is not None and compression != 7:
        _check_unit_chunks(ifd, ycbcr, height, width)
    return _Layout(height, width, spp, bits, code, compression, predictor,
                   photometric, planar == 2 and spp > 1, fill_order,
                   orientation, spp == 4 and bool(extra) and extra[0] == 2,
                   colormap, ycbcr, t4)


def _ycbcr_layout(ifd: _Ifd, compression: int, spp: int, bits: int,
                  fmt: int, planar: int) -> Tuple[int, int]:
    """YCbCr's YCbCrSubSampling (libtiff's default 2 x 2; under JPEG
    without the tag, the first chunk's, which ``_decode_jpeg`` reads: (0,
    0) here), after the checks of what is read."""
    if spp != 3 or bits != 8 or fmt != 1 or planar != 1:
        raise _unsupported(_PHOTOMETRIC, f"6 with {spp} {bits}-bit "
                           f"SampleFormat={fmt} samples, "
                           f"PlanarConfiguration={planar}")
    given = _YCBCR_SUBSAMPLING in ifd.tags
    sub = tuple(ifd.get(_YCBCR_SUBSAMPLING, np.array([2, 2])).tolist())
    if len(sub) != 2 or sub not in (
            _YCBCR_JPEG if compression == 7 else _YCBCR_UNITS + _YCBCR_NONE):
        raise _unsupported(_YCBCR_SUBSAMPLING, list(sub))
    if compression != 7:
        luma = ifd.get(_YCBCR_COEFFICIENTS)
        ref = ifd.get(_REFERENCE_BW)
        if luma is not None and (luma.size != 3 or not np.all(
                np.isfinite(luma)) or luma[1] == 0):
            raise _unsupported(_YCBCR_COEFFICIENTS, luma.tolist())
        if ref is not None and (ref.size != 6 or not np.all(
                np.isfinite(ref))):
            raise _unsupported(_REFERENCE_BW, ref.tolist())
    return sub if given or compression != 7 else (0, 0)


def _check_unit_chunks(ifd: _Ifd, sub: Tuple[int, int], height: int,
                       width: int) -> None:
    """Chunks of whole subsampling units (strips of a multiple of vs
    rows, tiles a multiple of the unit), and libtiff's 4 x 4 tile
    routine only where it is right: images a multiple of 4 each way."""
    hs, vs = sub
    if _TILE_WIDTH in ifd.tags:
        tw, th = ifd.one(_TILE_WIDTH), ifd.one(_TILE_LENGTH)
        if tw % hs or th % vs:
            raise _unsupported(_TILE_WIDTH, f"{tw} x {th} with "
                               f"YCbCrSubSampling={list(sub)}")
        if sub == (4, 4) and (height % 4 or width % 4):
            raise _unsupported(_YCBCR_SUBSAMPLING, f"[4, 4] in tiles of an "
                               f"image of {width} x {height}")
    else:
        rps = min(ifd.one(_ROWS_PER_STRIP, 2 ** 32 - 1), height)
        if rps % vs and rps < height:
            raise _unsupported(_ROWS_PER_STRIP, f"{rps} with "
                               f"YCbCrSubSampling={list(sub)}")


def _rgba_route(lay: _Layout, flags: int) -> bool:
    """True where OpenCV reads through libtiff's RGBA reader: 8-bit
    results."""
    return flags == IMREAD_COLOR or lay.bits in (1, 2, 4, 8) or \
        (lay.bits == 16 and lay.spp == 2)


def _channels(lay: _Layout, flags: int) -> int:
    """The channels cv2 returns."""
    if flags == IMREAD_COLOR:
        return 3
    if lay.photometric == 3:
        return 1 if lay.bits == 1 else 3
    if lay.photometric == 5:
        return 4
    return lay.spp if lay.photometric in (2, 6) and lay.spp > 2 else 1


def _cv2_gives_none(lay: _Layout, flags: int) -> bool:
    """The layouts cv2 reads to None under ``flags`` (module docstring)."""
    if lay.orientation >= 5 and lay.height != lay.width:
        return True
    if (lay.photometric in (0, 1) and lay.bits in (2, 4)) or \
            (lay.photometric == 3 and lay.colormap is None) or \
            (lay.compression != 7 and lay.ycbcr in _YCBCR_NONE):
        return True
    if lay.spp == 2 and (lay.photometric == 2 or lay.bits not in (8, 16)):
        return True
    if _rgba_route(lay, flags):
        return lay.bits in (10, 12, 14, 32, 64) or \
            (lay.photometric == 2 and lay.spp == 1)
    return False


class _Chunks(NamedTuple):
    """A file's chunks (strips or tiles) in file order, every plane's
    after the one before when planar."""
    offsets: np.ndarray   # in the file
    counts: np.ndarray    # bytes in the file
    sizes: np.ndarray     # decoded bytes
    heights: np.ndarray   # rows each holds: a tile's all, a strip's own
    rows: int             # a tile's rows, RowsPerStrip
    cols: int             # a tile's columns, the width
    tiled: bool


def _chunks(ifd: _Ifd, lay: _Layout) -> _Chunks:
    """The chunks of ``lay`` (see ``_Chunks``)."""
    planes = lay.spp if lay.planar else 1
    across = lay.spp // planes
    hs, vs = lay.ycbcr if lay.ycbcr and lay.compression != 7 else (1, 1)

    def chunk_bytes(rows, cols):
        """Subsampled YCbCr: units of hs x vs Y samples, Cb and Cr."""
        if (hs, vs) != (1, 1):
            return -(-rows // vs) * -(-cols // hs) * (hs * vs + 2)
        return rows * -(-cols * across * lay.bits // 8)
    if _TILE_WIDTH in ifd.tags:
        tw, th = ifd.one(_TILE_WIDTH), ifd.one(_TILE_LENGTH)
        if tw < 1 or th < 1:
            raise ValueError(f"unsupported TIFF: tiles of {tw} x {th}")
        offsets, counts = ifd.get(_TILE_OFFSETS), ifd.get(_TILE_COUNTS)
        n = -(-lay.height // th) * -(-lay.width // tw) * planes
        sizes = np.full(n, chunk_bytes(th, tw), np.int64)
        heights = np.full(n, th, np.int64)
        rows, cols, tiled = th, tw, True
    else:
        rps = min(ifd.one(_ROWS_PER_STRIP, 2 ** 32 - 1), lay.height)
        if rps < 1:
            raise ValueError(f"unsupported TIFF: RowsPerStrip={rps}")
        offsets, counts = ifd.get(_STRIP_OFFSETS), ifd.get(_STRIP_COUNTS)
        per_plane = -(-lay.height // rps)
        strip_rows = np.minimum(rps, lay.height - rps * np.arange(per_plane))
        sizes = np.tile(chunk_bytes(strip_rows, lay.width), planes)
        heights = np.tile(strip_rows, planes)
        n = sizes.size
        rows, cols, tiled = rps, lay.width, False
    if offsets is None or counts is None or len(offsets) != n or \
            len(counts) != n:
        raise ValueError(f"expected {n} chunk offsets and byte counts")
    return _Chunks(offsets, counts, sizes, heights, rows, cols, tiled)


def _unpack(buf: np.ndarray, n_rows: int, samples: int,
            bits: int) -> np.ndarray:
    """(n_rows, samples) values of ``bits`` bits packed MSB first, each
    row padded to a byte."""
    rows = buf.reshape(n_rows, -1)
    flat = np.unpackbits(rows, axis=1)[:, :samples * bits]
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint16)
    return (flat.reshape(n_rows, samples, bits) @ weights).astype(
        np.uint16 if bits > 8 else np.uint8)


def _sof_sampling(chunk: np.ndarray) -> Tuple[int, int]:
    """The first component's sampling factors in a JPEG chunk's frame
    header, found as libtiff's JPEGFixupTagsSubsampling finds them: the
    marker segments from SOI to the first SOFn."""
    raw = chunk.tobytes()
    at = 2
    while raw[:2] == b"\xff\xd8" and at + 4 <= len(raw):
        if raw[at] != 0xFF:
            break
        m = raw[at + 1]
        if m == 0xFF:
            at += 1
            continue
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            if at + 12 <= len(raw):
                return raw[at + 11] >> 4, raw[at + 11] & 15
            break
        at += 2 + struct.unpack(">H", raw[at + 2:at + 4])[0]
    raise ValueError("JPEG chunk 0: no frame header for the "
                     "YCbCrSubSampling the file leaves out")


_JPEG_REASONS = {-1: "corrupt JPEG data", -4: "a JPEG mode it does not read "
                 "(progressive, lossless, arithmetic, 12-bit, or one "
                 "component a scan)", -9: "lies outside the file"}


def _decode_jpeg(data: np.ndarray, ifd: _Ifd, lay: _Layout, ch: _Chunks,
                 dst_offsets: np.ndarray) -> Optional[np.ndarray]:
    """JPEG chunks (compression 7) decoded as libtiff has libjpeg decode
    them for TIFFReadRGBA*: (chunks' rows, cols, 3) RGB, or 1 sample of
    gray; None where libtiff refuses a chunk's sampling or component
    count (cv2 gives None)."""
    offsets, counts, heights = ch.offsets, ch.counts, ch.heights
    buf = np.empty(int(ch.sizes.sum()), np.uint8)
    tables = ifd.get(_JPEG_TABLES, np.array([], np.int64)).astype(
        np.uint8).tobytes()
    form = "gray" if lay.spp == 1 else "ycc" if lay.photometric == 6 else \
        "stored"
    sampling = lay.ycbcr or (1, 1)
    if sampling == (0, 0) and offsets.size:
        at, n = int(offsets[0]), int(counts[0])
        sampling = _sof_sampling(data[at:at + n])
    rcs = native.jpeg_decode_tiff_chunks(tables, data, offsets, counts, buf,
                                         dst_offsets, heights, ch.cols, form,
                                         sampling)
    if np.any((rcs == -8) | (rcs == -3)):
        return None
    bad = np.flatnonzero(rcs)
    if bad.size:
        k = int(bad[0])
        raise ValueError(
            f"JPEG chunk {k}: " + (
                f"its frame is not {int(heights[k])} x {ch.cols}"
                if rcs[k] == -2 else _JPEG_REASONS.get(int(rcs[k]),
                                                       f"code {rcs[k]}")))
    return buf


def _ycbcr_tables(ifd: _Ifd) -> Tuple[np.ndarray, ...]:
    """libtiff's TIFFYCbCrToRGB tables (tif_color.c: 16 fractional bits,
    single-precision floats) from YCbCrCoefficients and
    ReferenceBlackWhite: Y, Cr -> R, Cb -> B, Cb -> G, Cr -> G."""
    luma = ifd.get(_YCBCR_COEFFICIENTS, np.array([0.299, 0.587, 0.114],
                                                 np.float32))
    ref = ifd.get(_REFERENCE_BW, np.array([0, 255, 128, 255, 128, 255],
                                          np.float32))
    lr, lg, lb = (np.float32(v) for v in luma)
    ref = [np.float32(v) for v in ref]

    def fix(x) -> int:
        return int(np.float64(np.clip(x, np.float32(0), np.float32(2)))
                   * 65536 + 0.5)
    f1 = np.float32(2) - np.float32(2) * lr
    f3 = np.float32(2) - np.float32(2) * lb
    d1, d2 = fix(f1), -fix(lr * f1 / lg)
    d3, d4 = fix(f3), -fix(lb * f3 / lg)
    x = np.arange(256) - 128

    def code2v(c, black, white, scale):
        span = np.float32(white - black) or np.float32(1)
        v = (c - int(black)).astype(np.float32) * np.float32(scale) / span
        return np.clip(v, -128 * 32, 128 * 32).astype(np.int64)
    cr = code2v(x, ref[4] - np.float32(128), ref[5] - np.float32(128), 127)
    cb = code2v(x, ref[2] - np.float32(128), ref[3] - np.float32(128), 127)
    return (code2v(x + 128, ref[0], ref[1], 255), (d1 * cr + 32768) >> 16,
            (d3 * cb + 32768) >> 16, d4 * cb + 32768, d2 * cr)


def _ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                  ifd: _Ifd) -> np.ndarray:
    """TIFFYCbCrtoRGB on uint8 samples: ``y`` (rows, cols), ``cb`` and
    ``cr`` one a block of hs x vs Y (rows / vs, cols / hs), each repeated
    over its block as libtiff's RGBA reader does; (rows, cols, 3) RGB
    uint8."""
    y_tab, cr_r, cb_b, cb_g, cr_g = _ycbcr_tables(ifd)
    vs, hs = y.shape[0] // cb.shape[0], y.shape[1] // cb.shape[1]
    # every sum below lies within +-16384: int16 halves the traffic
    luma = y_tab.astype(np.int16)[y]
    out = np.empty(y.shape + (3,), np.uint8)
    for k, term in enumerate((cr_r[cr], (cb_g[cb] + cr_g[cr]) >> 16,
                              cb_b[cb])):
        term = term.astype(np.int16)
        if (vs, hs) != (1, 1):
            term = np.repeat(np.repeat(term, vs, axis=0), hs, axis=1)
        channel = luma + term
        np.clip(channel, 0, 255, out=channel)
        out[..., k] = channel
    return out


def _units_to_rgb(buf: np.ndarray, lay: _Layout, crows: int, ccols: int,
                  tiled: bool, ifd: _Ifd) -> np.ndarray:
    """Subsampled YCbCr units (a block of hs x vs Y, then Cb and Cr) as
    (rows, cols, 3) RGB, as libtiff's RGBA reader converts them: strips
    joined, or tiles each (crows, ccols) in file order, stacked down."""
    hs, vs = lay.ycbcr
    unit = hs * vs + 2
    if tiled:
        urows, ucols = crows // vs, ccols // hs
        n = buf.size // (urows * ucols * unit)
    else:
        n, urows, ucols = 1, -(-lay.height // vs), -(-lay.width // hs)
    u = buf.reshape(n * urows, ucols, unit)
    y = u[..., :hs * vs].reshape(n * urows, ucols, vs, hs).transpose(
        0, 2, 1, 3).reshape(n * urows * vs, ucols * hs)
    return _ycbcr_to_rgb(y, u[..., hs * vs], u[..., hs * vs + 1], ifd)


def _decode(data: np.ndarray, ifd: _Ifd, lay: _Layout
            ) -> Tuple[Optional[np.ndarray], Optional[Tuple[int, int]]]:
    """The samples, in the host's byte order, file channel order (a view
    where it can be): (H, W, spp) from strips, or the whole tiles, cut to
    (H, W) by the caller, and the tile shape (None for strips).  JPEG
    chunks come out as libjpeg gives them (YCbCr as RGB), subsampled YCbCr
    units as RGB; None where cv2 gives None."""
    height, width, spp = lay.height, lay.width, lay.spp
    ch = _chunks(ifd, lay)
    offsets, counts, sizes = ch.offsets, ch.counts, ch.sizes
    crows, ccols, tiled = ch.rows, ch.cols, ch.tiled
    # libtiff reverses the bits before decoding (its JPEG codec: never)
    if lay.fill_order == 2 and lay.compression != 7:
        data = _REVERSED_BITS[data]
    dst_offsets = np.zeros_like(sizes)
    np.cumsum(sizes[:-1], out=dst_offsets[1:])
    total = int(sizes.sum())
    compression = lay.compression
    if compression == 7:
        buf = _decode_jpeg(data, ifd, lay, ch, dst_offsets)
        if buf is None:
            return None, None
        compression = None
    elif compression == 1 and np.all(offsets == offsets[0] + dst_offsets) \
            and np.all(counts >= sizes) and offsets[0] + total <= data.size:
        # uncompressed chunks back to back in the file: no copy
        buf = data[int(offsets[0]):int(offsets[0]) + total]
        compression = None
    else:
        buf = np.empty(total, np.uint8)
    if compression in _CCITT:
        native.ccitt_decode_chunks(data, offsets, counts, buf, dst_offsets,
                                   sizes, ch.heights, ccols, compression,
                                   lay.t4)
    elif compression in (5, 32773):
        decode = native.lzw_decode_chunks if compression == 5 else \
            native.packbits_decode_chunks
        got = decode(data, offsets, counts, buf, dst_offsets, sizes)
        short = np.flatnonzero(got != sizes)
        if short.size:
            k = int(short[0])
            raise ValueError(f"{'LZW' if compression == 5 else 'PackBits'}"
                             f" chunk {k} decodes to {int(got[k])} bytes,"
                             f" expected {int(sizes[k])}")
    elif compression is not None:
        for k, (at, count, dst, want) in enumerate(zip(
                offsets.tolist(), counts.tolist(), dst_offsets.tolist(),
                sizes.tolist())):
            raw = data[at:at + count]
            if compression != 1:
                raw = np.frombuffer(zlib.decompress(raw), np.uint8)
            if raw.size < want or (compression != 1 and raw.size != want):
                raise ValueError(f"chunk {k} holds {raw.size} bytes, "
                                 f"expected {want}")
            buf[dst:dst + want] = raw[:want]
    if lay.ycbcr and lay.ycbcr != (1, 1) and lay.compression != 7:
        px = _units_to_rgb(buf, lay, crows, ccols, tiled, ifd)
        if not tiled:
            return px[:height, :width], None
        down, right = -(-height // crows), -(-width // ccols)
        return px.reshape(down, right, crows, ccols, 3).transpose(
            0, 2, 1, 3, 4).reshape(down * crows, right * ccols, 3), \
            (crows, ccols)
    planes = spp if lay.planar else 1
    across = spp // planes
    n_rows = total // (-(-ccols * across * lay.bits // 8))
    if lay.packed:
        arr = _unpack(buf, n_rows, ccols * across, lay.bits)
    else:
        size = int(lay.code[1])
        swap = ifd.order == ">" and size > 1
        if lay.predictor != 1:
            if not buf.flags.writeable:
                buf = buf.copy()
            native.predictor_undo(buf, n_rows, ccols * across, across, size,
                                  lay.predictor, swap)
            swap = False
        arr = buf.view((">" if swap else "=") + lay.code)
        if swap:
            arr = arr.astype("=" + lay.code)
    if not tiled:
        return arr.reshape(planes, height, width, across).transpose(
            1, 2, 0, 3).reshape(height, width, spp), None
    down, right = -(-height // crows), -(-width // ccols)
    return arr.reshape(planes, down, right, crows, ccols, across).transpose(
        1, 3, 2, 4, 0, 5).reshape(down * crows, right * ccols, spp), \
        (crows, ccols)


def _gray_edge_tiles(tiles: np.ndarray, lay: _Layout, th: int, tw: int
                     ) -> np.ndarray:
    """The (H, W, spp) samples libtiff's RGBA reader takes from chunky
    gray and palette tiles: in the tiles cut by the right edge (w of tw
    columns), its gray and 8-bit palette routines step from one row to the
    next by the w pixels' bytes plus tw - w bytes (not pixels), so row r
    starts r * (w * spp * bytes + tw - w) bytes into the tile (exact for
    one 8-bit sample)."""
    px = tiles[:lay.height, :lay.width]
    x0 = lay.width // tw * tw
    w = lay.width - x0
    if w == 0:
        return px
    px = px.copy()
    size = px.dtype.itemsize * lay.spp
    stride = w * size + tw - w
    for y0 in range(0, lay.height, th):
        raw = np.ascontiguousarray(tiles[y0:y0 + th, x0:x0 + tw]).view(
            np.uint8).reshape(-1)
        rows = min(th, lay.height - y0)
        at = (np.arange(rows) * stride)[:, None] + np.arange(w * size)
        px[y0:y0 + rows, x0:] = raw[at].view(px.dtype).reshape(
            rows, w, lay.spp)
    return px


def _swap_red_blue(px: np.ndarray) -> np.ndarray:
    """RGB(A) <-> BGR(A) over the last axis, as a new C-contiguous array
    (``np.take`` copies it faster than fancy indexing)."""
    return np.take(px, [2, 1, 0, 3][:px.shape[2]], axis=2)


def _orient_direct(a: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's fixOrientationFull: the EXIF meaning of the tag."""
    if orientation == 1:
        return a
    if orientation >= 5:
        a = a.swapaxes(0, 1)
    axes = {2: (1,), 3: (0, 1), 4: (0,), 5: (), 6: (1,), 7: (0, 1),
            8: (0,)}[orientation]
    return np.ascontiguousarray(np.flip(a, axes) if axes else a)


def _orient_rgba(a: np.ndarray, orientation: int, chunk_cols: int
                 ) -> np.ndarray:
    """What libtiff's RGBA reader and OpenCV's fixOrientationPartial
    make of the Orientation: each chunk mirrored across its own width for
    2, 3, 6 and 7, the rows flipped for 3, 4, 7 and 8, both axes for 6
    and 8, then 5-8 transposed.  Returns a C-contiguous array."""
    if orientation in (2, 3, 6, 7) and chunk_cols >= a.shape[1]:
        a = a[:, ::-1]
    elif orientation in (2, 3, 6, 7):
        cols = np.arange(a.shape[1])
        start = cols // chunk_cols * chunk_cols
        last = np.minimum(start + chunk_cols, a.shape[1]) - 1
        a = a[:, start + last - cols]
    if orientation in (3, 4, 7, 8):
        a = a[::-1]
    if orientation in (6, 8):
        a = a[::-1, ::-1]
    if orientation >= 5:
        a = a.swapaxes(0, 1)
    return np.ascontiguousarray(a)


def _to_8bit(u: np.ndarray) -> np.ndarray:
    """libtiff's Bitdepth16To8: round(v / 257)."""
    return ((u.astype(np.uint32) + 128) // 257).astype(np.uint8)


def _read_rgba(px: np.ndarray, lay: _Layout, cn: int) -> np.ndarray:
    """libtiff's RGBA conversion of the samples, then OpenCV's to ``cn``
    channels (see the module docstring)."""
    u = px.view(px.dtype.str.replace("i", "u"))
    if lay.photometric in (0, 1):
        g = u[..., 0] if lay.bits == 8 else u[..., 0] * np.uint8(255) \
            if lay.bits == 1 else (u[..., 0] >> 8).astype(np.uint8)
        if lay.photometric == 0:
            g = 255 - g
        return g if cn == 1 else np.repeat(g[..., None], 3, axis=2)
    if lay.photometric == 3:
        cmap = lay.colormap
        if cmap.max() > 255:
            cmap = cmap >> 8
        rgb = cmap.T.astype(np.uint8)[u[..., 0]]
        if cn == 1:
            r, g, b = (rgb[..., k].astype(np.uint32) for k in range(3))
            return ((r * 4899 + g * 9617 + b * 1868 + 8192) >> 14).astype(
                np.uint8)
        return rgb[..., ::-1].copy()
    if lay.photometric == 5:
        k = 255 - u[..., 3:4].astype(np.uint32)
        bgr = (k * (255 - u[..., 2::-1].astype(np.uint32)) // 255).astype(
            np.uint8)
        if cn == 3:
            return bgr
        return np.concatenate([bgr, np.full_like(bgr[..., :1], 255)], axis=2)
    c = u if lay.bits == 8 else _to_8bit(u)
    if lay.unassociated:
        a = c[..., 3:4].astype(np.uint32)
        rgb = ((c[..., :3].astype(np.uint32) * a + 127) // 255).astype(
            np.uint8)
        c = np.concatenate([rgb, c[..., 3:4]], axis=2)
    return _swap_red_blue(c[..., :cn])


def _read_direct(px: np.ndarray, lay: _Layout, cn: int) -> np.ndarray:
    if lay.packed and lay.code[0] == "i":  # saturated into int16
        px = np.minimum(px.astype(np.int32) << (16 - lay.bits), 32767
                        ).astype(np.int16)
    elif lay.packed:
        px = px << (16 - lay.bits)
    if lay.photometric in (0, 1) and lay.spp > 2:
        # cv2 reads the first three samples as RGB and takes its gray
        r, g, b = (px[..., k].astype(np.int64) for k in range(3))
        return ((r * 4899 + g * 9617 + b * 1868 + 8192) >> 14).astype(
            px.dtype)
    return np.ascontiguousarray(px[..., 0]) if cn == 1 else \
        _swap_red_blue(px)


def imread(path: Union[str, Path], flags: int = IMREAD_COLOR
           ) -> Optional[np.ndarray]:
    """Read a TIFF as ``cv2.imread(path, flags)`` returns it (see the
    module docstring); None for a missing file, as cv2 gives."""
    if flags not in (IMREAD_UNCHANGED, IMREAD_COLOR):
        raise ValueError(f"flags={flags}: only IMREAD_UNCHANGED (-1) and "
                         "IMREAD_COLOR (1) are read")
    path = Path(path)
    if not path.is_file():
        return None
    data = np.fromfile(path, np.uint8)
    head = data[:16].tobytes()
    if head[:2] not in (b"II", b"MM"):
        raise ValueError(f"{path} is not a TIFF (byte order {head[:2]!r})")
    order = "<" if head[:2] == b"II" else ">"
    (version,) = struct.unpack(order + "H", head[2:4])
    if version == 42:
        (first,) = struct.unpack(order + "I", head[4:8])
    elif version == 43 and len(head) == 16 and \
            struct.unpack(order + "HH", head[4:8]) == (8, 0):
        (first,) = struct.unpack(order + "Q", head[8:16])
    else:
        raise ValueError(f"{path}: TIFF version {version} is not read "
                         "(42 is TIFF, 43 BigTIFF with 8-byte offsets)")
    ifd = _Ifd(data, order, first, big=version == 43)
    lay = _layout(ifd)
    if _cv2_gives_none(lay, flags):
        return None
    px, tile = _decode(data, ifd, lay)
    if px is None:
        return None
    if lay.photometric == 6:  # RGB from here on
        if lay.compression != 7 and lay.ycbcr == (1, 1):
            px = _ycbcr_to_rgb(px[..., 0], px[..., 1], px[..., 2], ifd)
        lay = lay._replace(photometric=2)
    cn = _channels(lay, flags)
    if not _rgba_route(lay, flags):
        px = px[:lay.height, :lay.width]
        return _orient_direct(_read_direct(px, lay, cn), lay.orientation)
    if tile is None:
        cols = lay.width
    elif lay.photometric in (0, 1, 3) and not lay.planar and \
            px.dtype.itemsize * lay.spp > 1:
        px, cols = _gray_edge_tiles(px, lay, *tile), tile[1]
    else:
        px, cols = px[:lay.height, :lay.width], tile[1]
    out = _read_rgba(px, lay, cn)
    if lay.code[0] == "i" and flags == IMREAD_UNCHANGED:
        out = out.view(np.int8)
    return _orient_rgba(out, lay.orientation, cols)


def _ifd_bytes(entries, start: int) -> Tuple[bytes, bytes]:
    """(the out-of-line values, the IFD) for ``entries`` of (tag, type
    code, values), the values placed from file offset ``start``."""
    extra = bytearray()
    ifd = bytearray(struct.pack("<H", len(entries)))
    for tag, typ, values in sorted(entries):
        fmt = {3: "H", 4: "I"}[typ]
        raw = struct.pack(f"<{len(values)}{fmt}", *values)
        if len(raw) <= 4:
            field = raw.ljust(4, b"\0")
        else:
            field = struct.pack("<I", start + len(extra))
            extra += raw + b"\0" * (len(raw) % 2)
        ifd += struct.pack("<HHI", tag, typ, len(values)) + field
    return bytes(extra), bytes(ifd + struct.pack("<I", 0))


def imwrite(path: Union[str, Path], arr: np.ndarray) -> None:
    """Write a 2-D or (H, W, 1|3|4) uint8, uint16, float32 or float64
    array as ``cv2.imwrite`` writes a ``.tif`` (see the module
    docstring)."""
    arr = src = np.asarray(arr)
    if arr.dtype not in (np.uint8, np.uint16, np.float32, np.float64):
        raise ValueError(f"imwrite: dtype {arr.dtype} is not written "
                         "(uint8, uint16, float32, float64)")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[2] not in (1, 3, 4) or 0 in arr.shape:
        raise ValueError(f"imwrite: shape {arr.shape} is not an image of "
                         "1, 3 or 4 channels")
    height, width, spp = arr.shape
    size = arr.dtype.itemsize
    if spp > 1:  # BGR(A) in memory, RGB(A) in the file
        arr = _swap_red_blue(arr)
    px = np.ascontiguousarray(arr, arr.dtype.newbyteorder("<"))
    row_bytes = width * spp * size
    rps = max(1, min(height, 8192 // row_bytes))
    n = -(-height // rps)
    sizes = np.minimum(rps, height - rps * np.arange(n)) * row_bytes
    starts = np.zeros(n, np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])
    flat = px.reshape(-1).view(np.uint8)
    lzw = px.dtype.kind == "u"
    if lzw:
        if np.may_share_memory(flat, src):  # differencing works in place
            flat = flat.copy()
        native.predictor_apply(flat, height, width * spp, spp, size)
        strips = native.lzw_encode_chunks(flat, starts, sizes)
        counts = [s.size for s in strips]
    else:
        strips = [flat]
        counts = sizes.tolist()
    offsets = (8 + np.concatenate(
        [[0], np.cumsum(counts[:-1], dtype=np.int64)])).tolist()
    end = 8 + sum(counts)
    pad = end % 2
    entries = [
        (_WIDTH, 4 if width > 65535 else 3, [width]),
        (_LENGTH, 4 if height > 65535 else 3, [height]),
        (_BITS, 3, [8 * size] * spp),
        (_COMPRESSION, 3, [5 if lzw else 1]),
        (_PHOTOMETRIC, 3, [1 if spp == 1 else 2]),
        (_STRIP_OFFSETS, 4, offsets),
        (_SPP, 3, [spp]),
        (_ROWS_PER_STRIP, 4 if rps > 65535 else 3, [rps]),
        (_STRIP_COUNTS, 4, counts),
        (_PLANAR, 3, [1]),
        (_SAMPLE_FORMAT, 3, [1 if lzw else 3] * spp),
    ]
    if lzw:
        entries.append((_PREDICTOR, 3, [2]))
    extra, ifd = _ifd_bytes(entries, end + pad)
    path = Path(path)
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", end + pad + len(extra)))
        for strip in strips:
            f.write(memoryview(strip))
        f.write(b"\0" * pad + extra + ifd)
