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
through ``zlib``) or 32773 (PackBits, native); predictor 1, 2 (8-64 bit
integers and floats) or 3 (floats); 8-, 16-, 32- and 64-bit unsigned or
signed integer and 32- and 64-bit float samples, packed 10-, 12- and
14-bit unsigned samples; photometric MinIsWhite (0) and MinIsBlack (1)
with 1 or 2 samples, RGB (2) with 1, 3 or 4, palette (3) of 1-, 4- or
8-bit indices (8-bit with alpha too), CMYK (5, InkSet 1) of 4 8-bit
samples; a predictor only under LZW and Deflate, as libtiff.  Refused before
any decode, by a ValueError naming the tag and its value (nothing falls
back to another codec): JPEG (6, 7), CCITT (2-4), LZMA, ZSTD, WebP, JPEG
XL and other compressions; YCbCr (6), CIELab and other photometrics;
bilevel and other sub-byte gray, 2-bit and 16-bit palettes, 16-bit
floats, CMYK other than 4 8-bit samples, gray with more than 2 samples,
more than 4 samples; mixed BitsPerSample or SampleFormat; signed packed
samples; predictor 2 on packed samples, predictor 3 on integers;
FillOrder 2 on uncompressed tiles (cv2 gives None or not by the tile
size).

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

_TAG_NAMES = {
    _BITS: "BitsPerSample", _COMPRESSION: "Compression",
    _PHOTOMETRIC: "PhotometricInterpretation", _FILL_ORDER: "FillOrder",
    _ORIENTATION: "Orientation", _SPP: "SamplesPerPixel",
    _PLANAR: "PlanarConfiguration", _PREDICTOR: "Predictor",
    _COLORMAP: "ColorMap", _INKSET: "InkSet",
    _EXTRA_SAMPLES: "ExtraSamples", _SAMPLE_FORMAT: "SampleFormat",
}
# TIFF field type -> NumPy code (the byte order is added per file)
_TYPES = {1: "u1", 2: "u1", 3: "u2", 4: "u4", 6: "i1", 7: "u1", 8: "i2",
          9: "i4", 11: "f4", 12: "f8", 13: "u4", 16: "u8", 17: "i8",
          18: "u8"}
_COMPRESSIONS = (1, 5, 8, 32773, 32946)
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
            code = _TYPES.get(typ)
            if code is None:  # rationals: no tag read here needs one
                continue
            size = np.dtype(code).itemsize * count
            if size <= inline:
                raw = np.frombuffer(value, np.uint8, size)
            else:
                (at,) = struct.unpack(order + ("Q" if big else "I"), value)
                if at + size > data.size:
                    raise ValueError(f"tag {tag}'s values lie outside the "
                                     "file")
                raw = data[at:at + size]
            self.tags[tag] = raw.view(order + code).astype(np.int64)

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
    if bits in (10, 12, 14) and fmt == 1:
        return "u2"
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
    if photometric not in (0, 1, 2, 3, 5):
        raise _unsupported(_PHOTOMETRIC, photometric)
    spp = ifd.one(_SPP, 1)
    if not 1 <= spp <= 4:
        raise _unsupported(_SPP, spp)
    bits = _same(ifd, _BITS, 1)
    fmt = _same(ifd, _SAMPLE_FORMAT, 1)
    code = _sample_code(bits, fmt, photometric)
    if (photometric in (0, 1) and spp > 2) or (photometric == 3 and
                                               spp > (2 if bits == 8 else 1)):
        raise _unsupported(_SPP, f"{spp} with PhotometricInterpretation="
                           f"{photometric}")
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
    planar = ifd.one(_PLANAR, 1)
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
        if colormap is None or colormap.size != 3 << bits:
            raise _unsupported(_COLORMAP, "missing" if colormap is None
                               else f"of {colormap.size} entries")
        colormap = colormap.reshape(3, 1 << bits)
    return _Layout(height, width, spp, bits, code, compression, predictor,
                   photometric, planar == 2 and spp > 1, fill_order,
                   orientation, spp == 4 and bool(extra) and extra[0] == 2,
                   colormap)


def _rgba_route(lay: _Layout, flags: int) -> bool:
    """True where OpenCV reads through libtiff's RGBA reader: 8-bit
    results."""
    return flags == IMREAD_COLOR or lay.bits in (1, 4, 8) or \
        (lay.bits == 16 and lay.spp == 2)


def _channels(lay: _Layout, flags: int) -> int:
    """The channels cv2 returns."""
    if flags == IMREAD_COLOR:
        return 3
    if lay.photometric == 3:
        return 1 if lay.bits == 1 else 3
    if lay.photometric == 5:
        return 4
    return lay.spp if lay.photometric == 2 and lay.spp > 2 else 1


def _cv2_gives_none(lay: _Layout, flags: int) -> bool:
    """The layouts cv2 reads to None under ``flags`` (module docstring)."""
    if lay.orientation >= 5 and lay.height != lay.width:
        return True
    if lay.spp == 2 and (lay.photometric == 2 or lay.bits not in (8, 16)):
        return True
    if _rgba_route(lay, flags):
        return lay.bits in (10, 12, 14, 32, 64) or \
            (lay.photometric == 2 and lay.spp == 1)
    return False


def _chunks(ifd: _Ifd, lay: _Layout):
    """(file offsets, byte counts, decoded sizes, chunk rows, chunk
    columns, tiled): chunks (strips or tiles) in file order, every plane's
    after the one before when planar."""
    planes = lay.spp if lay.planar else 1
    across = lay.spp // planes

    def row_bytes(cols):
        return -(-cols * across * lay.bits // 8)
    if _TILE_WIDTH in ifd.tags:
        tw, th = ifd.one(_TILE_WIDTH), ifd.one(_TILE_LENGTH)
        if tw < 1 or th < 1:
            raise ValueError(f"unsupported TIFF: tiles of {tw} x {th}")
        offsets, counts = ifd.get(_TILE_OFFSETS), ifd.get(_TILE_COUNTS)
        n = -(-lay.height // th) * -(-lay.width // tw) * planes
        sizes = np.full(n, th * row_bytes(tw), np.int64)
        rows, cols, tiled = th, tw, True
    else:
        rps = min(ifd.one(_ROWS_PER_STRIP, 2 ** 32 - 1), lay.height)
        if rps < 1:
            raise ValueError(f"unsupported TIFF: RowsPerStrip={rps}")
        offsets, counts = ifd.get(_STRIP_OFFSETS), ifd.get(_STRIP_COUNTS)
        per_plane = -(-lay.height // rps)
        strip_rows = np.minimum(rps, lay.height - rps * np.arange(per_plane))
        sizes = np.tile(strip_rows * row_bytes(lay.width), planes)
        n = sizes.size
        rows, cols, tiled = rps, lay.width, False
    if offsets is None or counts is None or len(offsets) != n or \
            len(counts) != n:
        raise ValueError(f"expected {n} chunk offsets and byte counts")
    return offsets, counts, sizes, rows, cols, tiled


def _unpack(buf: np.ndarray, n_rows: int, samples: int,
            bits: int) -> np.ndarray:
    """(n_rows, samples) values of ``bits`` bits packed MSB first, each
    row padded to a byte."""
    rows = buf.reshape(n_rows, -1)
    flat = np.unpackbits(rows, axis=1)[:, :samples * bits]
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint16)
    return (flat.reshape(n_rows, samples, bits) @ weights).astype(
        np.uint16 if bits > 8 else np.uint8)


def _decode(data: np.ndarray, ifd: _Ifd, lay: _Layout
            ) -> Tuple[np.ndarray, Optional[Tuple[int, int]]]:
    """The samples, in the host's byte order, file channel order (a view
    where it can be): (H, W, spp) from strips, or the whole tiles, cut to
    (H, W) by the caller, and the tile shape (None for strips)."""
    height, width, spp = lay.height, lay.width, lay.spp
    offsets, counts, sizes, crows, ccols, tiled = _chunks(ifd, lay)
    if lay.fill_order == 2:  # libtiff reverses the bits before decoding
        data = _REVERSED_BITS[data]
    dst_offsets = np.zeros_like(sizes)
    np.cumsum(sizes[:-1], out=dst_offsets[1:])
    total = int(sizes.sum())
    compression = lay.compression
    if compression == 1 and np.all(offsets == offsets[0] + dst_offsets) \
            and np.all(counts >= sizes) and offsets[0] + total <= data.size:
        # uncompressed chunks back to back in the file: no copy
        buf = data[int(offsets[0]):int(offsets[0]) + total]
        compression = None
    else:
        buf = np.empty(total, np.uint8)
    if compression in (5, 32773):
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
        g = u[..., 0] if lay.bits == 8 else (u[..., 0] >> 8).astype(np.uint8)
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
    if lay.packed:
        px = px << (16 - lay.bits)
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
