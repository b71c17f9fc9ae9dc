"""The port's TIFF reader and writer: the container around the native
codec (``native/tiff.cpp``).

``imread`` returns what ``cv2.imread`` returns for the TIFFs it reads, so
the port loads captures on machines without OpenCV exactly as the JAX
package loads them with it:

* ``IMREAD_UNCHANGED``: the samples as stored, BGR (BGRA) for 3 (4)
  samples, a 2-D array for one sample;
* ``IMREAD_COLOR``: three 8-bit channels: a gray image repeated, alpha
  dropped, 16-bit samples narrowed as OpenCV narrows them (``v >> 8`` for
  gray, ``round(v / 257)`` for RGB, through libtiff's RGBA reader), and
  ``None`` for 32- and 64-bit float samples, which OpenCV cannot convert.

It reads the first IFD of a classic TIFF: ``II`` or ``MM`` byte order,
strips or tiles, compression 1, 5 (LZW, native) or 8 (Deflate, through
``zlib``), predictor 1, 2 (8/16 bits) or 3 (floats), 8/16-bit unsigned or
32/64-bit IEEE float samples, 1, 3 or 4 samples, chunky planar
configuration.  Anything else raises a ValueError naming the tag and its
value; nothing falls back to another codec.

``imwrite`` makes OpenCV's choices: LZW with predictor 2 for uint8 and
uint16, no compression for float32 and float64, strips of about 8 KiB,
RGB in the file from a BGR array; so files the port writes match what
users get from the JAX package.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np

from .. import native

__all__ = ["IMREAD_UNCHANGED", "IMREAD_COLOR", "imread", "imwrite"]

# cv2's flag values
IMREAD_UNCHANGED = -1
IMREAD_COLOR = 1

_WIDTH, _LENGTH, _BITS, _COMPRESSION, _PHOTOMETRIC = 256, 257, 258, 259, 262
_FILL_ORDER, _STRIP_OFFSETS, _ORIENTATION, _SPP = 266, 273, 274, 277
_ROWS_PER_STRIP, _STRIP_COUNTS, _PLANAR, _PREDICTOR = 278, 279, 284, 317
_TILE_WIDTH, _TILE_LENGTH, _TILE_OFFSETS, _TILE_COUNTS = 322, 323, 324, 325
_EXTRA_SAMPLES, _SAMPLE_FORMAT = 338, 339

_TAG_NAMES = {
    _BITS: "BitsPerSample", _COMPRESSION: "Compression",
    _PHOTOMETRIC: "PhotometricInterpretation", _FILL_ORDER: "FillOrder",
    _ORIENTATION: "Orientation", _SPP: "SamplesPerPixel",
    _PLANAR: "PlanarConfiguration", _PREDICTOR: "Predictor",
    _EXTRA_SAMPLES: "ExtraSamples", _SAMPLE_FORMAT: "SampleFormat",
}
# TIFF field type -> NumPy code (the byte order is added per file)
_TYPES = {1: "u1", 2: "u1", 3: "u2", 4: "u4", 6: "i1", 7: "u1", 8: "i2",
          9: "i4", 11: "f4", 12: "f8", 16: "u8"}


class _Ifd:
    """The numeric tags of one IFD, read from the file image."""

    def __init__(self, data: np.ndarray, order: str, offset: int):
        self.order = order
        self.tags: Dict[int, np.ndarray] = {}
        if offset + 2 > data.size:
            raise ValueError(f"IFD offset {offset} lies outside the file")
        (n,) = struct.unpack_from(order + "H", data, offset)
        if offset + 2 + 12 * n > data.size:
            raise ValueError("the IFD runs past the end of the file")
        for k in range(n):
            tag, typ, count, value = struct.unpack_from(
                order + "HHI4s", data, offset + 2 + 12 * k)
            code = _TYPES.get(typ)
            if code is None:  # rationals, IFDs: no tag read here needs one
                continue
            size = np.dtype(code).itemsize * count
            if size <= 4:
                raw = np.frombuffer(value, np.uint8, size)
            else:
                (at,) = struct.unpack(order + "I", value)
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


def _layout(ifd: _Ifd):
    """Validate the tags; returns (height, width, spp, sample dtype code,
    compression, predictor, photometric, unassociated alpha)."""
    width, height = ifd.one(_WIDTH), ifd.one(_LENGTH)
    if width < 1 or height < 1:
        raise ValueError(f"unsupported TIFF: an image of {width} x {height}")
    spp = ifd.one(_SPP, 1)
    if spp not in (1, 3, 4):
        raise _unsupported(_SPP, spp)
    bits = ifd.get(_BITS, np.array([1]))
    if len(set(bits.tolist())) != 1:
        raise _unsupported(_BITS, bits.tolist())
    bits = int(bits[0])
    fmt = ifd.get(_SAMPLE_FORMAT, np.array([1]))
    if len(set(fmt.tolist())) != 1:
        raise _unsupported(_SAMPLE_FORMAT, fmt.tolist())
    fmt = int(fmt[0])
    if fmt == 1 and bits in (8, 16):
        code = f"u{bits // 8}"
    elif fmt == 3 and bits in (32, 64):
        code = f"f{bits // 8}"
    elif fmt not in (1, 3):
        raise _unsupported(_SAMPLE_FORMAT, fmt)
    else:
        raise _unsupported(_BITS, bits)
    compression = ifd.one(_COMPRESSION, 1)
    if compression not in (1, 5, 8):
        raise _unsupported(_COMPRESSION, compression)
    predictor = ifd.one(_PREDICTOR, 1)
    if predictor not in (1, 2, 3) or (predictor == 2 and fmt != 1) or \
            (predictor == 3 and fmt != 3):
        raise _unsupported(_PREDICTOR, predictor)
    photometric = ifd.one(_PHOTOMETRIC)
    if (photometric, spp) not in ((1, 1), (2, 3), (2, 4)):
        raise _unsupported(_PHOTOMETRIC, f"{photometric} with "
                           f"SamplesPerPixel={spp}")
    for tag in (_PLANAR, _FILL_ORDER, _ORIENTATION):
        if ifd.one(tag, 1) != 1:
            raise _unsupported(tag, ifd.one(tag))
    extra = ifd.get(_EXTRA_SAMPLES, np.array([], np.int64)).tolist()
    if len(extra) > spp - (3 if spp >= 3 else 1) or \
            any(e not in (0, 1, 2) for e in extra):
        raise _unsupported(_EXTRA_SAMPLES, extra)
    return (height, width, spp, code, compression, predictor, photometric,
            bool(extra) and extra[0] == 2)


def _chunks(ifd: _Ifd, height: int, width: int, row_bytes: int):
    """(file offsets, byte counts, decoded sizes, tile shape or None)."""
    if _TILE_WIDTH in ifd.tags:
        tw, th = ifd.one(_TILE_WIDTH), ifd.one(_TILE_LENGTH)
        if tw < 1 or th < 1:
            raise ValueError(f"unsupported TIFF: tiles of {tw} x {th}")
        offsets, counts = ifd.get(_TILE_OFFSETS), ifd.get(_TILE_COUNTS)
        n = -(-height // th) * -(-width // tw)
        sizes = np.full(n, th * tw * row_bytes // width, np.int64)
        tile = (th, tw)
    else:
        rps = min(ifd.one(_ROWS_PER_STRIP, 2 ** 32 - 1), height)
        if rps < 1:
            raise ValueError(f"unsupported TIFF: RowsPerStrip={rps}")
        offsets, counts = ifd.get(_STRIP_OFFSETS), ifd.get(_STRIP_COUNTS)
        n = -(-height // rps)
        rows = np.minimum(rps, height - rps * np.arange(n))
        sizes = rows * row_bytes
        tile = None
    if offsets is None or counts is None or len(offsets) != n or \
            len(counts) != n:
        raise ValueError(f"expected {n} chunk offsets and byte counts")
    return offsets, counts, sizes, tile


def _decode(data: np.ndarray, ifd: _Ifd, layout) -> np.ndarray:
    """The (H, W, spp) samples, in the host's byte order, file channel
    order."""
    height, width, spp, code, compression, predictor, _, _ = layout
    size = int(code[1])
    row_bytes = width * spp * size
    offsets, counts, sizes, tile = _chunks(ifd, height, width, row_bytes)
    dst_offsets = np.zeros_like(sizes)
    np.cumsum(sizes[:-1], out=dst_offsets[1:])
    total = int(sizes.sum())
    if compression == 1 and np.all(offsets == offsets[0] + dst_offsets) \
            and np.all(counts >= sizes) and offsets[0] + total <= data.size:
        # uncompressed chunks back to back in the file: no copy
        buf = data[int(offsets[0]):int(offsets[0]) + total]
        compression = None
    else:
        buf = np.empty(total, np.uint8)
    if compression == 5:
        got = native.lzw_decode_chunks(data, offsets, counts, buf,
                                       dst_offsets, sizes)
        short = np.flatnonzero(got != sizes)
        if short.size:
            k = int(short[0])
            raise ValueError(f"LZW chunk {k} decodes to {int(got[k])} bytes,"
                             f" expected {int(sizes[k])}")
    elif compression is not None:
        for k, (at, count, dst, want) in enumerate(zip(
                offsets.tolist(), counts.tolist(), dst_offsets.tolist(),
                sizes.tolist())):
            raw = data[at:at + count]
            if compression == 8:
                raw = np.frombuffer(zlib.decompress(raw), np.uint8)
            if raw.size < want or (compression == 8 and raw.size != want):
                raise ValueError(f"chunk {k} holds {raw.size} bytes, "
                                 f"expected {want}")
            buf[dst:dst + want] = raw[:want]
    swap = ifd.order == ">" and size > 1
    rows, samples = (len(sizes) * tile[0], tile[1] * spp) if tile else \
        (height, width * spp)
    if predictor != 1:
        native.predictor_undo(buf, rows, samples, spp, size, predictor, swap)
        swap = False
    arr = buf.view((">" if swap else "=") + code)
    if swap:
        arr = arr.astype("=" + code)
    if tile is None:
        return arr.reshape(height, width, spp)
    th, tw = tile
    down, across = -(-height // th), -(-width // tw)
    return arr.reshape(down, across, th, tw, spp).transpose(
        0, 2, 1, 3, 4).reshape(down * th, across * tw, spp)[:height, :width]


def _swap_red_blue(px: np.ndarray) -> np.ndarray:
    """RGB(A) <-> BGR(A) over the last axis, as a new C-contiguous array
    (``np.take`` copies it faster than fancy indexing)."""
    return np.take(px, [2, 1, 0, 3][:px.shape[2]], axis=2)


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
    head = data[:8].tobytes()
    if head[:2] not in (b"II", b"MM"):
        raise ValueError(f"{path} is not a TIFF (byte order {head[:2]!r})")
    order = "<" if head[:2] == b"II" else ">"
    magic, first = struct.unpack(order + "HI", head[2:8])
    if magic != 42:
        raise ValueError(f"{path}: TIFF version {magic} is not read "
                         "(BigTIFF is 43)")
    ifd = _Ifd(data, order, first)
    layout = _layout(ifd)
    spp, code, unassociated = layout[2], layout[3], layout[7]
    if flags == IMREAD_COLOR:
        if code[0] == "f":
            return None
        if unassociated:
            raise _unsupported(_EXTRA_SAMPLES, "2 (unassociated alpha) "
                               "under IMREAD_COLOR")
    px = _decode(data, ifd, layout)
    if flags == IMREAD_UNCHANGED:
        if spp == 1:
            return np.ascontiguousarray(px[..., 0])
        return _swap_red_blue(px)
    if spp == 1:
        gray = px if code == "u1" else (px >> 8).astype(np.uint8)
        return np.repeat(gray, 3, axis=2)
    bgr = _swap_red_blue(px[..., :3])
    if code == "u2":  # libtiff's RGBA reader: round(v / 257)
        bgr = ((bgr.astype(np.uint32) + 128) // 257).astype(np.uint8)
    return bgr


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
