"""PNG encoder and PNG-in-AVI writer for the port's PNG tests (NumPy +
``zlib``, no cv2).

``encode_png`` writes one PNG file of any colour type and bit depth the
format has: gray (1, 2, 4, 8, 16 bits), RGB (8, 16), palette (1, 2, 4, 8,
with or without ``tRNS``), gray + alpha (8, 16) and RGBA (8, 16); each
row's filter chosen by the caller (``"mixed"`` cycles the five, as
ImageJ/Fiji's writer and libpng pick one a row); Adam7 interlace; the
data split over several ``IDAT`` chunks; ancillary chunks (``gAMA``,
``sRGB``, ``iCCP``, ``pHYs``, ``tEXt``) before the data.

``write_png_avi`` puts such files into an AVI as ImageJ/Fiji's "Save As
AVI, PNG" and ``cv2.VideoWriter(fourcc "MPNG")`` do: one PNG a ``NNdc``
chunk, under the ``MPNG``, ``PNG1`` or ``png `` fourcc (all three are PNG
to FFmpeg), with the container of ``tests/_torch_rawvideo_writer.py``.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from tests._torch_rawvideo_writer import video_headers, write_avi

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each colour type
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7: (x0, y0, dx, dy) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def chunk(tag: bytes, body: bytes) -> bytes:
    """A PNG chunk with its CRC."""
    return struct.pack(">I", len(body)) + tag + body + \
        struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_row(ftype: int, row: np.ndarray, prior: np.ndarray,
                bpp: int) -> np.ndarray:
    """Row bytes after filter ``ftype`` (PNG spec, section 9)."""
    x = row.astype(np.int32)
    b = prior.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
    pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1, 4: _paeth(a, b, c)}[ftype]
    return ((x - pred) & 0xFF).astype(np.uint8)


def pack_rows(samples: np.ndarray, bit_depth: int) -> np.ndarray:
    """(h, n) samples -> (h, row bytes): packed MSB first below 8 bits,
    big-endian at 16."""
    h, n = samples.shape
    if bit_depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if bit_depth == 8:
        return samples.astype(np.uint8)
    per = 8 // bit_depth
    padded = np.zeros((h, -(-n // per) * per), np.uint8)
    padded[:, :n] = samples
    shifts = (8 - bit_depth * (np.arange(per) + 1)).astype(np.uint8)
    groups = padded.reshape(h, -1, per) << shifts
    return np.bitwise_or.reduce(groups, axis=2).astype(np.uint8)


def _scanlines(image: np.ndarray, bit_depth: int, filters, bpp: int,
               start: int) -> bytes:
    """The filtered scanlines of one (sub)image; ``filters`` gives row i's
    filter as ``filters[(start + i) % len(filters)]``."""
    h = image.shape[0]
    if h == 0 or image.shape[1] == 0:
        return b""
    rows = pack_rows(image.reshape(h, -1), bit_depth)
    prior = np.zeros(rows.shape[1], np.uint8)
    out = []
    for i, row in enumerate(rows):
        ftype = filters[(start + i) % len(filters)]
        out.append(bytes([ftype]) + _filter_row(ftype, row, prior,
                                                bpp).tobytes())
        prior = row
    return b"".join(out)


def encode_png(image: np.ndarray, color_type: int, bit_depth: int = 8,
               palette: Optional[np.ndarray] = None,
               trns: Optional[np.ndarray] = None, filters="mixed",
               interlace: bool = False, idat_chunks: int = 1,
               ancillary: bool = False, level: int = 6,
               crc_error: bool = False) -> bytes:
    """One PNG file of ``image``: (H, W) for gray and palette indices,
    (H, W, c) otherwise, samples in the bit depth's range.

    ``palette`` ((n, 3) RGB) goes into ``PLTE``, ``trns`` (n alpha bytes)
    into ``tRNS``; ``filters`` is a filter type for every row, a sequence
    cycled over the rows, or ``"mixed"`` (0, 1, 2, 3, 4, ...);
    ``interlace`` writes the seven Adam7 passes; ``idat_chunks`` splits
    the zlib stream over that many ``IDAT`` chunks; ``ancillary`` puts
    ``gAMA``, ``sRGB``, ``iCCP``, ``pHYs`` and ``tEXt`` before the data;
    ``crc_error`` spoils the first ``IDAT``'s CRC."""
    image = np.asarray(image)
    h, w = image.shape[:2]
    channels = CHANNELS[color_type]
    bpp = max(1, channels * bit_depth // 8)
    if filters == "mixed":
        filters = (0, 1, 2, 3, 4)
    elif isinstance(filters, int):
        filters = (filters,)
    if interlace:
        parts, start = [], 0
        for x0, y0, dx, dy in ADAM7:
            sub = image[y0::dy, x0::dx]
            parts.append(_scanlines(sub, bit_depth, filters, bpp, start))
            start += sub.shape[0]
        raw = b"".join(parts)
    else:
        raw = _scanlines(image, bit_depth, filters, bpp, 0)
    data = zlib.compress(raw, level)
    out = [SIGNATURE, chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, bit_depth, color_type, 0, 0, int(interlace)))]
    if ancillary:
        out += [chunk(b"gAMA", struct.pack(">I", 45455)),
                chunk(b"sRGB", b"\0"),
                chunk(b"iCCP", b"icc\0\0" + zlib.compress(b"\0" * 128)),
                chunk(b"pHYs", struct.pack(">IIB", 3780, 3780, 1)),
                chunk(b"tEXt", b"Software\0camera_linearity tests")]
    if palette is not None:
        out.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        out.append(chunk(b"tRNS", np.asarray(trns, np.uint8).tobytes()))
    cuts = np.linspace(0, len(data), idat_chunks + 1).astype(int)
    for k, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
        body = chunk(b"IDAT", data[a:b])
        if crc_error and k == 0:
            body = body[:-1] + bytes([body[-1] ^ 0xFF])
        out.append(body)
    out.append(chunk(b"IEND", b""))
    return b"".join(out)


def write_png_avi(path: Path, payloads: Sequence[bytes], height: int,
                  width: int, fourcc: str = "MPNG", bit_count: int = 24,
                  stream: int = 0, others=(), fps: int = 30) -> None:
    """An AVI whose video frames are the PNG files ``payloads``.  The
    header states ``bit_count`` (cv2's writer states 24 for colour and
    40 for gray)."""
    payloads = list(payloads)
    tag = fourcc.encode()
    strh, strf = video_headers(height, width, tag, bit_count, len(payloads),
                               max(map(len, payloads), default=0), fps,
                               compression=tag, image_size=width * height * 3)
    write_avi(path, strh, strf, payloads, b"dc", fps=fps, stream=stream,
              others=others)
