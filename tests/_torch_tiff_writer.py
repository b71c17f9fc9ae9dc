"""A TIFF writer in NumPy, for the tests and ``chip_smoke.py``.

The machine with the card has neither cv2, PIL nor tifffile, so
``chip_smoke.py`` writes the TIFF layouts the port reads with this.  One
IFD, classic TIFF or BigTIFF, either byte order, strips or tiles, chunky
or planar (PlanarConfiguration 2) samples of any NumPy integer or float
type, or unsigned samples packed to fewer bits (1-15, MSB first, each row
padded to a byte); compression none, LZW (the port's plain encoder),
Deflate (8 or the old 32946) or PackBits; horizontal differencing;
FillOrder 2 (the stored bytes bit-reversed).  Also YCbCr samples packed
in subsampling units (a block of Y, then Cb and Cr), JPEG chunks (7) as
libtiff writes them (the tables in JPEGTables, each chunk an abbreviated
stream; YCbCr, RGB or gray, encoded by ``tests/_torch_mjpeg_writer.py``)
and bilevel rows coded as CCITT Modified Huffman (2) or T.4
one-dimensional (3, an EOL before each row).  Any tag can be added or
replaced.  ``layout_cases`` yields, for each layout the port reads
beyond cv2's own output, the samples, the writer's keywords and the
arrays ``cv2.imread`` returns under IMREAD_UNCHANGED and IMREAD_COLOR,
as plain NumPy formulas (``tests/test_torch_tiff.py`` holds them to cv2).
Test tooling, not a feature of the package: it imports nothing of it,
apart from the plain LZW encoder and the CCITT code tables.
"""
from __future__ import annotations

import struct
import zlib
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

__all__ = ["build_tiff", "packbits_encode", "pack_bits", "layout_cases",
           "ycbcr_units", "jpeg_parts", "ccitt_encode"]

# field type -> struct code (a RATIONAL's values are numerator,
# denominator pairs)
_FIELD = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 6: "b", 7: "B", 8: "h",
          9: "i", 11: "f", 12: "d", 16: "Q", 17: "q"}
_SAMPLING = {(1, 1): "444", (2, 1): "422", (2, 2): "420"}


def packbits_encode(data) -> bytes:
    """PackBits (TIFF compression 32773): runs of 3 or more equal bytes as
    repeat packets, the rest as literal packets, none longer than 128."""
    a = np.frombuffer(bytes(data), np.uint8)
    n = a.size
    if n == 0:
        return b""
    starts = np.flatnonzero(np.r_[True, a[1:] != a[:-1]])
    rep = np.diff(np.r_[starts, n]) >= 3
    # a repeat run is a segment of its own; other runs join their
    # neighbours into literal segments
    first = rep | np.r_[True, rep[:-1]]
    seg_at, seg_rep = starts[first], rep[first]
    seg_len = np.diff(np.r_[seg_at, n])
    npk = -(-seg_len // 128)
    seg = np.repeat(np.arange(seg_at.size), npk)
    k = np.arange(int(npk.sum())) - np.repeat(np.cumsum(npk) - npk, npk)
    at = seg_at[seg] + 128 * k
    length = np.minimum(128, seg_len[seg] - 128 * k)
    is_rep = seg_rep[seg] & (length >= 2)
    out_len = 1 + np.where(is_rep, 1, length)
    out_at = np.cumsum(out_len) - out_len
    out = np.empty(int(out_len.sum()), np.uint8)
    out[out_at] = np.where(is_rep, 257 - length, length - 1)
    out[out_at[is_rep] + 1] = a[at[is_rep]]
    lit = ~is_rep
    ll = length[lit]
    within = np.arange(int(ll.sum())) - np.repeat(np.cumsum(ll) - ll, ll)
    out[np.repeat(out_at[lit] + 1, ll) + within] = \
        a[np.repeat(at[lit], ll) + within]
    return out.tobytes()


def pack_bits(rows: np.ndarray, bits: int) -> np.ndarray:
    """(R, N) unsigned values below 2**bits as (R, ceil(N * bits / 8))
    bytes, MSB first, each row padded to a byte."""
    rows = np.asarray(rows).astype(np.uint32)
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint32)
    flat = ((rows[..., None] >> shifts) & 1).astype(np.uint8)
    return np.packbits(flat.reshape(rows.shape[0], -1), axis=1)


def ycbcr_units(px: np.ndarray, hs: int, vs: int) -> np.ndarray:
    """(H, W, 3) Y, Cb, Cr samples as TIFF's subsampling units: each
    ``hs`` x ``vs`` block of Y (rows in order), then the block's Cb and
    Cr, taken from its top-left pixel; the blocks of one block row in
    order, as (ceil(H / vs), ceil(W / hs) * (hs * vs + 2)) bytes.  Edge
    blocks are padded with zero Y."""
    h, w = px.shape[:2]
    ph, pw = -(-h // vs) * vs, -(-w // hs) * hs
    pad = np.zeros((ph, pw, 3), px.dtype)
    pad[:h, :w] = px
    y = pad[..., 0].reshape(ph // vs, vs, pw // hs, hs).swapaxes(1, 2)
    units = np.concatenate([y.reshape(ph // vs, pw // hs, hs * vs),
                            pad[::vs, ::hs, 1:]], axis=2)
    return units.reshape(ph // vs, -1)


def jpeg_parts(frame: bytes) -> Tuple[bytes, bytes]:
    """(JPEGTables, the abbreviated chunk) of one JPEG as
    ``_torch_mjpeg_writer.encode_jpeg`` writes it: the tables stream is
    SOI, DQT, DHT, EOI; the chunk SOI and what followed the DHT."""
    at = 2
    while frame[at + 1] in (0xDB, 0xC4):
        at += 2 + struct.unpack(">H", frame[at + 2:at + 4])[0]
    return frame[:at] + b"\xff\xd9", frame[:2] + frame[at:]


def ccitt_encode(rows: np.ndarray, compression: int, fill: bool = False
                 ) -> bytes:
    """(R, W) 0/1 rows (1 black) coded one-dimensionally, as libtiff's
    encoder does: runs from white, long runs as make-up codes (2560 while
    2624 or more remain) and a terminating code.  Compression 2 (Modified
    Huffman) pads each row to a byte; 3 (T.4) puts an EOL before each row
    (after zero fill bits that end it on a byte boundary, with ``fill``)
    and six after the last (RTC)."""
    from camera_linearity_tpu_torch.native.tiff_plain import (
        BLACK_CODES, EOL, WHITE_CODES)
    bits = []
    n = 0
    for row in np.asarray(rows, np.uint8):
        if compression == 3:
            if fill:
                pad = -(n + len(EOL)) % 8
                bits.append("0" * pad)
                n += pad
            bits.append(EOL)
            n += len(EOL)
        edges = np.flatnonzero(np.diff(np.r_[0, row, 1 - row[-1]]))
        runs = np.diff(np.r_[0, edges])
        for k, run in enumerate(runs.tolist()):
            table = BLACK_CODES if k % 2 else WHITE_CODES
            while run >= 2624:
                bits.append(table[2560])
                n += len(table[2560])
                run -= 2560
            if run >= 64:
                bits.append(table[run // 64 * 64])
                n += len(table[run // 64 * 64])
                run %= 64
            bits.append(table[run])
            n += len(table[run])
        if compression == 2:
            bits.append("0" * (-n % 8))
            n += -n % 8
    if compression == 3:
        bits.append(EOL * 6)
    s = "".join(bits)
    s += "0" * (-len(s) % 8)
    return np.packbits(np.frombuffer(s.encode(), np.uint8) - 48).tobytes()


def _reverse_bits(raw: bytes) -> bytes:
    table = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                     np.uint8)
    return table[np.frombuffer(raw, np.uint8)].tobytes()


def _compress(raw: bytes, compression: int) -> bytes:
    if compression == 1:
        return raw
    if compression in (8, 32946):
        return zlib.compress(raw)
    if compression == 32773:
        return packbits_encode(raw)
    if compression == 5:
        from camera_linearity_tpu_torch.native import tiff_plain
        return tiff_plain.lzw_encode(raw)
    raise ValueError(f"compression {compression} is not written")


def _pieces(px: np.ndarray, rps: Optional[int],
            tile: Optional[Tuple[int, int]]):
    """The chunks of (H, W, S) ``px``: strips of ``rps`` rows or tiles of
    ``tile`` = (th, tw), padded with zeros at the right and bottom."""
    height, width = px.shape[:2]
    if tile is None:
        rps = rps or height
        return [px[r:r + rps] for r in range(0, height, rps)]
    th, tw = tile
    pad = np.zeros((-(-height // th) * th, -(-width // tw) * tw,
                    px.shape[2]), px.dtype)
    pad[:height, :width] = px
    return [pad[r:r + th, c:c + tw] for r in range(0, pad.shape[0], th)
            for c in range(0, pad.shape[1], tw)]


def build_tiff(path, order: str, px: np.ndarray, *, compression: int = 1,
               predictor: int = 1, rps: Optional[int] = None,
               tile: Optional[Tuple[int, int]] = None, planar: bool = False,
               bits: Optional[int] = None, bigtiff: bool = False,
               fill_order: int = 1,
               extra_tags: Iterable[Tuple[int, int, Sequence]] = (),
               fmt: Optional[int] = None,
               ycbcr: Optional[Tuple[int, int]] = None, quality: int = 90,
               fax_fill: bool = False) -> None:
    """Write the (H, W, S) samples ``px`` (file channel order) as a
    one-IFD TIFF in byte order ``order`` ("<" or ">"): strips of ``rps``
    rows or tiles of ``tile`` = (th, tw); chunky, or one plane a chunk
    after another (``planar``); packed to ``bits`` bits a sample when
    given (unsigned values); differenced (``predictor`` 2, per plane when
    planar) and compressed as ``compression`` says; bit-reversed after
    that for ``fill_order`` 2; as BigTIFF (8-byte offsets) when
    ``bigtiff``.  ``extra_tags`` are (tag, field type, values) entries
    added or replacing; ``fmt`` overrides SampleFormat.

    ``ycbcr`` = (hs, vs) makes three samples PhotometricInterpretation 6
    with that YCbCrSubSampling: ``px`` holds Y, Cb, Cr, packed in units
    (``ycbcr_units``), or, under compression 7, R, G, B, which the JPEG
    encoder converts (4:4:4, 4:2:2 or 4:2:0).  Compression 7 without
    ``ycbcr`` codes RGB or gray as stored, at ``quality``.  Compression 2
    and 3 code 0/1 samples (1 black) one-dimensionally (``ccitt_encode``;
    ``fax_fill`` sets T4Options bit 2 and byte-aligns the EOLs)."""
    px = np.asarray(px)
    if px.ndim == 2:
        px = px[..., None]
    height, width, spp = px.shape
    nbits = bits or 8 * px.dtype.itemsize
    planes = [px[..., s:s + 1] for s in range(spp)] if planar else [px]
    chunks, tables = [], None
    for plane in planes:
        stride = plane.shape[2]
        for piece in _pieces(plane, rps, tile):
            if compression == 7:
                if spp == 3:
                    img = piece[..., ::-1] if ycbcr else piece
                else:
                    img = piece[..., 0]
                frame = _jpeg_encode(np.ascontiguousarray(img), quality,
                                     _SAMPLING[ycbcr or (1, 1)],
                                     ycbcr is not None or spp != 3)
                tables, chunk = jpeg_parts(frame)
                chunks.append(chunk)
                continue
            if compression in (2, 3):
                raw = ccitt_encode(piece[..., 0], compression, fax_fill)
                chunks.append(_reverse_bits(raw) if fill_order == 2 else raw)
                continue
            if ycbcr:
                rows = ycbcr_units(piece, *ycbcr)
            else:
                rows = np.ascontiguousarray(piece).reshape(piece.shape[0],
                                                           -1)
            if predictor == 2:
                u = rows.view(f"u{rows.dtype.itemsize}")
                diff = u.copy()
                diff[:, stride:] = u[:, stride:] - u[:, :-stride]
                rows = diff.view(rows.dtype)
            if bits:
                raw = pack_bits(rows, bits).tobytes()
            else:
                raw = rows.astype(rows.dtype.newbyteorder(order)).tobytes()
            raw = _compress(raw, compression)
            if fill_order == 2:
                raw = _reverse_bits(raw)
            chunks.append(raw)
    kind = {"u": 1, "i": 2, "f": 3}[px.dtype.kind]
    head = 16 if bigtiff else 8
    offsets, at = [], head
    for c in chunks:
        offsets.append(at)
        at += len(c) + len(c) % 2
    big = 16 if bigtiff else 4
    tags = {256: (4, [width]), 257: (4, [height]),
            258: (3, [nbits] * spp), 259: (3, [compression]),
            262: (3, [6 if ycbcr else 1 if spp < 3 else 2]), 277: (3, [spp]),
            284: (3, [2 if planar else 1]), 339: (3, [fmt or kind] * spp)}
    if ycbcr:
        tags[530] = (3, list(ycbcr))
    if tables is not None:
        tags[347] = (7, list(tables))
    if compression == 3 and fax_fill:
        tags[292] = (4, [4])
    if fill_order != 1:
        tags[266] = (3, [fill_order])
    if predictor != 1:
        tags[317] = (3, [predictor])
    counts = [len(c) for c in chunks]
    if tile is None:
        tags.update({273: (big, offsets), 278: (4, [rps or height]),
                     279: (big, counts)})
    else:
        tags.update({322: (3, [tile[1]]), 323: (3, [tile[0]]),
                     324: (big, offsets), 325: (big, counts)})
    for tag, typ, values in extra_tags:
        tags[tag] = (typ, list(values))
    body = b"".join(c + b"\0" * (len(c) % 2) for c in chunks)
    inline, entry_size, count_fmt = (8, 20, "Q") if bigtiff else \
        (4, 12, "H")
    values_at = at + (8 if bigtiff else 2) + entry_size * len(tags) + \
        inline
    extra, entries = bytearray(), []
    for tag in sorted(tags):
        typ, values = tags[tag]
        raw = struct.pack(f"{order}{len(values)}{_FIELD[typ]}", *values)
        if len(raw) <= inline:
            field = raw.ljust(inline, b"\0")
        else:
            field = struct.pack(order + ("Q" if bigtiff else "I"),
                                values_at + len(extra))
            extra += raw + b"\0" * (len(raw) % 2)
        count = len(values) // 2 if typ == 5 else len(values)
        entries.append(struct.pack(order + ("HHQ" if bigtiff else "HHI"),
                                   tag, typ, count) + field)
    magic = b"II" if order == "<" else b"MM"
    header = magic + (struct.pack(order + "HHHQ", 43, 8, 0, at) if bigtiff
                      else struct.pack(order + "HI", 42, at))
    with open(path, "wb") as f:
        f.write(header + body + struct.pack(order + count_fmt, len(tags))
                + b"".join(entries)
                + struct.pack(order + ("Q" if bigtiff else "I"), 0)
                + bytes(extra))


def _jpeg_encode(img: np.ndarray, quality: int, sampling: str,
                 convert: bool) -> bytes:
    from tests._torch_mjpeg_writer import encode_jpeg
    return encode_jpeg(img, quality, sampling, convert=convert)


def _bgr(px: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(px[..., [2, 1, 0, 3][:px.shape[2]]])


def _gray3(g: np.ndarray) -> np.ndarray:
    return np.repeat(g[..., None], 3, axis=2)


def _to8(v: np.ndarray) -> np.ndarray:
    return ((v.astype(np.uint32) + 128) // 257).astype(np.uint8)


def layout_cases(height: int, width: int, seed: int = 0):
    """Yield (name, samples, ``build_tiff`` keywords, want under
    IMREAD_UNCHANGED, want under IMREAD_COLOR) for one image of each
    layout; a want of None is cv2's None.  Strips of 16 rows.  One
    exception to "what cv2 returns": cv2 5.0 reads planar samples wider
    than 8 bits under IMREAD_UNCHANGED as if they were chunky, so the
    want there is the stored image."""
    rng = np.random.default_rng(seed)

    def draw(dtype, *channels):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, (height, width, *channels),
                            dtype, endpoint=True)
    u8, u16 = draw(np.uint8, 3), draw(np.uint16, 3)
    g8, g16 = draw(np.uint8), draw(np.uint16)
    strips = dict(rps=16)
    yield "BigTIFF u8 RGB", u8, dict(bigtiff=True, **strips), _bgr(u8), \
        _bgr(u8)
    yield "PackBits u8 RGB", u8, dict(compression=32773, **strips), \
        _bgr(u8), _bgr(u8)
    yield "PackBits u16 gray", g16, dict(compression=32773, **strips), \
        g16, _gray3((g16 >> 8).astype(np.uint8))
    yield "Deflate 32946 u8 RGB", u8, dict(compression=32946, predictor=2,
                                           **strips), _bgr(u8), _bgr(u8)
    yield "planar u8 RGB", u8, dict(planar=True, compression=32773,
                                    **strips), _bgr(u8), _bgr(u8)
    yield "planar u8 RGB tiles", u8, dict(planar=True, tile=(64, 64)), \
        _bgr(u8), _bgr(u8)
    yield "planar u16 RGB", u16, dict(planar=True, **strips), _bgr(u16), \
        _to8(_bgr(u16))
    f64 = rng.random((height, width, 3))
    yield "planar f64 RGB", f64, dict(planar=True), _bgr(f64), None
    i8 = draw(np.int8)
    yield "int8 gray", i8, {}, i8, _gray3(i8.view(np.uint8))
    i16 = draw(np.int16)
    yield "int16 gray", i16, dict(compression=8, predictor=2, **strips), \
        i16, _gray3((i16.view(np.uint16) >> 8).astype(np.uint8))
    i32 = draw(np.int32)
    yield "int32 gray", i32, dict(compression=8, predictor=2, **strips), \
        i32, None
    u32 = draw(np.uint32)
    yield "uint32 gray", u32, {}, u32, None
    v12 = rng.integers(0, 4096, (height, width), np.uint16)
    yield "12-bit gray", v12, dict(bits=12, **strips), v12 << 4, None
    white = [(262, 3, [0])]
    yield "MinIsWhite u8", g8, dict(extra_tags=white), 255 - g8, \
        _gray3(255 - g8)
    yield "MinIsWhite u16", g16, dict(extra_tags=white), g16, \
        _gray3(255 - (g16 >> 8).astype(np.uint8))
    cmap = rng.integers(0, 65536, (3, 256))
    colors = _bgr((cmap.T >> 8).astype(np.uint8)[g8])
    yield "palette u8", g8, dict(extra_tags=[(262, 3, [3]), (320, 3, cmap
                                                               .ravel())]), \
        colors, colors
    cmyk = draw(np.uint8, 4)
    k = 255 - cmyk[..., 3:].astype(np.uint32)
    bgr = (k * (255 - cmyk[..., 2::-1].astype(np.uint32)) // 255).astype(
        np.uint8)
    yield "CMYK u8", cmyk, dict(extra_tags=[(262, 3, [5])]), \
        np.concatenate([bgr, np.full_like(bgr[..., :1], 255)], axis=2), bgr
    la = draw(np.uint8, 2)
    yield "gray+alpha u8", la, dict(extra_tags=[(338, 3, [2])]), \
        la[..., 0].copy(), _gray3(la[..., 0])
    yield "Orientation 3 u8 RGB", u8, dict(extra_tags=[(274, 3, [3])],
                                           **strips), \
        _bgr(u8)[::-1, ::-1].copy(), _bgr(u8)[::-1, ::-1].copy()
    rotated = None if height != width else np.rot90(_bgr(u16), -1).copy()
    yield "Orientation 6 u16 RGB", u16, dict(extra_tags=[(274, 3, [6])]), \
        rotated, None if rotated is None else np.rot90(_to8(_bgr(u16)), -1
                                                       ).copy()
    yield "FillOrder 2 u8 RGB", u8, dict(fill_order=2, compression=8,
                                         **strips), _bgr(u8), _bgr(u8)
