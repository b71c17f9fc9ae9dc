"""Plain Python / NumPy versions of the native TIFF codec (``tiff.cpp``).

The tests hold the native library to these: the same LZW code stream
byte for byte, the same PackBits output, and the same predictor
arithmetic.  Nothing in the package
calls them; the LZW here is pure Python and far too slow for a capture.
"""
from __future__ import annotations

import numpy as np

__all__ = ["lzw_decode", "lzw_encode", "packbits_decode", "predictor_undo",
           "predictor_apply"]

_CLEAR, _EOI, _FIRST, _MAX_BITS = 256, 257, 258, 12


def lzw_decode(data: bytes) -> bytes:
    """Decode one TIFF-LZW chunk (MSB-first codes of 9-12 bits, the width
    growing one code early); a chunk without EOI ends with its bytes."""
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()
    bits = nbits = pos = 0
    width, old = 9, None
    while True:
        while nbits < width and pos < len(data):
            bits = (bits << 8) | data[pos]
            pos += 1
            nbits += 8
        if nbits < width:
            break
        code = (bits >> (nbits - width)) & ((1 << width) - 1)
        nbits -= width
        bits &= (1 << nbits) - 1
        if code == _EOI:
            break
        if code == _CLEAR:
            del table[_FIRST:]
            width, old = 9, None
            continue
        if old is None:
            if code > 255:
                raise ValueError("corrupt LZW data")
            out += table[code]
            old = code
            continue
        if code < len(table):
            entry = table[code]
        elif code == len(table):
            entry = table[old] + table[old][:1]
        else:
            raise ValueError("corrupt LZW data")
        if len(table) < 1 << _MAX_BITS:
            table.append(table[old] + entry[:1])
        out += entry
        old = code
        if len(table) + 1 >= 1 << width and width < _MAX_BITS:
            width += 1
    return bytes(out)


def lzw_encode(data: bytes) -> bytes:
    """Encode one chunk as libtiff's LZW encoder does: Clear first, a Clear
    whenever the table reaches 4094 entries, EOI last."""
    out = bytearray()
    state = {"bits": 0, "nbits": 0}

    def put(code: int, width: int) -> None:
        state["bits"] = (state["bits"] << width) | code
        state["nbits"] += width
        while state["nbits"] >= 8:
            state["nbits"] -= 8
            out.append((state["bits"] >> state["nbits"]) & 0xFF)
        state["bits"] &= (1 << state["nbits"]) - 1

    table: dict = {}
    width, nxt = 9, _FIRST

    def grow() -> None:
        nonlocal width, nxt
        if nxt == (1 << _MAX_BITS) - 2:
            put(_CLEAR, width)
            table.clear()
            width, nxt = 9, _FIRST
        elif nxt > (1 << width) - 1:
            width += 1

    put(_CLEAR, width)
    if data:
        ent = data[0]
        for c in data[1:]:
            code = table.get((ent, c))
            if code is not None:
                ent = code
                continue
            put(ent, width)
            table[(ent, c)] = nxt
            nxt += 1
            grow()
            ent = c
        put(ent, width)
        nxt += 1
        grow()
    put(_EOI, width)
    if state["nbits"]:
        out.append((state["bits"] << (8 - state["nbits"])) & 0xFF)
    return bytes(out)


def packbits_decode(data: bytes, size: int) -> bytes:
    """Decode one PackBits chunk into at most ``size`` bytes, as libtiff
    does: a header byte n >= 0 copies the next n + 1 bytes, n in
    [-127, -1] repeats the next byte 1 - n times, -128 does nothing;
    output past ``size`` is dropped, and a packet cut short by the end of
    the data ends the decode (the result is then shorter)."""
    out = bytearray()
    pos = 0
    while pos < len(data) and len(out) < size:
        n = data[pos] - 256 if data[pos] > 127 else data[pos]
        pos += 1
        if n == -128:
            continue
        if n < 0:
            if pos == len(data):
                break
            out += bytes([data[pos]]) * (1 - n)
            pos += 1
        else:
            if len(data) - pos < n + 1:
                break
            out += data[pos:pos + n + 1]
            pos += n + 1
    return bytes(out[:size])


def predictor_undo(rows: np.ndarray, spp: int, size: int, predictor: int,
                   big_endian: bool = False) -> np.ndarray:
    """Undo a predictor on ``rows``, a (R, row bytes) uint8 array of file
    bytes holding samples of ``size`` bytes; returns (R, samples) in the
    host's order: unsigned integers of any width for predictor 1 and 2,
    floats for predictor 3 (whose byte planes run most significant first,
    whatever ``big_endian`` says)."""
    rows = np.ascontiguousarray(rows, np.uint8)
    r = rows.shape[0]
    if predictor == 3:
        acc = np.cumsum(rows.reshape(r, -1, spp), axis=1, dtype=np.uint8)
        planes = acc.reshape(r, size, -1).transpose(0, 2, 1)
        return np.ascontiguousarray(planes).view(f">f{size}").reshape(
            r, -1).astype(f"=f{size}")
    x = rows.view(f">u{size}" if big_endian else f"<u{size}").astype(
        f"=u{size}").reshape(r, -1, spp)
    if predictor == 2:
        x = np.cumsum(x, axis=1, dtype=x.dtype)
    return x.reshape(r, -1)


def predictor_apply(samples: np.ndarray, spp: int) -> np.ndarray:
    """Horizontal differencing of (R, samples) uint8 or uint16 rows."""
    samples = np.asarray(samples)
    r = samples.shape[0]
    px = samples.reshape(r, -1, spp)
    out = px.copy()
    out[:, 1:] = px[:, 1:] - px[:, :-1]
    return out.reshape(samples.shape)
