"""Plain Python / NumPy versions of the native TIFF codec (``tiff.cpp``).

The tests hold the native library to these: the same LZW code stream
byte for byte, the same PackBits output, the same predictor arithmetic
and the same CCITT rows.  Nothing in the package
calls them; the LZW here is pure Python and far too slow for a capture.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

__all__ = ["lzw_decode", "lzw_encode", "packbits_decode", "predictor_undo",
           "predictor_apply", "ccitt_decode", "WHITE_CODES", "BLACK_CODES",
           "EOL"]

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


# --- CCITT (T.4 / T.6) -----------------------------------------------------

def _codes(terminating: str, makeup: str) -> Dict[int, str]:
    """run length -> code bits, from the terminating codes of runs 0-63
    and the make-up codes of 64, 128, ... 1728, then T.4's extended
    make-up codes of 1792-2560 that both colours share."""
    table = {run: code for run, code in enumerate(terminating.split())}
    table.update({64 * (k + 1): code for k, code in enumerate(makeup.split())})
    table.update({1792 + 64 * k: code for k, code in enumerate(
        "00000001000 00000001100 00000001101 000000010010 000000010011 "
        "000000010100 000000010101 000000010110 000000010111 000000011100 "
        "000000011101 000000011110 000000011111".split())})
    return table


# T.4 tables 2 and 3: run length -> code, for each colour
WHITE_CODES = _codes(
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 "
    "01000 001000 000011 110100 110101 101010 101011 0100111 0001100 "
    "0001000 0010111 0000011 0000100 0101000 0101011 0010011 0100100 "
    "0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 "
    "00101011 00101100 00101101 00000100 00000101 00001010 00001011 "
    "01010010 01010011 01010100 01010101 00100100 00100101 01011000 "
    "01011001 01011010 01011011 01001010 01001011 00110010 00110011 "
    "00110100",
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 "
    "011010101 011010110 011010111 011011000 011011001 011011010 "
    "011011011 010011000 010011001 010011010 011000 010011011")
BLACK_CODES = _codes(
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 "
    "0000101 0000111 00000100 00000111 000011000 0000010111 0000011000 "
    "0000001000 00001100111 00001101000 00001101100 00000110111 "
    "00000101000 00000010111 00000011000 000011001010 000011001011 "
    "000011001100 000011001101 000001101000 000001101001 000001101010 "
    "000001101011 000011010010 000011010011 000011010100 000011010101 "
    "000011010110 000011010111 000001101100 000001101101 000011011010 "
    "000011011011 000001010100 000001010101 000001010110 000001010111 "
    "000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 "
    "000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111",
    "0000001111 000011001000 000011001001 000001011011 000000110011 "
    "000000110100 000000110101 0000001101100 0000001101101 0000001001010 "
    "0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 "
    "0000001110111 0000001010010 0000001010011 0000001010100 "
    "0000001010101 0000001011010 0000001011011 0000001100100 "
    "0000001100101")
EOL = "000000000001"
# two-dimensional mode codes (T.4 table 4): code -> (mode, a1 - b1)
_MODES = {"0001": ("pass", 0), "001": ("horizontal", 0), "1": ("v", 0),
          "011": ("v", 1), "000011": ("v", 2), "0000011": ("v", 3),
          "010": ("v", -1), "000010": ("v", -2), "0000010": ("v", -3)}
_BY_CODE = [{code: run for run, code in t.items()}
            for t in (WHITE_CODES, BLACK_CODES)]


class CcittError(ValueError):
    """Data libtiff decodes only by concealing an error (or not at all)."""


class _BitStream:
    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8)).tolist()
        self.pos = 0

    def read(self, table, longest: int, what: str):
        code = ""
        for _ in range(longest):
            if self.pos >= len(self.bits):
                raise CcittError("the data end inside a row")
            code += "1" if self.bits[self.pos] else "0"
            self.pos += 1
            if code in table:
                return table[code]
        raise CcittError(f"a bad {what} code")

    def eol(self) -> None:
        """Fill bits (zeros), then an EOL: 11 or more zeros and a one."""
        zeros = 0
        while self.pos < len(self.bits) and not self.bits[self.pos]:
            zeros += 1
            self.pos += 1
        if self.pos >= len(self.bits) or zeros < 11:
            raise CcittError("a row without its EOL")
        self.pos += 1

    def align(self) -> None:
        self.pos = -(-self.pos // 8) * 8


def _run(bs: _BitStream, colour: int) -> int:
    """One run of ``colour`` (0 white, 1 black): make-up codes, then a
    terminating one."""
    total = 0
    while True:
        run = bs.read(_BY_CODE[colour], 13, "white" if colour == 0 else
                      "black")
        total += run
        if run < 64:
            return total


def _changes_1d(bs: _BitStream, width: int) -> List[int]:
    """A one-dimensional row: the positions where the colour changes."""
    changes, a0, colour = [], 0, 0
    while a0 < width:
        a0 += _run(bs, colour)
        if a0 > width:
            raise CcittError("a row longer than the image")
        changes.append(a0)
        colour ^= 1
    return _tidy(changes, width)


def _tidy(changes: List[int], width: int) -> List[int]:
    """Drop changes at or past the row's end, then cancel equal
    neighbours (a zero-length run changes nothing)."""
    while changes and changes[-1] >= width:
        changes.pop()
    out: List[int] = []
    for c in changes:
        if out and out[-1] == c:
            out.pop()
        else:
            out.append(c)
    return out


def _changes_2d(bs: _BitStream, ref: List[int], width: int) -> List[int]:
    """A two-dimensional row coded against the row above (``ref``'s
    changing elements; T.4 section 4.2)."""
    changes: List[int] = []
    a0, colour = -1, 0
    ref = ref + [width, width]
    while a0 < width:
        # b1: the first change on the reference row right of a0 to the
        # opposite of a0's colour (changes to black sit at even indices)
        i = 0
        while ref[i] <= a0 or (i & 1) != colour:
            if ref[i] >= width:
                break
            i += 1
        b1 = min(ref[i], width)
        b2 = min(ref[i + 1] if i + 1 < len(ref) else width, width)
        mode, k = bs.read(_MODES, 7, "mode")
        if mode == "pass":
            if b2 > width:
                raise CcittError("a pass mode past the row")
            a0 = b2
            continue
        if mode == "horizontal":
            start = max(a0, 0)
            a1 = start + _run(bs, colour)
            a2 = a1 + _run(bs, colour ^ 1)
            if a2 > width:
                raise CcittError("a row longer than the image")
            changes += [a1, a2]
            a0 = a2
            continue
        a1 = b1 + k
        if a1 < 0 or a1 > width or a1 <= a0 and a0 >= 0:
            raise CcittError("a vertical mode outside the row")
        changes.append(a1)
        a0, colour = a1, colour ^ 1
    return _tidy(changes, width)


def _fill(changes: List[int], width: int) -> np.ndarray:
    row = np.zeros(width, np.uint8)
    for a, b in zip(changes[0::2], changes[1::2] + [width]):
        row[a:b] = 1
    return np.packbits(row)


def ccitt_decode(data: bytes, width: int, rows: int, compression: int,
                 t4_options: int = 0) -> bytes:
    """Decode one CCITT chunk of ``rows`` rows ``width`` pixels wide into
    packed rows (MSB first, each padded to a byte), 1 for black, as
    libtiff's decoder fills them: compression 2 (Modified Huffman, each
    row from a byte boundary), 3 (T.4: an EOL before each row, after fill
    bits, and with ``t4_options`` bit 0 a tag bit after it, 1 for a
    one-dimensional row, 0 for a two-dimensional one) or 4 (T.6: every row
    two-dimensional, no EOLs).  The first row's reference is all white.
    Data libtiff meets with an error it conceals (a bad code, a row of the
    wrong length, a missing EOL, data that end early) raise CcittError."""
    bs = _BitStream(bytes(data))
    ref: List[int] = []
    out = []
    for _ in range(rows):
        if compression == 2:
            changes = _changes_1d(bs, width)
            bs.align()
        elif compression == 3:
            bs.eol()
            one_d = True
            if t4_options & 1:
                one_d = bs.read({"1": True, "0": False}, 1, "tag")
            changes = _changes_1d(bs, width) if one_d else \
                _changes_2d(bs, ref, width)
        else:
            changes = _changes_2d(bs, ref, width)
        out.append(_fill(changes, width))
        ref = changes
    return b"".join(r.tobytes() for r in out)
