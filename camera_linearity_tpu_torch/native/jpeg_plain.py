"""Plain Python / NumPy version of the native JPEG decoder (``jpeg.cpp``).

The tests and ``chip_smoke.py`` hold the native library to it bit for bit:
the same marker walk and byte source (libjpeg's fake EOI bytes past the
end), the same Huffman decode (in Python, one symbol at a time, with the
same zero bits past the data and restart handling), and the same integer
IDCTs, upsampling and colour tables (vectorised NumPy), in each of the
three modes (``MODES``): ``"turbo"`` and ``"turbo_fast"`` give
libjpeg-turbo's bytes, ``"ffmpeg"`` what ``cv2.VideoCapture`` gives for an
MJPG frame (FFmpeg's MJPEG decoder, then swscale to BGR24).  Nothing in the
package calls it; a 4K frame takes it about a minute.

The ``"ffmpeg"`` mode, stage by stage, as FFmpeg 8 (libavcodec 62,
libswscale 9) runs on x86-64:

* entropy decode as libjpeg's, but the DC predictor runs on dequantized
  values (it starts at 1024, the level shift, and each block's DC is the
  running sum clipped to int16), and a restart marker is any RSTn;
* the ``simple_idct`` of its SSE2/AVX routine (``ff_simple_idct8_*``):
  W1-W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520, a row pass first
  (a row with no AC term is ``DC << 3`` in 16 bits, else ``(sum + 2^10)
  >> 11`` saturated to int16), then the column pass (the DC rounding 32
  added in 16 bits, ``sum >> 20`` in 32 bits), clamped to 0..255;
* the planes as ``yuvj420p``/``yuvj422p``/``yuvj444p``; cv2 asks swscale
  for BGR24 at the same size.  4:2:0 and 4:2:2 of even height take its
  unscaled SSSE3 converter: chroma replicated, ``pmulhw`` with the
  full-range BT.601 coefficients (``y + ((c * 8 - 1024) * k >> 16)``,
  k = 14516, -2819, -5850, 11485).  4:4:4 takes the scaler's full-chroma
  output: ``(y << 22 + 2^21 + (c - 128 << 9) * k) >> 22``, which rounds.
  4:4:4 with component IDs 'R', 'G', 'B' or Adobe transform 0 is planar
  RGB.  An odd height in 4:2:0 or 4:2:2 takes swscale's bicubic scaler,
  which this mode does not reproduce: UNSUPPORTED;
* data FFmpeg would meet with an error it conceals (a bad Huffman code, a
  run past the 64th coefficient, bits past the end of the data, a restart
  interval that does not end at its marker): UNMATCHED, not a guess.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["decode", "decode_bgr", "STANDARD_TABLES", "MODES", "OK",
           "CORRUPT", "GEOMETRY", "COMPONENTS", "UNSUPPORTED", "UNMATCHED",
           "NO_FRAME"]

# clt_jpeg_decode_bgr's return codes; NO_FRAME (the "ffmpeg" mode only):
# the data ends before the first scan, where FFmpeg returns no frame
OK, CORRUPT, GEOMETRY, COMPONENTS, UNSUPPORTED, UNMATCHED, NO_FRAME = \
    0, -1, -2, -3, -4, -5, -6
_REASONS = {CORRUPT: "corrupt JPEG data", GEOMETRY: "frame geometry",
            COMPONENTS: "not a 3-component image",
            UNSUPPORTED: "a mode the decoder does not read",
            UNMATCHED: "data FFmpeg decodes with an error it conceals",
            NO_FRAME: "the data ends before the first scan"}

# the decoder's modes, by their number in jpeg.cpp
MODES = ("turbo", "turbo_fast", "ffmpeg")

# COM segments that change how FFmpeg's MJPEG decoder reads a frame
# (limited range, flipped or interlaced frames)
_FFMPEG_COMMENTS = (b"CS=ITU601", b"Intel(R) JPEG", b"Metasoft MJPEG",
                    b"MULTISCOPE II", b"AVID")


def mode_name(mode) -> str:
    """A mode's name from its name or the old ``fast`` flag (False:
    ``"turbo"``, True: ``"turbo_fast"``)."""
    if isinstance(mode, (bool, np.bool_)):
        return MODES[int(mode)]
    if mode not in MODES:
        raise ValueError(f"unknown JPEG decoder mode {mode!r}; expected one "
                         f"of {MODES}")
    return mode

_EOI = 0xD9
_LOOK = 9

# zigzag index -> natural index, with libjpeg's 16 guard entries
_NATURAL = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
            12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
            35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
            58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63
            ] + [63] * 16

_AAN_SCALES = np.array([
    16384, 22725, 21407, 19266, 16384, 12873, 8867, 4520,
    22725, 31521, 29692, 26722, 22725, 17855, 12299, 6270,
    21407, 29692, 27969, 25172, 21407, 16819, 11585, 5906,
    19266, 26722, 25172, 22654, 19266, 15137, 10426, 5315,
    16384, 22725, 21407, 19266, 16384, 12873, 8867, 4520,
    12873, 17855, 16819, 15137, 12873, 10114, 6967, 3552,
    8867, 12299, 11585, 10426, 8867, 6967, 4799, 2446,
    4520, 6270, 5906, 5315, 4520, 3552, 2446, 1247], np.int64)

# Annex K.3's tables: (counts of lengths 1..16, symbols), by (class, slot)
# with class 0 DC and 1 AC
_AC_LUM = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROM = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
STANDARD_TABLES = {
    (0, 0): ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
             bytes(range(12))),
    (1, 0): ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), _AC_LUM),
    (0, 1): ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
             bytes(range(12))),
    (1, 1): ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
             _AC_CHROM),
}


class _Source:
    """Bytes as libjpeg's memory source gives them: FF D9 FF D9 ... past
    the end."""

    def __init__(self, data: bytes):
        self.data = data
        self.n = len(data)
        self.pos = 0
        self.sos = False  # the walk has met the first SOS marker
        # the data and enough fake EOI bytes for a segment search
        self.ext = data + b"\xff\xd9" * 4

    def at(self, i: int) -> int:
        if i < self.n:
            return self.data[i]
        return _EOI if (i - self.n) & 1 else 0xFF

    def next_marker(self) -> int:
        while True:
            c = self.at(self.pos)
            self.pos += 1
            while c != 0xFF:
                c = self.at(self.pos)
                self.pos += 1
            while c == 0xFF:
                c = self.at(self.pos)
                self.pos += 1
            if c:
                return c


# the end of entropy-coded data: 0xFF (fill 0xFFs too) before a byte that
# is neither a stuffed zero nor 0xFF
_SEGMENT_END = re.compile(rb"\xff+[^\x00\xff]")
_STUFFED = re.compile(rb"\xff+\x00")


class _Huff:
    """A derived table: ``look[9 bits] = (length << 8) | symbol`` for codes
    up to 9 bits, 0 for longer ones, which walk ``maxcode``."""

    def __init__(self, bits, val, dc: bool):
        sizes = []
        for length in range(1, 17):
            sizes += [length] * bits[length - 1]
        if len(sizes) > 256:
            raise _Fault(CORRUPT)
        codes, code = [], 0
        si = sizes[0] if sizes else 0
        p = 0
        while p < len(sizes):
            while p < len(sizes) and sizes[p] == si:
                codes.append(code)
                code += 1
                p += 1
            if code >= 1 << si:
                raise _Fault(CORRUPT)
            code <<= 1
            si += 1
        self.maxcode = [0] * 18
        self.valoff = [0] * 18
        p = 0
        for length in range(1, 17):
            if bits[length - 1]:
                self.valoff[length] = p - codes[p]
                p += bits[length - 1]
                self.maxcode[length] = codes[p - 1]
            else:
                self.maxcode[length] = -1
        self.maxcode[17] = 0xFFFFF
        self.val = list(val) + [0] * (256 - len(val))
        self.look = [0] * (1 << _LOOK)
        p = 0
        for length in range(1, _LOOK + 1):
            for _ in range(bits[length - 1]):
                at = codes[p] << (_LOOK - length)
                for k in range(1 << (_LOOK - length)):
                    self.look[at + k] = (length << 8) | self.val[p]
                p += 1
        if dc and any(v > 15 for v in val[:len(sizes)]):
            raise _Fault(CORRUPT)


class _Fault(Exception):
    def __init__(self, code: int):
        super().__init__(code)
        self.code = code


class _Header:
    def __init__(self):
        self.sof = self.precision = self.height = self.width = 0
        self.comps: List[dict] = []
        self.qt = [None] * 4
        self.huff = {}            # (class, slot) -> (bits, val)
        self.restart = 0
        self.jfif = self.adobe = False
        self.transform = 0
        self.comments: List[bytes] = []  # the first 14 bytes of each COM
        self.scan: List[int] = []  # frame index of each scan slot


def _read_header(src: _Source) -> _Header:
    """Markers from SOI to the first SOS (``jpeg.cpp``'s read_header)."""
    if src.at(0) != 0xFF or src.at(1) != 0xD8:
        raise _Fault(CORRUPT)
    src.pos = 2
    hd = _Header()
    saw_sof = False
    while True:
        m = src.next_marker()
        if m in (_EOI, 0xD8):
            raise _Fault(CORRUPT)
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        length = (src.at(src.pos) << 8) | src.at(src.pos + 1)
        body = length - 2
        skipped = 0xE0 <= m <= 0xEF or m == 0xFE
        keep = min(body, 14) if skipped else body
        seg = bytes(src.at(src.pos + 2 + i) for i in range(max(keep, 0)))
        src.pos += length if length >= 2 else 2
        if m in (0xC0, 0xC1):
            if saw_sof or body < 6:
                raise _Fault(CORRUPT)
            saw_sof = True
            hd.sof, hd.precision = m, seg[0]
            hd.height = (seg[1] << 8) | seg[2]
            hd.width = (seg[3] << 8) | seg[4]
            ncomp = seg[5]
            if hd.height <= 0 or hd.width <= 0 or ncomp <= 0 or \
                    body != 6 + 3 * ncomp:
                raise _Fault(CORRUPT)
            if hd.precision != 8:
                raise _Fault(UNSUPPORTED)
            if ncomp != 3:
                raise _Fault(COMPONENTS)
            hd.comps = [dict(id=seg[6 + 3 * c], h=seg[7 + 3 * c] >> 4,
                             v=seg[7 + 3 * c] & 15, tq=seg[8 + 3 * c])
                        for c in range(3)]
        elif 0xC0 <= m <= 0xCF and m not in (0xC4, 0xCC):
            raise _Fault(UNSUPPORTED)
        elif m == 0xC4:
            at = 0
            while body - at > 16:
                index = seg[at]
                bits = tuple(seg[at + 1:at + 17])
                count = sum(bits)
                at += 17
                if count > 256 or count > body - at:
                    raise _Fault(CORRUPT)
                if index & ~0x10 > 3:
                    raise _Fault(CORRUPT)
                hd.huff[(1 if index & 0x10 else 0, index & 0x0F)] = (
                    bits, seg[at:at + count])
                at += count
            if at != body:
                raise _Fault(CORRUPT)
        elif m == 0xDB:
            at = 0
            while at < body:
                prec, slot = seg[at] >> 4, seg[at] & 15
                at += 1
                size = 128 if prec else 64
                if slot > 3 or at + size > body:
                    raise _Fault(CORRUPT)
                raw = np.frombuffer(seg[at:at + size],
                                    ">u2" if prec else np.uint8)
                table = np.empty(64, np.int64)
                table[_NATURAL[:64]] = raw
                hd.qt[slot] = table
                at += size
            if at != body:
                raise _Fault(CORRUPT)
        elif m == 0xDD:
            if body != 2:
                raise _Fault(CORRUPT)
            hd.restart = (seg[0] << 8) | seg[1]
        elif m == 0xE0:
            if body >= 14 and seg[:5] == b"JFIF\0":
                hd.jfif = True
        elif m == 0xEE:
            if body >= 12 and seg[:5] == b"Adobe":
                hd.adobe, hd.transform = True, seg[11]
        elif m == 0xDA:
            src.sos = True
            if not saw_sof:
                raise _Fault(CORRUPT)
            n = seg[0] if body >= 1 else 0
            if body != 4 + 2 * n or not 1 <= n <= 4:
                raise _Fault(CORRUPT)
            if n != 3:
                raise _Fault(UNSUPPORTED)
            used = set()
            for i in range(n):
                cid, tabs = seg[1 + 2 * i], seg[2 + 2 * i]
                c = next((c for c in range(3) if hd.comps[c]["id"] == cid
                          and c not in used), None)
                if c is None:
                    raise _Fault(CORRUPT)
                used.add(c)
                hd.comps[c]["td"], hd.comps[c]["ta"] = tabs >> 4, tabs & 15
                hd.scan.append(c)
            return hd
        elif skipped or m in (0xCC, 0xDC):
            if m == 0xFE:
                hd.comments.append(seg)
        else:
            raise _Fault(CORRUPT)


class _Bits:
    """The entropy-coded bits of one segment (up to its marker), then zero
    bits; ``short`` turns true once a bit past the data is taken."""

    def __init__(self, src: _Source, against_marker: Optional[int] = None):
        if against_marker is not None:  # an empty segment at a marker
            data, self.marker = b"", against_marker
        else:
            pos = src.pos
            if pos > src.n + 1:  # past the end only the parity matters
                pos = src.n + ((pos - src.n) & 1)
            m = _SEGMENT_END.search(src.ext, pos)
            data = _STUFFED.sub(b"\xff", src.ext[pos:m.start()])
            self.marker = src.ext[m.end() - 1]
            src.pos = m.end()
        self.real = 8 * len(data)
        # 32-bit big-endian windows at every byte; an MCU reads at most
        # 10 blocks x 64 x 32 bits past the data
        a = np.frombuffer(data + bytes(2600), np.uint8).astype(np.uint32)
        self.win = ((a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8)
                    | a[3:]).tolist()
        self.p = 0


def _symbol(win: list, p: int, tab: _Huff) -> Tuple[int, int]:
    """One Huffman symbol at bit p: (symbol, next bit); a bad code reads
    17 bits and gives 0, as libjpeg does."""
    w = win[p >> 3]
    e = tab.look[(w >> (23 - (p & 7))) & 0x1FF]
    if e:
        return e & 0xFF, p + (e >> 8)
    b17 = (w >> (15 - (p & 7))) & 0x1FFFF
    n = _LOOK + 1
    while (b17 >> (17 - n)) > tab.maxcode[n]:
        n += 1
    if n > 16:
        return 0, p + n
    return tab.val[((b17 >> (17 - n)) + tab.valoff[n]) & 0xFF], p + n


def _take(win: list, p: int, n: int) -> Tuple[int, int]:
    """n <= 16 bits at bit p: (value, next bit)."""
    return (win[p >> 3] >> (32 - (p & 7) - n)) & ((1 << n) - 1), p + n


def _blocks(hd: _Header, src: _Source, mcux: int, mcuy: int, hmax: int,
            vmax: int, tables, dc_quant=None) -> Tuple[List[np.ndarray], int]:
    """The quantized coefficients of every block, per component as
    (blocks down, blocks across, 64) int16 in natural order, and the
    source's marker after the scan (``jpeg.cpp``'s run, without the
    IDCT).

    With ``dc_quant`` (each component's DC quantizer) the scan decodes as
    FFmpeg's does: each DC is the dequantized running sum from 1024
    clipped to int16, a restart is any RSTn right after the interval's
    padding bits (all ones or all zeros), and what FFmpeg would stop at
    with an error raises UNMATCHED."""
    ffmpeg = dc_quant is not None
    coefs = [np.zeros((mcuy * c["v"], mcux * c["h"], 64), np.int16)
             for c in hd.comps]
    bits = _Bits(src)
    short = False
    start = 1024 if ffmpeg else 0
    pred = [start] * 3
    togo, next_rst = hd.restart, 0
    natural = _NATURAL
    for my in range(mcuy):
        for mx in range(mcux):
            if ffmpeg and hd.restart and togo == 0:
                rest = bits.real - bits.p
                if not 0 <= rest < 8 or not 0xD0 <= bits.marker <= 0xD7 or \
                        _take(bits.win, bits.p, rest)[0] not in (
                            0, (1 << rest) - 1):
                    raise _Fault(UNMATCHED)
                pred = [start] * 3
                togo = hd.restart
                bits = _Bits(src)
            elif hd.restart and togo == 0:
                m = bits.marker
                against = None
                if m == 0xD0 + next_rst:
                    pass
                else:  # jpeg_resync_to_restart
                    while True:
                        if m < 0xC0:
                            action = 2
                        elif m < 0xD0 or m > 0xD7:
                            action = 3
                        elif m in (0xD0 + ((next_rst + 1) & 7),
                                   0xD0 + ((next_rst + 2) & 7)):
                            action = 3
                        elif m in (0xD0 + ((next_rst - 1) & 7),
                                   0xD0 + ((next_rst - 2) & 7)):
                            action = 2
                        else:
                            action = 1
                        if action == 2:
                            m = src.next_marker()
                            continue
                        if action == 3:
                            against = m
                        break
                next_rst = (next_rst + 1) & 7
                pred = [0, 0, 0]
                togo = hd.restart
                bits = _Bits(src, against)
                if against is None:
                    short = False
            if not short:
                win, p = bits.win, bits.p
                for k in hd.scan:
                    c = hd.comps[k]
                    dct, act = tables[(0, c["td"])], tables[(1, c["ta"])]
                    for by in range(c["v"]):
                        row = coefs[k][my * c["v"] + by]
                        for bx in range(c["h"]):
                            blk = row[mx * c["h"] + bx]
                            at = p
                            t, p = _symbol(win, p, dct)
                            if ffmpeg and p - at > 16:  # a bad code
                                raise _Fault(UNMATCHED)
                            diff = 0
                            if t:
                                x, p = _take(win, p, t)
                                diff = x - (1 << t) + 1 \
                                    if x < 1 << (t - 1) else x
                            if ffmpeg:
                                pred[k] = (pred[k] + diff * dc_quant[k]
                                           + 2 ** 31) % 2 ** 32 - 2 ** 31
                                blk[0] = min(max(pred[k], -32768), 32767)
                            else:
                                pred[k] = (pred[k] + diff + 2 ** 31) \
                                    % 2 ** 32 - 2 ** 31
                                blk[0] = (pred[k] + 32768) % 65536 - 32768
                            z = 1
                            while z < 64:
                                at = p
                                t, p = _symbol(win, p, act)
                                r, s = t >> 4, t & 15
                                if ffmpeg and (p - at > 16 or (
                                        z + r > 63 if s else r not in (0, 15))):
                                    raise _Fault(UNMATCHED)
                                if s:
                                    z += r
                                    x, p = _take(win, p, s)
                                    blk[natural[z]] = x - (1 << s) + 1 \
                                        if x < 1 << (s - 1) else x
                                elif r != 15:
                                    break
                                else:
                                    z += 15
                                z += 1
                bits.p = p
                if p > bits.real:
                    if ffmpeg:
                        raise _Fault(UNMATCHED)
                    short = True
            if hd.restart:
                togo -= 1
    return coefs, bits.marker


def _i16(x: np.ndarray) -> np.ndarray:
    return (x + 32768) % 65536 - 32768


def _sat16(x: np.ndarray) -> np.ndarray:
    return np.clip(x, -32768, 32767)


def _sample(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, -128, 127) + 128).astype(np.uint8)


def _islow_1d(x, shift, pass1):
    """One pass of jpeg_idct_islow over axis 1 of x (n, 8, 8), in
    jidctint-avx2's 16-bit lanes: returns the eight descaled outputs."""
    F0298, F0390, F0541, F0765, F0899, F1175 = 2446, 3196, 4433, 6270, \
        7373, 9633
    F1501, F1847, F1961, F2053, F2562, F3072 = 12299, 15137, 16069, \
        16819, 20995, 25172
    z2, z3 = x[:, 2], x[:, 6]
    z1 = (z2 + z3) * F0541
    tmp2 = z1 + z3 * -F1847
    tmp3 = z1 + z2 * F0765
    tmp0 = _i16(x[:, 0] + x[:, 4]) * 8192
    tmp1 = _i16(x[:, 0] - x[:, 4]) * 8192
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = x[:, 7], x[:, 5], x[:, 3], x[:, 1]
    z1 = (tmp0 + tmp3) * -F0899
    z2 = (tmp1 + tmp2) * -F2562
    z3 = _i16(tmp0 + tmp2)
    z4 = _i16(tmp1 + tmp3)
    z5 = (z3 + z4) * F1175
    z3 = z3 * -F1961 + z5
    z4 = z4 * -F0390 + z5
    tmp0 = tmp0 * F0298 + z1 + z3
    tmp1 = tmp1 * F2053 + z2 + z4
    tmp2 = tmp2 * F3072 + z2 + z3
    tmp3 = tmp3 * F1501 + z1 + z4
    rnd = 1 << (shift - 1)
    out = [t10 + tmp3, t11 + tmp2, t12 + tmp1, t13 + tmp0,
           t13 - tmp0, t12 - tmp1, t11 - tmp2, t10 - tmp3]
    out = np.stack([(o + rnd) >> shift for o in out], 1)
    return _sat16(out) if pass1 else out


def _idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(n, 64) int16 coefficients -> (n, 8, 8) uint8 samples."""
    c = coef.astype(np.int64).reshape(-1, 8, 8)
    v = _i16(c * q.astype(np.int16).astype(np.int64).reshape(8, 8))
    ac = (c[:, 1:] != 0).any(axis=(1, 2))
    # pass 1 down the columns (axis 1), pass 2 along the rows
    cols = _islow_1d(v, 11, True)                        # (n, row, col)
    dc_only = np.broadcast_to(_i16(v[:, 0:1, :] * 4), cols.shape)
    ws = np.where(ac[:, None, None], cols, dc_only)      # (n, row, col)
    return _sample(_islow_1d(np.swapaxes(ws, 1, 2), 18, False)
                   ).swapaxes(1, 2)


def _aan(x, c):
    return (_i16(x * 4) * (c * 64)) >> 16


def _ifast_1d(x):
    """jpeg_idct_ifast's butterflies over axis 1 of x (n, 8, 8), in
    jidctfst-sse2's 16-bit lanes."""
    F1082, F1414, F1847, F1613 = 277, 362, 473, 669 - 256
    tmp10, tmp11 = _i16(x[:, 0] + x[:, 4]), _i16(x[:, 0] - x[:, 4])
    tmp13 = _i16(x[:, 2] + x[:, 6])
    tmp12 = _i16(_aan(_i16(x[:, 2] - x[:, 6]), F1414) - tmp13)
    tmp0, tmp3 = _i16(tmp10 + tmp13), _i16(tmp10 - tmp13)
    tmp1, tmp2 = _i16(tmp11 + tmp12), _i16(tmp11 - tmp12)
    z13, z10 = _i16(x[:, 5] + x[:, 3]), _i16(x[:, 5] - x[:, 3])
    z11, z12 = _i16(x[:, 1] + x[:, 7]), _i16(x[:, 1] - x[:, 7])
    tmp7 = _i16(z11 + z13)
    tmp11 = _aan(_i16(z11 - z13), F1414)
    z10s, z12s = _i16(z10 * 4), _i16(z12 * 4)
    z5 = (_i16(z10s + z12s) * (F1847 * 64)) >> 16
    tmp10 = _i16(((z12s * (F1082 * 64)) >> 16) - z5)
    tmp12 = _i16(_i16(((z10s * (-F1613 * 64)) >> 16) - z10) + z5)
    tmp6 = _i16(tmp12 - tmp7)
    tmp5 = _i16(tmp11 - tmp6)
    tmp4 = _i16(tmp10 + tmp5)
    return np.stack([_i16(tmp0 + tmp7), _i16(tmp1 + tmp6),
                     _i16(tmp2 + tmp5), _i16(tmp3 - tmp4),
                     _i16(tmp3 + tmp4), _i16(tmp2 - tmp5),
                     _i16(tmp1 - tmp6), _i16(tmp0 - tmp7)], 1)


def _idct_ifast(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    c = coef.astype(np.int64).reshape(-1, 8, 8)
    v = _i16(c * q.astype(np.int16).astype(np.int64).reshape(8, 8))
    ws = _ifast_1d(v)                                     # (n, row, col)
    return _sample(_ifast_1d(np.swapaxes(ws, 1, 2)) >> 5).swapaxes(1, 2)


# FFmpeg's simple_idct (8-bit): W_k = round(cos(k pi / 16) sqrt(2) 2^14),
# W4 one less
_W = (None, 22725, 21407, 19266, 16383, 12873, 8867, 4520)


def _i32(x: np.ndarray) -> np.ndarray:
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def _simple_1d(x, a0):
    """simple_idct's butterflies along the last axis of x, with the DC
    term ``a0`` given: the eight sums before the shift."""
    W1, W2, W3, W4, W5, W6, W7 = _W[1:]
    a1, a2, a3 = a0 + W6 * x[..., 2], a0 - W6 * x[..., 2], \
        a0 - W2 * x[..., 2]
    a0 = a0 + W2 * x[..., 2]
    b0 = W1 * x[..., 1] + W3 * x[..., 3] + W5 * x[..., 5] + W7 * x[..., 7]
    b1 = W3 * x[..., 1] - W7 * x[..., 3] - W1 * x[..., 5] - W5 * x[..., 7]
    b2 = W5 * x[..., 1] - W1 * x[..., 3] + W7 * x[..., 5] + W3 * x[..., 7]
    b3 = W7 * x[..., 1] - W5 * x[..., 3] + W3 * x[..., 5] - W1 * x[..., 7]
    a0 = a0 + W4 * x[..., 4] + W6 * x[..., 6]
    a1 = a1 - W4 * x[..., 4] - W2 * x[..., 6]
    a2 = a2 - W4 * x[..., 4] + W2 * x[..., 6]
    a3 = a3 + W4 * x[..., 4] - W6 * x[..., 6]
    return np.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3,
                     a3 - b3, a2 - b2, a1 - b1, a0 - b0], -1)


def _idct_simple(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(n, 64) int16 coefficients, the DC already dequantized -> (n, 8, 8)
    uint8 samples, as ff_simple_idct8_put_sse2/avx computes them."""
    c = coef.astype(np.int64).reshape(-1, 8, 8)
    v = _i16(c * q.astype(np.int64).reshape(8, 8))
    v[:, 0, 0] = c[:, 0, 0]
    W4 = _W[4]
    # rows: a row with no AC term is DC << 3 in 16 bits
    rows = _sat16(_i32(_simple_1d(v, W4 * v[..., 0] + (1 << 10))) >> 11)
    dc_only = ~(v[..., 1:] != 0).any(-1)
    rows = np.where(dc_only[..., None], _i16(v[..., :1] * 8), rows)
    # columns: the rounding (1 << 19) / W4 = 32 added to the DC in 16 bits
    cols = np.swapaxes(rows, 1, 2)
    out = _i32(_simple_1d(cols, W4 * _i16(cols[..., 0] + 32))) >> 20
    return np.clip(np.swapaxes(out, 1, 2), 0, 255).astype(np.uint8)


# swscale's full-range BT.601 coefficients (ff_yuv2rgb_c_init_tables, 13
# fractional bits): u -> b, u -> g, v -> g, v -> r
_UB, _UG, _VG, _VR = 14516, -2819, -5850, 11485


def _ffmpeg_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                subsampled: bool) -> np.ndarray:
    """BGR24 from full-size planes as swscale converts them: the unscaled
    SSSE3 path (pmulhw, truncating) for subsampled chroma, the full-chroma
    scaler (rounding) for 4:4:4."""
    y, cb, cr = (a.astype(np.int64) for a in (y, cb, cr))
    if subsampled:
        u, v = cb * 8 - 1024, cr * 8 - 1024
        bgr = (y + ((u * _UB) >> 16),
               y + ((u * _UG) >> 16) + ((v * _VG) >> 16),
               y + ((v * _VR) >> 16))
    else:
        yy = (y << 22) + (1 << 21)
        u, v = (cb - 128) << 9, (cr - 128) << 9
        bgr = ((yy + u * _UB) >> 22, (yy + u * _UG + v * _VG) >> 22,
               (yy + v * _VR) >> 22)
    return np.stack(bgr, -1).clip(0, 255).astype(np.uint8)


# jdcolor.c's tables (SCALEBITS 16)
def _fix(x: float) -> int:
    return int(x * 65536.0 + 0.5)


_X = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _X + (1 << 15)) >> 16
_CB_B = (_fix(1.77200) * _X + (1 << 15)) >> 16
_CR_G = -_fix(0.71414) * _X
_CB_G = -_fix(0.34414) * _X + (1 << 15)


def _upsample(plane: np.ndarray, dh: int, dw: int, hx: int, vx: int,
              fancy: bool, height: int, width: int) -> np.ndarray:
    """A component's samples at full size (jdsample.c): fancy (triangle)
    h2v1/h2v2 where asked and the component is over 2 samples wide, else
    replicated."""
    c = plane[:dh, :dw].astype(np.int64)
    if hx == 1 and vx == 1:
        return c[:height, :width]
    if not fancy or dw <= 2:
        return np.repeat(np.repeat(c, vx, 0), hx, 1)[:height, :width]
    if vx == 2:
        y = np.arange(height)
        r = y >> 1
        nr = np.clip(np.where(y & 1, r + 1, r - 1), 0, dh - 1)
        cs = 3 * c[r] + c[nr]
        here, rnd, sh = 3 * cs, (8, 7), 4
    else:
        cs = c[:height]
        here, rnd, sh = 3 * cs, (1, 2), 2
    left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
    right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
    out = np.empty((cs.shape[0], 2 * dw), np.int64)
    out[:, 0::2] = (here + left + rnd[0]) >> sh
    out[:, 1::2] = (here + right + rnd[1]) >> sh
    return out[:, :width]


def decode_bgr(data: bytes, height: int, width: int, mode="ffmpeg"
               ) -> Tuple[int, Optional[np.ndarray]]:
    """``clt_jpeg_decode_bgr`` in plain Python: ``(return code, frame)``,
    the frame (H, W, 3) BGR uint8 wherever the native decoder writes one
    (a fault after the scan still leaves it), else None.  ``mode``: one of
    ``MODES``, or a bool as the old ``fast`` argument (False ``"turbo"``,
    True ``"turbo_fast"``)."""
    mode = mode_name(mode)
    src = _Source(bytes(data))
    try:
        hd = _read_header(src)
    except _Fault as fault:
        if mode == "ffmpeg" and not src.sos and src.pos >= src.n:
            return NO_FRAME, None
        return fault.code, None
    try:
        frame, code = _decode(hd, src, mode, height, width)
    except _Fault as fault:
        return fault.code, None
    return code, frame


def _decode(hd: _Header, src: _Source, mode: str, height: int,
            width: int):
    fast = mode == "turbo_fast"
    comps = hd.comps
    for c in comps:
        if not (1 <= c["h"] <= 4 and 1 <= c["v"] <= 4):
            raise _Fault(CORRUPT)
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    if sum(c["h"] * c["v"] for c in comps) > 10:
        raise _Fault(CORRUPT)
    c0, c1, c2 = comps
    if (c0["h"], c0["v"]) != (hmax, vmax) or \
            (c1["h"], c1["v"]) != (c2["h"], c2["v"]) or \
            hmax % c1["h"] or vmax % c1["v"] or \
            (hmax // c1["h"], vmax // c1["v"]) not in ((1, 1), (2, 1), (2, 2)):
        raise _Fault(UNSUPPORTED)
    ids = bytes(c["id"] for c in comps)
    if mode == "ffmpeg":
        # the sampling FFmpeg reads as yuvj420p/422p/444p (and as
        # planar RGB: 4:4:4 with IDs 'R', 'G', 'B' or Adobe transform 0)
        if (c1["h"], c1["v"]) != (1, 1) or ids == b"QFA":
            raise _Fault(UNSUPPORTED)
        subsampled = hmax > 1
        if subsampled and hd.height % 2:
            raise _Fault(UNSUPPORTED)
        if any(c.startswith(_FFMPEG_COMMENTS) for c in hd.comments):
            raise _Fault(UNMATCHED)
        rgb = not subsampled and (hd.adobe and hd.transform == 0
                                  or ids == b"RGB")
    elif hd.jfif:
        rgb = False
    elif hd.adobe:
        rgb = hd.transform == 0
    else:
        rgb = ids == b"RGB"
    quant = []
    for c in comps:
        if c["tq"] > 3 or hd.qt[c["tq"]] is None:
            raise _Fault(CORRUPT)
        q = hd.qt[c["tq"]]
        quant.append((q * _AAN_SCALES + (1 << 11)) >> 12 if fast else q)
    huff = dict(STANDARD_TABLES)
    huff.update(hd.huff)
    tables = {}
    for c in comps:
        for cls, slot in ((0, c["td"]), (1, c["ta"])):
            if slot > 3 or ((cls, slot) not in huff):
                raise _Fault(CORRUPT)
            tables[(cls, slot)] = _Huff(*huff[(cls, slot)], dc=cls == 0)
    if (hd.height, hd.width) != (height, width):
        raise _Fault(GEOMETRY)
    mcux = -(-hd.width // (8 * hmax))
    mcuy = -(-hd.height // (8 * vmax))
    if mode == "ffmpeg":
        coefs, marker = _blocks(hd, src, mcux, mcuy, hmax, vmax, tables,
                                dc_quant=[int(q[0]) for q in quant])
        code = _trailer(src, marker)
        if code != OK:
            raise _Fault(code)
        full = []
        for c, coef, q in zip(comps, coefs, quant):
            nby, nbx = coef.shape[:2]
            plane = _idct_simple(coef.reshape(-1, 64), q)
            plane = plane.reshape(nby, nbx, 8, 8).transpose(0, 2, 1, 3)
            plane = plane.reshape(nby * 8, nbx * 8)
            hx, vx = hmax // c["h"], vmax // c["v"]
            full.append(np.repeat(np.repeat(plane, vx, 0), hx, 1)[
                :height, :width])
        if rgb:
            return np.stack(full[::-1], -1), OK
        return _ffmpeg_bgr(*full, subsampled=hmax > 1), OK
    coefs, marker = _blocks(hd, src, mcux, mcuy, hmax, vmax, tables)
    idct = _idct_ifast if fast else _idct_islow
    full = []
    for c, coef, q in zip(comps, coefs, quant):
        nby, nbx = coef.shape[:2]
        plane = idct(coef.reshape(-1, 64), q).reshape(nby, nbx, 8, 8)
        plane = plane.transpose(0, 2, 1, 3).reshape(nby * 8, nbx * 8)
        dh = -(-hd.height * c["v"] // vmax)
        dw = -(-hd.width * c["h"] // hmax)
        full.append(_upsample(plane, dh, dw, hmax // c["h"], vmax // c["v"],
                              not fast, height, width))
    if rgb:
        frame = np.stack([full[2], full[1], full[0]], -1).astype(np.uint8)
    else:
        y, cb, cr = full
        frame = np.stack([y + _CB_B[cb],
                          y + ((_CB_G[cb] + _CR_G[cr]) >> 16),
                          y + _CR_R[cr]], -1).clip(0, 255).astype(np.uint8)
    return frame, _trailer(src, marker)


def _trailer(src: _Source, m: int) -> int:
    """The markers after the scan, up to EOI (``jpeg.cpp``'s trailer)."""
    while True:
        if m == _EOI:
            return OK
        if m == 0xDA:
            return UNSUPPORTED
        if m == 0xD8 or (0xC0 <= m <= 0xCF and m not in (0xC4, 0xCC)):
            return CORRUPT
        if not (0xD0 <= m <= 0xD7 or m == 0x01):
            if not (m in (0xC4, 0xCC, 0xDB, 0xDC, 0xDD, 0xFE)
                    or 0xE0 <= m <= 0xEF):
                return CORRUPT
            length = (src.at(src.pos) << 8) | src.at(src.pos + 1)
            src.pos += max(length, 2)
        m = src.next_marker()


def decode(data: bytes, mode=False) -> np.ndarray:
    """One JPEG's (H, W, 3) BGR uint8 frame in ``mode`` (as
    :func:`decode_bgr` takes it; the default is ``"turbo"``); a ValueError
    where the native decoder returns a fault."""
    mode = mode_name(mode)
    src = _Source(bytes(data))
    try:
        hd = _read_header(src)
        frame, code = _decode(hd, src, mode, hd.height, hd.width)
    except _Fault as fault:
        code, frame = fault.code, None
    if code != OK:
        raise ValueError(f"jpeg_plain.decode: {_REASONS[code]}")
    return frame
